"""Parameter exchange between ``repro`` and the port.

The port keeps ``repro``'s parameter layout (tree structure, key names,
HWIO conv weights, ``[in, out]`` dense weights), so converting is a
leafwise copy: the tests pass a numpy tree in ``repro``'s layout
through :func:`params_from_jax` and run both packages on the same
weights.  This module takes numpy arrays (``np.asarray`` of a
JAX array) and never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def params_from_jax(tree_of_numpy, device=None):
    """A tree of numpy arrays (``repro``'s ResNet or softmax parameters)
    -> the same tree of tensors on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev),
        tree_of_numpy)


def params_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
