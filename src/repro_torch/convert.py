"""Parameter exchange between ``repro`` and the port.

The port keeps ``repro``'s parameter layout (tree structure, key names,
HWIO conv weights, ``[in, out]`` dense weights, a transformer's layers
stacked on a leading [L] axis), so converting is a leafwise copy: the
tests pass a numpy tree in ``repro``'s layout through
:func:`params_from_jax` and run both packages on the same weights.
This module takes numpy arrays (``np.asarray`` of a JAX array) and never
imports JAX.  bfloat16 arrays come out of JAX as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` cannot read: they go through float32, which
holds every bfloat16 exactly, and are cast back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree_of_numpy, device=None):
    """A tree of numpy arrays (``repro``'s ResNet, softmax or transformer
    parameters) -> the same tree of tensors on ``device`` (default
    cuda), dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: _tensor(a, dev), tree_of_numpy)


def params_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
