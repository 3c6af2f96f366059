"""Dense checkpoints: a flat ``arrays.npz`` plus a ``manifest.json`` of
the tree's key paths (a port of ``repro.train.checkpoint``'s ``save``,
``restore`` and ``load_policy``).

The format is ``repro``'s, byte for byte in meaning, so a checkpoint
written by either package loads in the other: leaves are named ``a<i>``
in flatten order (dict keys sorted, as ``jax.tree_util`` walks them),
each manifest entry holds the leaf's '/'-joined path and dtype name, and
numpy's missing types travel as views (bfloat16 as uint16, the float8
types as uint8).  The compact serving format (``compact-v1``) is ROADMAP
queue 1 item 14.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_flatten_with_path, \
    tree_unflatten

#: dtype name -> (torch dtype, the integer type of its width, the numpy
#: type it is stored as)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, "uint16"),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, "uint8"),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, "uint8"),
}
_BY_TORCH = {tdt: name for name, (tdt, _, _) in _EXOTIC.items()}


def _to_numpy(t: torch.Tensor) -> tuple:
    """(numpy array to store, dtype name) of a tensor leaf."""
    t = t.detach().cpu().contiguous()
    name = _BY_TORCH.get(t.dtype)
    if name is None:
        arr = t.numpy()
        return arr, str(arr.dtype)
    _, width, store = _EXOTIC[name]
    return t.view(width).numpy().view(store), name


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _EXOTIC:
        tdt, width, _ = _EXOTIC[name]
        raw = np.ascontiguousarray(arr).view(
            np.int16 if width == torch.int16 else np.uint8)
        return torch.from_numpy(raw).view(tdt)
    return torch.from_numpy(np.array(arr, copy=True))


def save(path: str, tree: Any, step: Optional[int] = None,
         policy: Optional[dict] = None) -> None:
    """Write ``tree`` (tensors, on any device) to ``path``.  ``policy``:
    the run's serialized compression spec (``core.policy`` ``to_dict()``
    form), kept in the manifest so a resume reproduces the per-leaf
    operators; :func:`load_policy` reads it back."""
    os.makedirs(path, exist_ok=True)
    items, _ = tree_flatten_with_path(tree)
    arrays = {}
    manifest = {"keys": [], "step": step}
    if policy is not None:
        manifest["policy"] = policy
    for i, (key, leaf) in enumerate(items):
        name = f"a{i}"
        arrays[name], dtype = _to_numpy(leaf)
        manifest["keys"].append({"name": name,
                                 "path": "/".join(str(k) for k in key),
                                 "dtype": dtype})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def restore(path: str, like: Any) -> Any:
    """The checkpoint at ``path`` in the structure of ``like`` (e.g.
    freshly initialized parameters), each leaf cast to its ``like``
    leaf's dtype and put on its device."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like, spec = tree_flatten(like)
    if len(manifest["keys"]) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(manifest['keys'])} leaves, target "
            f"structure has {len(leaves_like)}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for e, ref in zip(manifest["keys"], leaves_like):
            t = _from_numpy(data[e["name"]], e["dtype"])
            out.append(t.to(device=ref.device, dtype=ref.dtype))
    return tree_unflatten(spec, out)


def load_policy(path: str):
    """The compression spec the checkpoint was trained with (a
    ``core.policy`` spec object), or None."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    d = manifest.get("policy")
    if d is None:
        return None
    from repro_torch.core import policy as pol
    return pol.from_dict(d)
