"""Checkpoints: a flat ``arrays.npz`` plus a ``manifest.json`` of the
tree's key paths (a port of ``repro.train.checkpoint``'s dense ``save``
/ ``restore`` / ``load_policy``, the compact serving format
``compact-v1`` and the ``latest_step`` / ``latest_full`` helpers).

The formats are ``repro``'s, byte for byte in meaning, so a checkpoint
written by either package loads in the other: leaves are named ``a<i>``
in flatten order (dict keys sorted, as ``jax.tree_util`` walks them),
each manifest entry holds the leaf's '/'-joined path and dtype name, and
numpy's missing types travel as views (bfloat16 as uint16, the float8
types as uint8).  A compact checkpoint (``save_compact``) keeps each
compressed serving leaf's ``(idx, val)`` / ``(levels, scale)`` buffers
as ``a<i>_a`` / ``a<i>_b`` with its layout in the manifest, and
``load_compact`` rebuilds the serving tree from the manifest alone,
never forming a dense weight.  A full train-state snapshot
(``save_train_state`` / ``restore_train_state``) holds the whole engine
state (queue, memories, ledgers) with the run's generator and a
``train_state`` manifest record; its ``state`` subtree restores in
either package, its ``key`` only in the package that wrote it (a
``torch.Generator`` state here, a JAX PRNG key in ``repro``).

A checkpoint always holds whole leaves: a tensor-parallel run gathers
its model shards before ``save`` (``core.distributed.gather_master``),
and a run that restores one at any mesh cuts its own shards out of the
whole tree (``sharding.specs.shard_tree``; the launcher's ``--resume``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_flatten, tree_flatten_with_path, \
    tree_unflatten

#: the manifest ``format`` of a compact serving checkpoint
COMPACT_FORMAT = "compact-v1"

#: dtype name -> (torch dtype, the integer type of its width, the numpy
#: type it is stored as)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, "uint16"),
    "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, "uint8"),
    "float8_e5m2": (torch.float8_e5m2, torch.uint8, "uint8"),
}
_BY_TORCH = {tdt: name for name, (tdt, _, _) in _EXOTIC.items()}


def _to_numpy(t) -> tuple:
    """(numpy array to store, dtype name) of a tensor leaf, or of a host
    leaf of an engine state (a numpy array; an int, kept as int32 as
    ``repro`` keeps its counters)."""
    if isinstance(t, np.ndarray):
        return t, str(t.dtype)
    if isinstance(t, (int, np.integer)):
        arr = np.asarray(t, np.int32)
        return arr, str(arr.dtype)
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


def restore(path: str, like: Any, device=None) -> Any:
    """The checkpoint at ``path`` in the structure of ``like`` (e.g.
    freshly initialized parameters, or their shapes on the ``meta``
    device), each leaf cast to its ``like`` leaf's dtype and put on
    ``device`` (default: the ``like`` leaf's device).  Leaves are read
    one at a time, so the host holds one array at a time."""
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
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint leaf {e['path']} has shape "
                    f"{tuple(t.shape)}, target {tuple(ref.shape)}")
            out.append(t.to(device=ref.device if device is None
                            else device, dtype=ref.dtype))
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


def _path_key(key: tuple) -> str:
    return "/".join(str(k) for k in key)


def _nest_paths(items):
    """A nested tree from ('/'-joined path, value) pairs: all-numeric key
    levels become lists (list indices are numeric path components)."""
    if len(items) == 1 and items[0][0] == "":
        return items[0][1]
    root: dict = {}
    for key, v in items:
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    def conv(d):
        if not isinstance(d, dict):
            return d
        if d and all(k.isdigit() for k in d):
            return [conv(d[k]) for k in sorted(d, key=int)]
        return {k: conv(v) for k, v in d.items()}

    return conv(root)


def is_compact(path: str) -> bool:
    """True when ``path`` holds a compact-format serving checkpoint."""
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return False
    with open(mpath) as f:
        return json.load(f).get("format") == COMPACT_FORMAT


def save_compact(path: str, tree: Any, step: Optional[int] = None,
                 policy: Optional[dict] = None) -> None:
    """Write a serving tree (``serve.compressed.compress_tree`` output)
    in compact form: compressed leaves keep their two buffers plus their
    layout (kind, row_len, shape, out_axis, dtype, op); dense leaves are
    saved as they are."""
    from repro_torch.serve.compressed import CompressedTensor
    os.makedirs(path, exist_ok=True)
    items, _ = tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, CompressedTensor))
    arrays = {}
    manifest = {"format": COMPACT_FORMAT, "keys": [], "step": step}
    if policy is not None:
        manifest["policy"] = policy
    for i, (key, leaf) in enumerate(items):
        name = f"a{i}"
        if isinstance(leaf, CompressedTensor):
            arrays[name + "_a"] = leaf.a.detach().cpu().contiguous().numpy()
            arrays[name + "_b"] = leaf.b.detach().cpu().contiguous().numpy()
            manifest["keys"].append({
                "name": name, "path": _path_key(key), "kind": leaf.kind,
                "row_len": leaf.row_len, "shape": list(leaf.shape),
                "out_axis": leaf.out_axis, "dtype": leaf.dtype,
                "op": leaf.op,
            })
        else:
            arrays[name], dtype = _to_numpy(leaf)
            manifest["keys"].append({"name": name, "path": _path_key(key),
                                     "kind": "dense", "dtype": dtype})
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_compact(path: str, device=None) -> Any:
    """The serving tree of a compact checkpoint on ``device`` (default
    cuda).  Compressed leaves come back as ``CompressedTensor`` holding
    exactly the stored buffers: no dense weight is formed (the
    ``densify`` counter does not move)."""
    from repro_torch.serve.compressed import CompressedTensor
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != COMPACT_FORMAT:
        raise ValueError(f"{path} is not a {COMPACT_FORMAT} checkpoint")
    items = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for e in manifest["keys"]:
            if e["kind"] == "dense":
                items.append((e["path"], _from_numpy(
                    data[e["name"]], e["dtype"]).to(dev)))
                continue
            a, b = (torch.from_numpy(np.array(data[e["name"] + sfx]))
                    .to(dev) for sfx in ("_a", "_b"))
            items.append((e["path"], CompressedTensor(
                e["kind"], a, b, e["row_len"], tuple(e["shape"]),
                e["out_axis"], e["dtype"], e.get("op", ""))))
    return _nest_paths(items)


def _latest(root: str, prefix: str, number) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith(prefix):
            try:
                steps.append(int(number(d)))
            except ValueError:
                pass
    return max(steps) if steps else None


def latest_step(root: str) -> Optional[int]:
    """Latest ``step_<N>`` master checkpoint under ``root`` (None if
    there is none)."""
    return _latest(root, "step_", lambda d: d.split("_")[1])


def latest_full(root: str) -> Optional[int]:
    """Latest ``full_step_<N>`` train-state snapshot under ``root``
    (None if there is none)."""
    return _latest(root, "full_step_", lambda d: d.rsplit("_", 1)[1])


# ---------------------------------------------------------------------------
# crash-consistent full train-state snapshots (DESIGN.md §9)
# ---------------------------------------------------------------------------


def save_train_state(path: str, state: Any, *, key: Any, cursor: int,
                     policy: Optional[dict] = None,
                     faults: Optional[str] = None,
                     staleness_weight: Optional[str] = None) -> None:
    """Write the whole training state: master, per-worker locals, both
    error memories, the in-flight queue (values, arrival steps,
    staleness tags), every ledger and the run's generator ``key`` (a
    ``torch.Generator``, stored as its ``get_state()``), with the cursor
    (the next global step to run) and the fault spec string and
    staleness weighting in a ``train_state`` manifest record.

    The tree is ``{"key": ..., "state": ...}``, leaves in ``repro``'s
    order; ``step``, ``rounds``, ``arrive_at`` and ``inflight_tau`` are
    written int32, as ``repro`` holds them, so the ``state`` subtree of
    a snapshot from either package restores in the other.  The key
    cannot cross frameworks: a ``torch.Generator`` state and a JAX PRNG
    key are different objects."""
    if isinstance(key, torch.Generator):
        key = key.get_state()
    save(path, {"key": key, "state": state}, step=cursor, policy=policy)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["train_state"] = {"cursor": int(cursor), "faults": faults,
                               "staleness_weight": staleness_weight}
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)


def _restore_leaf(arr: np.ndarray, name: str, ref, what: str):
    """A stored leaf in the kind of ``ref``: a tensor on ``ref``'s device
    and dtype, a numpy array of ``ref``'s dtype, or an int."""
    if isinstance(ref, torch.Tensor):
        t = _from_numpy(arr, name)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"snapshot leaf {what} has shape "
                             f"{tuple(t.shape)}, target {tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype)
    a = np.asarray(arr)
    if isinstance(ref, np.ndarray):
        if a.shape != ref.shape:
            raise ValueError(f"snapshot leaf {what} has shape {a.shape}, "
                             f"target {ref.shape}")
        return a.astype(ref.dtype)
    if a.shape != ():
        raise ValueError(f"snapshot leaf {what} has shape {a.shape}, "
                         "target a scalar count")
    return int(a)


def train_state_info(path: str) -> dict:
    """The ``train_state`` record of a full snapshot (``cursor``,
    ``faults``, ``staleness_weight``), read without its arrays."""
    with open(os.path.join(path, "manifest.json")) as f:
        info = json.load(f).get("train_state")
    if info is None:
        raise ValueError(
            f"{path} is a master-only checkpoint, not a full train-state "
            "snapshot (no train_state record in the manifest)")
    return dict(info)


def restore_train_state(path: str, like_state: Any, like_key: Any = None
                        ) -> tuple:
    """Inverse of :func:`save_train_state`: ``(state, key, info)`` with
    ``info`` the ``{"cursor", "faults", "staleness_weight"}`` record.
    ``like_state`` gives the target structure (a fresh state of the same
    run; tensors land on its devices and dtypes, host leaves stay on the
    host).  ``like_key``: a ``torch.Generator``, whose state is set from
    the snapshot and which is returned as ``key``; None skips the key
    (``key`` is then None), which is how a snapshot written by ``repro``
    (a JAX key) restores here."""
    info = train_state_info(path)
    with open(os.path.join(path, "manifest.json")) as f:
        entries = json.load(f)["keys"]
    key_entries = [e for e in entries if e["path"].split("/")[0] == "key"]
    state_entries = [e for e in entries if e["path"].split("/")[0] != "key"]
    leaves_like, spec = tree_flatten(like_state)
    if len(state_entries) != len(leaves_like):
        raise ValueError(
            f"snapshot state has {len(state_entries)} leaves, target "
            f"structure has {len(leaves_like)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = [_restore_leaf(data[e["name"]], e["dtype"], ref, e["path"])
               for e, ref in zip(state_entries, leaves_like)]
        key = None
        if like_key is not None:
            if len(key_entries) != 1:
                raise ValueError(f"snapshot has {len(key_entries)} key "
                                 "leaves, a torch.Generator state needs 1")
            e = key_entries[0]
            if e["dtype"] != "uint8":
                raise ValueError(
                    f"the snapshot's key is a {e['dtype']} array, not a "
                    "torch.Generator state (a key written by repro cannot "
                    "seed the port's generator; pass like_key=None)")
            like_key.set_state(_from_numpy(data[e["name"]], e["dtype"]))
            key = like_key
    state = tree_unflatten(spec, out)
    if hasattr(like_state, "_fields"):     # a NamedTuple state type
        state = type(like_state)(*state)
    return state, key, info
