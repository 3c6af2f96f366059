"""Collective byte counts (the counterpart of ``repro``'s
``launch/roofline_parse.py``, which parses them out of XLA's HLO text).

The port has no HLO: a collective is an event ``(kind, dtype, shape)``,
``kind`` in ``repro``'s names (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``) and
``shape`` that of the collective's result on one device (an all-gather's
gathered [W, ...] tensor), as HLO gives it.  The dry run's mesh
(``launch.mesh.DryMesh``) records such events; :func:`events_from_profile`
reads them out of a ``torch.profiler`` trace of a real run, op names
``c10d::allreduce_`` / ``c10d::_allgather_base_`` with the backend's
``gloo:all_reduce`` / ``gloo:all_gather`` beside them (torch 2.11 and
2.13 alike).
"""

from __future__ import annotations

import json
import os
import tempfile

import torch

#: bytes an element, by the names HLO, torch.profiler and torch give a
#: dtype
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
    "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
    "f8e4m3fn": 1, "f8e5m2": 1,
    "double": 8, "float": 4, "c10::BFloat16": 2, "c10::Half": 2,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
    "long int": 8, "long": 8, "int": 4, "short int": 2, "short": 2,
    "signed char": 1, "unsigned char": 1, "bool": 1,
}

#: the c10d ops a trace records for each collective, by kind, and which
#: of their arguments holds the result (an all-gather's output comes
#: first, an all-reduce's tensor list is reduced in place)
C10D_OPS = {
    "c10d::allreduce_": ("all-reduce", 0),
    "c10d::allreduce_coalesced_": ("all-reduce", 0),
    "c10d::_allgather_base_": ("all-gather", 0),
    "c10d::allgather_into_tensor_coalesced_": ("all-gather", 0),
    "c10d::allgather_": ("all-gather", 0),
    "c10d::_reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d::reduce_scatter_": ("reduce-scatter", 0),
    "c10d::reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "c10d::alltoall_base_": ("all-to-all", 0),
    "c10d::alltoall_": ("all-to-all", 0),
}


def dtype_bytes(dtype) -> int:
    """Bytes an element of ``dtype``: a ``torch.dtype`` or a name HLO or
    torch.profiler uses (``f32``, ``float``, ``c10::BFloat16``, ...).
    A name missing from ``_DTYPE_BYTES`` raises: a guessed width would
    count wrong bytes with no sign of it."""
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    if dtype not in _DTYPE_BYTES:
        raise ValueError(f"unknown dtype name {dtype!r}: add its width to "
                         f"roofline_parse._DTYPE_BYTES")
    return _DTYPE_BYTES[dtype]


def collective_bytes(events) -> dict:
    """Sum the result bytes of ``(kind, dtype, shape)`` events (a
    ``DryMesh``'s carry their group as a fourth field) by kind, with
    their ``total``: ``repro``'s dict."""
    out: dict = {}
    for kind, dtype, shape, *_ in events:
        nbytes = dtype_bytes(dtype)
        for d in shape:
            nbytes *= int(d)
        out[kind] = out.get(kind, 0) + nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


def collectives_by_group(events) -> dict:
    """:func:`collective_bytes` of a ``DryMesh``'s events apart by the
    group each ran over: ``{"data": {...}, "model": {...}}`` (the
    tensor-parallel collectives under ``model``, the engine's wires and
    means under ``data``; a barrier's under ``world``), groups with no
    event left out."""
    groups: dict = {}
    for ev in events:
        groups.setdefault(ev[3] if len(ev) > 3 else "data", []).append(ev)
    return {g: collective_bytes(evs) for g, evs in sorted(groups.items())}


#: the prefixes of the process-group backends' own records of a collective
BACKENDS = ("gloo:", "nccl:", "mpi:", "ucc:")


def _arg(args: dict, arg: int) -> tuple:
    """(shapes, dtype) of argument ``arg`` of a trace record's ``args``
    ("Input Dims", "Input type"): one shape for a tensor, each tensor's
    for a tensor list; None where the record leaves them out (a tensor
    list's dtype always, its shapes on some torch versions)."""
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    dtype = types[arg] if arg < len(types) else None
    if arg >= len(dims):
        return None, None
    d = dims[arg]
    if dtype == "TensorList":
        if d and all(isinstance(x, list) for x in d):
            return [tuple(x) for x in d], None
        return None, None
    return [tuple(d)], dtype or None


def events_from_trace(records) -> list:
    """The ``(kind, dtype, shape)`` events of the collectives among the
    records of a Chrome trace (``torch.profiler``'s, with
    ``record_shapes``: each a dict with ``name``, ``ts`` and ``args``), in
    order, from the c10d ops (``C10D_OPS``), one event a tensor of a
    tensor list.  What a c10d op's record leaves out (a tensor list's
    dtype, and on some torch versions its shapes) comes from the
    backend's record of the same collective (``gloo:all_reduce``,
    ``nccl:all_reduce``, ...): the first one of its kind from the op's
    start on.  A collective whose shapes or dtype neither record gives
    raises, as does a dtype name ``dtype_bytes`` does not know."""
    recs = sorted((r for r in records if r.get("ph", "X") == "X"),
                  key=lambda r: r.get("ts", 0))
    backend = [r for r in recs if r.get("name", "").startswith(BACKENDS)]
    used: set = set()
    out = []
    for r in recs:
        if r.get("name") not in C10D_OPS:
            continue
        kind, arg = C10D_OPS[r["name"]]
        shapes, dtype = _arg(r.get("args") or {}, arg)
        if shapes is None or dtype is None:
            rec = next((b for b in backend if id(b) not in used
                        and b.get("ts", 0) >= r.get("ts", 0)
                        and kind.replace("-", "_") in b["name"]), None)
            if rec is not None:
                used.add(id(rec))
                bargs = rec.get("args") or {}
                ds = bargs.get("Input type") or []
                dtype = dtype or (ds[0] if ds else None)
                if shapes is None:
                    shapes = [tuple(x) for x in bargs.get("Input Dims")
                              or []]
        if shapes is None or dtype is None:
            raise ValueError(f"no {'shape' if shapes is None else 'dtype'} "
                             f"for {r['name']} at ts {r.get('ts')}: neither "
                             f"its record nor a backend record gives one")
        dtype_bytes(dtype)
        out += [(kind, dtype, shape) for shape in shapes]
    return out


def events_from_profile(prof) -> list:
    """:func:`events_from_trace` of a ``torch.profiler.profile(
    record_shapes=True)`` session, read from its Chrome trace (which
    carries every record's input dtypes; the profiler's event objects
    do not on every torch version)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return events_from_trace(trace.get("traceEvents", []))
