"""Launch-geometry autotuner for the hand-written CUDA kernels (a port of
``repro.kernels.autotune``).

A kernel's launch geometry changes its time and never its outputs: the
long-row ``topk_compress`` and ``qsgd_quantize`` add their floats in one
order at every cluster size (``ref.tree_sq_ref``; their counts are
integers), and the warp route of ``topk_compact`` runs rows that do not
read each other.  So the geometry is safe to tune: this module times
each candidate on the card (:func:`time_samples`: a CUDA graph of
back-to-back launches replayed between two CUDA events, ``iters``
samples) and keeps the winner (:func:`pick`: the kernel's own geometry
unless another beats it by more than the samples' spread) in a table
for each card kind, which ``kernels/dispatch.py`` resolves every launch
through.

What ``TunedEntry.block_rows`` means, by kernel (``chunk`` stays None:
every kernel derives its chunk from the geometry):

  =================================  ===================================
  ``topk_compress``, n > 12,288      the cluster size (8 or 16, where
                                     the card schedules it)
  ``topk_compact``, n <= 2048        rows a block of the warp route (1,
                                     2, 4 or 8 within ``COMPACT_STAGE``)
  ``qsgd``                           the cluster size (1-16; rows * cs
                                     within the card's resident blocks,
                                     chunks of at least 2048 floats)
  ``paged_decode``                   pages a block (the one kernel whose
                                     outputs move, within its tolerance:
                                     its split merge is a float merge)
  the other launches                 1: one geometry, the kernel's own
                                     (short rows, the compact block and
                                     scan routes, ``sparse_gemm``,
                                     ``qdq_gemm``); timed and recorded
  =================================  ===================================

Resolution order (DESIGN.md §10.2): an explicit ``DispatchConfig(
block_rows=...)``, then the table (an LRU of 512 signatures in front of
the file; hits and misses in ``launch_stats.TUNE_CACHE``), then the
kernel's own pick.  The table lives in ``artifacts/tuning/<kind>.json``,
``<kind>`` the launch device's ``torch.cuda.get_device_name()``
normalised (e.g. ``nvidia_h100_80gb_hbm3``; ``cpu`` for the plain
versions): every function that reads or writes a table takes the device
it is for, and a process holds one loaded table per kind.  A missing
table is empty; a corrupt, stale or foreign one loads as empty with one
warning; a malformed entry is skipped.  ``save_table`` merges into the
file through a temporary file named for the process and ``os.replace``,
so ranks never clobber one file.

CLI::

    PYTHONPATH=src python -m repro_torch.kernels.autotune --smoke [--retune]
    PYTHONPATH=src python -m repro_torch.kernels.autotune --kernel qsgd \\
        --rows 16 --row-len 524288 --k 15

prints one line per signature and ``table: <path> (tuned N, cached M)``;
a second ``--smoke`` reports ``tuned 0, cached 8``.  ``--device cpu``
times the kernels' plain versions instead (for the tests).
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import time
import warnings
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import qsgd as _qsgd
from repro_torch.kernels import sparse_gemm as _sgemm
from repro_torch.kernels import topk_compress as _topk
from repro_torch.kernels.launch_stats import LAUNCHES, TUNE_CACHE

TABLE_VERSION = 1
DEFAULT_TABLE_DIR = os.path.join("artifacts", "tuning")

KERNELS = ("topk_compress", "topk_compact", "qsgd",
           "sparse_gemm", "qdq_gemm", "paged_decode")

#: activation rows of a serving-GEMM measurement (the weight's rows are
#: the signature; the batch scales every candidate alike)
GEMM_MEASURE_M = 8
#: the least device time one timed sample covers on the card (µs), and
#: the most launches it may take to get there
BATCH_US = 50.0
MAX_BATCH = 64

_LRU_MAX = 512
_lru: OrderedDict = OrderedDict()   # (kind, key_str) -> entry or None
_tables: dict = {}                  # kind -> the loaded table
_table_dir: str = DEFAULT_TABLE_DIR
_warned: set = set()


class TunedEntry(NamedTuple):
    """One row of the table: the winning geometry and its time."""

    block_rows: int
    chunk: Optional[int] = None   # kept for repro's schema; always None
    us: float = float("nan")


class ShapeKey(NamedTuple):
    """A launch signature, the table's key."""

    kernel: str
    rows: int
    row_len: int
    k: int          # survivors (Top_k family), levels s (qsgd, qdq_gemm),
                    # kcap (sparse_gemm), head width (paged_decode)
    sign: bool      # SignTop_k; int8 pages for paged_decode
    dtype: str = "f32"

    def as_str(self) -> str:
        return (f"{self.kernel}|{self.dtype}|{self.rows}|{self.row_len}"
                f"|{self.k}|{int(self.sign)}")


def _warn_once(tag: str, msg: str) -> None:
    if tag not in _warned:
        _warned.add(tag)
        warnings.warn(msg, stacklevel=3)


def _device(device=None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_kind(device=None) -> str:
    """The card's kind, the table's file name: ``torch.cuda.
    get_device_name()`` lower-cased, every other character than a letter
    or digit made ``_``; ``cpu`` off the card.  ``device`` defaults to
    where the port runs by default."""
    dev = _device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return "".join(c if c.isalnum() else "_" for c in kind.lower())


def table_path(table_dir: Optional[str] = None, device=None) -> str:
    """The table file of ``device``'s kind (default: where the port runs
    by default) in ``table_dir`` (default: the configured directory)."""
    return os.path.join(table_dir or _table_dir,
                        f"{device_kind(device)}.json")


def configure(table_dir: Optional[str] = None) -> None:
    """Point the module at another table directory and drop what it
    holds in memory, so the next lookup reloads."""
    global _table_dir
    if table_dir is not None:
        _table_dir = table_dir
    clear_cache()


def clear_cache() -> None:
    """Drop the LRU, the loaded tables and the warn-once registry (the
    files are untouched)."""
    _lru.clear()
    _tables.clear()
    _warned.clear()


def parse_key(s: str) -> Optional[ShapeKey]:
    parts = s.split("|")
    if len(parts) != 6 or parts[0] not in KERNELS:
        return None
    try:
        return ShapeKey(parts[0], int(parts[2]), int(parts[3]),
                        int(parts[4]), bool(int(parts[5])), parts[1])
    except ValueError:
        return None


def _valid_entry(ent: dict) -> bool:
    br = ent.get("block_rows")
    return (isinstance(br, int) and not isinstance(br, bool) and br >= 1
            and ent.get("chunk") is None)


def load_table(path: Optional[str] = None, device=None) -> dict:
    """A table file of ``device``'s kind -> {key_str: TunedEntry}.  Never
    raises on bad input: a missing file is empty; corrupt JSON, another
    schema version or another card kind's table load as empty with one
    warning each; a malformed entry is skipped."""
    kind = device_kind(device)
    path = path or table_path(device=device)
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            raw = json.load(f)
    except (json.JSONDecodeError, OSError, UnicodeDecodeError):
        _warn_once(f"corrupt:{path}", f"ignoring corrupt tuning table {path}")
        return {}
    if not isinstance(raw, dict) or raw.get("version") != TABLE_VERSION:
        _warn_once(f"stale:{path}",
                   f"ignoring stale tuning table {path} (version "
                   f"{raw.get('version') if isinstance(raw, dict) else '?'}, "
                   f"want {TABLE_VERSION})")
        return {}
    if raw.get("device_kind") != kind:
        _warn_once(f"foreign:{path}",
                   f"ignoring tuning table {path} tuned for "
                   f"{raw.get('device_kind')!r} (this device: {kind!r})")
        return {}
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        _warn_once(f"stale:{path}",
                   f"ignoring tuning table {path}: no entries mapping")
        return {}
    out = {}
    for ks, ent in entries.items():
        if (parse_key(ks) is None or not isinstance(ent, dict)
                or not _valid_entry(ent)):
            _warn_once(f"entry:{path}",
                       f"skipping malformed entries in tuning table {path}")
            continue
        us = ent.get("us")
        out[ks] = TunedEntry(ent["block_rows"], None,
                             float(us) if isinstance(us, (int, float))
                             else float("nan"))
    return out


def save_table(entries: dict, path: Optional[str] = None,
               device=None) -> str:
    """Merge ``entries`` ({key_str: TunedEntry}) into ``device``'s table
    file (new keys win) and write it back through a temporary file of
    this process.  Returns the path written."""
    path = path or table_path(device=device)
    merged = dict(load_table(path, device))
    merged.update(entries)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "version": TABLE_VERSION,
        "device_kind": device_kind(device),
        "entries": {ks: {"block_rows": e.block_rows, "chunk": e.chunk,
                         "us": e.us}
                    for ks, e in sorted(merged.items())},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def _loaded(device) -> dict:
    """The table of ``device``'s kind, loaded on first use."""
    kind = device_kind(device)
    if kind not in _tables:
        _tables[kind] = load_table(device=device)
    return _tables[kind]


def lookup(kernel: str, rows: int, row_len: int, k: int, sign: bool,
           dtype: str = "f32", device=None) -> Optional[TunedEntry]:
    """The table's entry for a launch on ``device`` (its kind's table):
    the LRU first (``TUNE_CACHE`` ``hit``), then the loaded table
    (``miss``; an absent entry is cached too, so an untuned shape costs
    one probe a call)."""
    ks = ShapeKey(kernel, rows, row_len, k, sign, dtype).as_str()
    slot = (device_kind(device), ks)
    if slot in _lru:
        _lru.move_to_end(slot)
        TUNE_CACHE["hit"] += 1
        return _lru[slot]
    TUNE_CACHE["miss"] += 1
    ent = _loaded(device).get(ks)
    _lru[slot] = ent
    if len(_lru) > _LRU_MAX:
        _lru.popitem(last=False)
    return ent


# ---------------------------------------------------------------------------
# geometries
# ---------------------------------------------------------------------------


def _kcap(k: int, n: int) -> int:
    from repro_torch.kernels.dispatch import capacity
    return capacity(k, n)


def takes(kernel: str, rows: int, row_len: int, k: int, sign: bool,
          value: int) -> bool:
    """Whether the launch's kernel takes geometry ``value`` at all (what
    the wrappers check; the card's occupancy aside)."""
    if kernel == "topk_compress":
        return value in _topk.cluster_sizes(row_len)
    if kernel == "topk_compact":
        return value in _topk.compact_groups(row_len, _kcap(k, row_len))
    if kernel == "qsgd":
        return value in _qsgd.qsgd_clusters(row_len)
    if kernel == "paged_decode":
        return isinstance(value, int) and value >= 1
    return False


def page_block_candidates(pages: int) -> list:
    """Pages a block for ``paged_decode``: the powers of two below the
    table width, and the width itself (one block a row)."""
    cands = set()
    p = 1
    while p < max(pages, 1):
        cands.add(p)
        p *= 2
    cands.add(max(pages, 1))
    return sorted(cands)


def block_row_candidates(key: ShapeKey, device=None) -> list:
    """The geometries the tuner times for a launch (the meanings in the
    module's table): on the card, those its occupancy allows; ``[]``
    where the launch has one geometry, the kernel's own."""
    dev = _device(device)
    n = key.row_len
    if key.kernel == "topk_compress":
        sizes = _topk.cluster_sizes(n)
        if dev.type == "cuda":
            sizes = tuple(cs for cs in sizes if _topk.cluster_capacity(
                dev.index, cs, _topk._chunk(n, cs)) > 0)
        return list(sizes)
    if key.kernel == "topk_compact":
        return list(_topk.compact_groups(n, _kcap(key.k, n)))
    if key.kernel == "qsgd":
        slots = (_qsgd.resident_blocks(dev.index) if dev.type == "cuda"
                 else None)
        return [cs for cs in _qsgd.qsgd_clusters(n) if cs == 1 or (
            _topk._chunk(n, cs) >= _qsgd.QSGD_MIN_CHUNK
            and (slots is None or key.rows * cs <= slots))]
    if key.kernel == "paged_decode":
        return page_block_candidates(key.rows)
    if key.kernel in KERNELS:
        return []
    raise ValueError(f"unknown kernel {key.kernel!r}; expected one of "
                     f"{KERNELS}")


def default_geometry(key: ShapeKey, device=None) -> Optional[int]:
    """The geometry the kernel picks itself for a launch on the card
    (None: it has one geometry; on the CPU, where the plain versions run,
    the card-dependent picks are None too)."""
    dev = _device(device)
    n = key.row_len
    if key.kernel == "topk_compact":
        kcap = _kcap(key.k, n)
        return (_topk.compact_geometry(n, kcap).rows
                if _topk.compact_groups(n, kcap) else None)
    if key.kernel == "paged_decode":
        return max(1, min(_pa.DEFAULT_PAGES_PER_BLOCK, key.rows))
    if dev.type != "cuda":
        return None
    if key.kernel == "topk_compress" and _topk.cluster_sizes(n):
        return _topk.card_cluster_geometry(key.rows, n, dev.index).cs
    if key.kernel == "qsgd":
        return _qsgd.qsgd_geometry(key.rows, n,
                                   _qsgd.resident_blocks(dev.index)).cs
    return None


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def launcher(key: ShapeKey, device=None,
             seed: int = 0) -> Callable[[Optional[int]], tuple]:
    """``run(geometry)``: one launch of the key's kernel wrapper at that
    geometry (None: the kernel's own) on inputs drawn on the device from
    ``seed``, its outputs returned.  The tuner times it; the card check
    also holds every candidate's outputs to the kernel's own."""
    dev = _device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    R, n, k = key.rows, key.row_len, key.k

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    if key.kernel == "topk_compress":
        x = randn(R, n)
        return lambda geo: _topk.topk_compress(x, k, sign=key.sign,
                                               cluster=geo)
    if key.kernel == "topk_compact":
        x = randn(R, n)
        kcap = _kcap(k, n)
        return lambda geo: _topk.topk_compact(x, k, kcap, sign=key.sign,
                                              group=geo)
    if key.kernel == "qsgd":
        x, u = randn(R, n), rand(R, n)
        return lambda geo: (_qsgd.qsgd_quantize(x, u, k, cluster=geo),)
    if key.kernel == "sparse_gemm":
        # rows ascending, k survivors each (k is kcap), no sentinel slots
        x = randn(GEMM_MEASURE_M, n)
        idx = rand(R, n).argsort(dim=1)[:, :k].sort(dim=1).values.to(
            torch.int32).contiguous()
        val = randn(R, k)
        return lambda geo: (_sgemm.sparse_gemm(x, idx, val, n),)
    if key.kernel == "qdq_gemm":
        x = randn(GEMM_MEASURE_M, n)
        levels = torch.randint(-k, k + 1, (R, n), generator=g, device=dev,
                               dtype=torch.int8)
        scale = rand(R, 1)
        return lambda geo: (_sgemm.qdq_gemm(x, levels, scale),)
    if key.kernel == "paged_decode":
        # rows = the block table's width P, row_len = page size, k = head
        # width, sign = int8 pages; 4 requests of 8 query heads on one
        # kv head, every page live
        P, ps, hd, B = R, n, k, 4
        q = randn(B, 1, 8, hd)
        if key.sign:
            kp, vp = (torch.randint(-127, 128, (B * P, ps, 1, hd),
                                    generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(2))
        else:
            kp, vp = randn(B * P, ps, 1, hd), randn(B * P, ps, 1, hd)
        ks, vs = rand(B * P, ps), rand(B * P, ps)
        tables = torch.arange(B * P, dtype=torch.int32,
                              device=dev).reshape(B, P)
        lengths = torch.full((B,), P * ps, dtype=torch.int32, device=dev)
        return lambda geo: (_pa.paged_decode(
            q, kp, vp, ks, vs, tables, lengths,
            pages_per_block=(_pa.DEFAULT_PAGES_PER_BLOCK if geo is None
                             else geo)),)
    raise ValueError(f"unknown kernel {key.kernel!r}; expected one of "
                     f"{KERNELS}")


def _graph_of(fn: Callable[[], object], reps: int,
              dev: torch.device) -> "torch.cuda.CUDAGraph":
    """A CUDA graph of ``reps`` back-to-back calls of ``fn``: one eager
    call first on the capture's own stream (the kernels key their ticket
    buffers by stream), the garbage collector held off during the capture
    (``graphs.CudaGraph``'s reasons)."""
    stream = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        fn()
    cur.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    finally:
        if enabled:
            gc.enable()
    graph.replay()   # the first replay uploads the graph
    return graph


def _replay_us(graph, dev: torch.device) -> float:
    stream = torch.cuda.current_stream(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record(stream)
    graph.replay()
    b.record(stream)
    b.synchronize()
    return a.elapsed_time(b) * 1e3


def batch_size(fn: Callable[[], object], device=None) -> int:
    """Launches a timed sample of ``fn`` takes on the card: enough for
    ``BATCH_US`` of device time (one graphed call timed first), at most
    ``MAX_BATCH``; 1 on the CPU."""
    dev = _device(device)
    if dev.type != "cuda":
        return 1
    one = _graph_of(fn, 1, dev)
    us = min(_replay_us(one, dev) for _ in range(3))
    return max(1, min(MAX_BATCH, math.ceil(BATCH_US / max(us, 1e-3))))


def time_samples(fn: Callable[[], object], device=None, iters: int = 3,
                 reps: Optional[int] = None) -> list:
    """``iters`` timings of ``fn``, each in µs a call.  On the card a
    sample is one replay of a CUDA graph of ``reps`` back-to-back calls
    (default :func:`batch_size`) between two CUDA events on the current
    stream: the host's launch time and the events' resolution stay out
    of it, as in a graphed round.  On the CPU
    (the plain versions) one call on the host's clock, after a
    warm-up."""
    dev = _device(device)
    n = max(1, iters)
    if dev.type != "cuda":
        fn()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e6)
        return out
    reps = reps or batch_size(fn, dev)
    graph = _graph_of(fn, reps, dev)
    return [_replay_us(graph, dev) / reps for _ in range(n)]


def time_candidates(key: ShapeKey, *, iters: int = 3,
                    device=None) -> dict:
    """{geometry: [µs a call] * iters} for every candidate of a launch
    ({None: ...} where it has one geometry), every candidate's samples
    the same batch of launches long.  Measurement launches are not the
    run's: ``LAUNCHES`` is left as it was."""
    before = dict(LAUNCHES)
    try:
        run = launcher(key, device)
        cands = block_row_candidates(key, device) or [None]
        reps = batch_size(lambda: run(cands[0]), device)
        return {g: time_samples(lambda: run(g), device, iters, reps)
                for g in cands}
    finally:
        LAUNCHES.update(before)


def pick(samples: dict, default) -> Optional[int]:
    """The winner of {geometry: [µs]}: the candidate with the least best
    sample, but the kernel's own geometry ``default`` unless the winner's
    best beats the default's by more than the spread (largest minus
    least sample) of either, so that noise never moves a key off the
    kernel's own pick."""
    best = min(samples, key=lambda g: min(samples[g]))
    if default not in samples or best == default:
        return best
    spread = max(max(samples[g]) - min(samples[g]) for g in (best, default))
    gain = min(samples[default]) - min(samples[best])
    return best if gain > spread else default


def measure_entry(key: ShapeKey, *, iters: int = 3,
                  device=None) -> TunedEntry:
    """Time every candidate geometry of a launch; the winner
    (:func:`pick`) as an entry (``block_rows`` 1 where the launch has one
    geometry), with its best time."""
    samples = time_candidates(key, iters=iters, device=device)
    g = pick(samples, default_geometry(key, device))
    return TunedEntry(1 if g is None else g, None, min(samples[g]))


def tune(keys, *, iters: int = 3, retune: bool = False, save: bool = True,
         device=None, verbose: bool = False) -> dict:
    """Tune every ShapeKey of ``keys`` not in the table yet (all of them
    with ``retune``), save the merged table, and return {key_str:
    TunedEntry} of the keys measured in this call.  Raises on a stream
    that is capturing a CUDA graph: tune before the capture.  The table
    is ``device``'s kind's."""
    dev = _device(device)
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("autotune.tune measures launches and cannot run "
                           "while the stream captures a CUDA graph; tune "
                           "before the capture")
    table = _loaded(dev)
    fresh = {}
    cached = 0
    for key in keys:
        ks = key.as_str()
        if not retune and ks in table:
            cached += 1
            if verbose:
                print(f"  cached {ks} -> {table[ks]}", flush=True)
            continue
        ent = measure_entry(key, iters=iters, device=dev)
        fresh[ks] = ent
        if verbose:
            print(f"  tuned  {ks} -> block_rows={ent.block_rows} "
                  f"({ent.us:.1f} us; default "
                  f"{default_geometry(key, dev)})", flush=True)
    if fresh:
        table.update(fresh)
        if save:
            save_table(fresh, device=dev)
        _lru.clear()   # resolutions cached before this tune are stale
    tune.last_cached = cached
    return fresh


tune.last_cached = 0


def tune_for_run(op_tree, params, cfg=None, *, downlink=None,
                 iters: int = 3, retune: bool = False, compact: bool = False,
                 workers: int = 1, verbose: bool = False,
                 device=None) -> dict:
    """Tune the launch signatures a training run's compression dispatches
    (``dispatch.launch_plans`` of the uplink, and the downlink, operator
    trees over the per-worker ``params``, ``workers`` workers packed into
    each launch)."""
    from repro_torch.kernels import dispatch as dsp
    keys = dsp.launch_plans(op_tree, params, cfg, compact=compact,
                            workers=workers, device=device)
    if downlink is not None:
        for key in dsp.launch_plans(downlink, params, cfg, compact=compact,
                                    workers=workers, device=device):
            if key not in keys:
                keys.append(key)
    return tune(keys, iters=iters, retune=retune, verbose=verbose,
                device=device)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

#: a small fixed budget: one signature per kernel family (repro's)
SMOKE_KEYS = (
    ShapeKey("topk_compress", 4, 256, 8, False),
    ShapeKey("topk_compress", 1, 1024, 16, True),
    ShapeKey("topk_compact", 4, 256, 8, False),
    ShapeKey("qsgd", 1, 1024, 15, False),
    ShapeKey("sparse_gemm", 8, 256, 16, False),
    ShapeKey("qdq_gemm", 8, 256, 15, False),
    ShapeKey("paged_decode", 4, 16, 32, False),
    ShapeKey("paged_decode", 4, 16, 32, True),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="autotune the CUDA kernels' launch geometry")
    ap.add_argument("--smoke", action="store_true",
                    help="tune the small fixed smoke signatures")
    ap.add_argument("--retune", action="store_true",
                    help="re-measure signatures already in the table")
    ap.add_argument("--dir", default=None,
                    help=f"table directory (default {DEFAULT_TABLE_DIR})")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--kernel", choices=KERNELS)
    ap.add_argument("--rows", type=int)
    ap.add_argument("--row-len", type=int)
    ap.add_argument("--k", type=int)
    ap.add_argument("--sign", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: time the kernels' plain versions")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda needs a GPU (torch.cuda.is_available() is "
                 "False); pass --device cpu to time the plain versions")
    if args.dir:
        configure(args.dir)
    if args.smoke:
        keys = list(SMOKE_KEYS)
    elif args.kernel:
        if not (args.rows and args.row_len and args.k):
            ap.error("--kernel needs --rows, --row-len and --k")
        keys = [ShapeKey(args.kernel, args.rows, args.row_len, args.k,
                         args.sign)]
    else:
        ap.error("pass --smoke or an explicit --kernel shape")
    fresh = tune(keys, iters=args.iters, retune=args.retune, verbose=True,
                 device=args.device)
    path = table_path(device=args.device)
    print(f"table: {path} (tuned {len(fresh)}, cached {tune.last_cached})",
          flush=True)
    return 0 if os.path.exists(path) or not fresh else 1


if __name__ == "__main__":
    raise SystemExit(main())
