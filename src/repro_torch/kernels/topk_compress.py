"""Fused row-wise Top_k compression + error update (``repro``'s
``kernels/topk_compress.py``), hand-written in CUDA C++ for Hopper, in
its two emission modes:

  * :func:`topk_compress` (``csrc/topk_compress.cu``) — dense survivors,
    the input of the dense all-reduce sync;
  * :func:`topk_compact` (``csrc/topk_compact.cu``) — compact
    ``(idx, val)`` survivor slots, the wire form of the sparse
    all-gather sync.

Both keep the serial bisection's threshold bit for bit
(``csrc/common.cuh``) and take rows of up to ``SHORT_ROW`` floats in
registers (a warp, or a block of warps, a row: exact order statistics,
then the bisection replayed).  Longer rows take a cluster of blocks per
row in ``topk_compress`` (``cluster_geometry``) and a block per row in
``topk_compact`` (``compact_geometry``).

The launch geometries the tuner (``kernels/autotune.py``) may pick are
the long rows' cluster size (``cluster=``, one of ``cluster_sizes(n)``)
and the warp route's rows a block (``group=``, one of
``compact_groups(n, kcap)``).  Neither changes an output: counts are
integers and the SignTop_k sum of squares has one order
(``ref.tree_sq_ref``) at every cluster size; the warp route's rows are
independent of each other.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import count

#: longest row ``topk_compress`` holds in one warp's or block's registers
#: (``csrc/topk_compress.cu`` kShortMaxElems); longer rows take a cluster
SHORT_ROW = 12288
#: the cluster sizes the long-row kernel takes: 8 (portable) or 16
CLUSTER_SIZES = (8, 16)
#: longest row a warp holds (``csrc/topk_compact.cu`` kWarpMaxElems)
WARP_ROW = 2048
#: shared memory the warp-a-row ``topk_compact`` kernel gives a block's
#: rows at most: half of an H100 SM's 227 KB, so that two blocks of eight
#: warps share an SM
COMPACT_STAGE = 232448 // 2


class ClusterGeometry(NamedTuple):
    """How ``topk_compress`` spreads a long row over a cluster."""
    cs: int        # blocks a row (the cluster size)
    chunk: int     # elements a block owns (a multiple of 4)


def _chunk(n: int, cs: int) -> int:
    """ceil(n / cs), rounded up to a multiple of 4 (16-byte chunks)."""
    per = -(-n // cs)
    return -(-per // 4) * 4


def cluster_geometry(rows: int, n: int, cap8: int,
                     cap16: int) -> ClusterGeometry:
    """The long-row kernel's geometry: block r of a row owns elements
    [r * chunk, (r + 1) * chunk).

    ``cap8`` / ``cap16``: how many clusters of 8 / 16 blocks (each with
    its chunk) the card holds at once; 0 where they do not schedule (16
    exceeds the portable 8).  The size whose waves over the rows times
    its chunk is least wins, ties going to 8: a wave of either size
    costs about its chunk's passes, and a cluster of 8 joins half as
    many blocks in each of its barriers."""
    cost = {}
    for cs, cap in ((8, cap8), (16, cap16)):
        if cap > 0:
            cost[cs] = -(-rows // cap) * _chunk(n, cs)
    if not cost:
        raise RuntimeError(f"no cluster of {CLUSTER_SIZES} blocks schedules "
                           f"for rows of {n} floats")
    cs = min(cost, key=lambda c: (cost[c], c))
    return ClusterGeometry(cs, _chunk(n, cs))


def cluster_sizes(n: int) -> tuple:
    """The cluster sizes the long-row kernel takes for rows of ``n``
    floats (those of ``CLUSTER_SIZES`` that leave no block empty); none
    for rows of up to ``SHORT_ROW``, whose kernel has no geometry to
    pick (``csrc/topk_compress.cu`` chooses its warps a row from n)."""
    if n <= SHORT_ROW:
        return ()
    return tuple(cs for cs in CLUSTER_SIZES if (cs - 1) * _chunk(n, cs) < n)


@functools.lru_cache(maxsize=None)
def cluster_capacity(index: int, cs: int, chunk: int) -> int:
    """Clusters of ``cs`` blocks, each owning ``chunk`` floats, that card
    ``index`` holds at once (0: they do not schedule), as the library's
    occupancy query reports it."""
    with torch.cuda.device(index):
        got = _build.load().qs_topk_cluster_capacity(cs, chunk)
    if got < 0:
        _build.check(-got)
    return got


def card_cluster_geometry(rows: int, n: int, index: int) -> ClusterGeometry:
    """``cluster_geometry`` with card ``index``'s capacities: the long-row
    kernel's own pick there."""
    return cluster_geometry(rows, n, *(
        cluster_capacity(index, cs, _chunk(n, cs)) for cs in CLUSTER_SIZES))


class CompactGeometry(NamedTuple):
    """How ``topk_compact`` runs rows of ``n`` floats with ``kcap`` slots."""
    kernel: str    # "warp" (a warp a row), "block" (4-12 warps a row) or
                   # "scan" (rows past SHORT_ROW: a block, a scan a tile)
    rows: int      # rows a block
    smem: int      # dynamic shared memory of a block, bytes


def compact_area(kcap: int) -> int:
    """Bytes of shared memory a row of the short-row kernel takes: its
    three 256-bin histograms, whose space then holds its ``kcap`` slots
    (idx and val, each rounded up to 16 bytes)."""
    return 4 * max(3 * 256, 2 * (-(-kcap // 4) * 4))


def compact_groups(n: int, kcap: int) -> tuple:
    """Rows a block the warp route of ``topk_compact`` takes (rows of up
    to ``WARP_ROW`` floats): 1, 2, 4 or 8, as far as their slots fit
    ``COMPACT_STAGE``; none for the block and scan routes (one row a
    block, no geometry to pick)."""
    if n > WARP_ROW:
        return ()
    return tuple(g for g in (1, 2, 4, 8)
                 if g == 1 or g * compact_area(kcap) <= COMPACT_STAGE)


def compact_geometry(n: int, kcap: int) -> CompactGeometry:
    """The kernel and block ``topk_compact`` takes, chosen from the shape
    before the launch: rows of up to ``WARP_ROW`` floats a warp each,
    eight a block where their slots fit ``COMPACT_STAGE`` (else 4, 2 or
    1); up to ``SHORT_ROW`` a block of warps a row; longer ones the scan
    kernel (no staged slots)."""
    if n > SHORT_ROW:
        return CompactGeometry("scan", 1, 0)
    area = compact_area(kcap)
    if n > WARP_ROW:
        return CompactGeometry("block", 1, area)
    rows = 8
    while rows > 1 and rows * area > COMPACT_STAGE:
        rows //= 2
    return CompactGeometry("warp", rows, rows * area)


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be [rows, n], got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_k(k: int, n: int, iters: int) -> None:
    if not 1 <= k <= max(n, 1):
        raise ValueError(f"k={k} outside [1, {n}]")
    if not 0 <= iters < 64:
        raise ValueError(f"iters={iters} outside [0, 64)")


def _check_geometry(what: str, value, allowed: tuple, n: int) -> None:
    if value is not None and value not in allowed:
        raise ValueError(f"{what}={value} is not a geometry the kernel takes "
                         f"for rows of {n} floats: "
                         f"{allowed if allowed else 'none (leave it None)'}")


def topk_compress(acc: torch.Tensor, k: int, *, iters: int = 24,
                  sign: bool = False, cluster: Optional[int] = None):
    """acc: [rows, n] float32 -> (selected [rows, n], new_mem [rows, n],
    cnt [rows] int32): the survivors of the bisection threshold (or
    their SignTop_k values), the fused memory ``acc - selected`` and the
    survivor count per row.

    A CUDA tensor launches the kernel on the current stream; rows longer
    than ``SHORT_ROW`` take a cluster of ``cluster_geometry``'s size or
    of ``cluster`` blocks (one of ``cluster_sizes(n)`` that the card
    schedules; any other value raises, on the CPU too).  A CPU tensor
    runs the plain version (``ref.topk_compress_ref``); a ``meta`` tensor
    (a dry run) gets empty outputs of the kernel's shapes, counted as a
    launch, with no call to the card.  There is no other route: a failed
    build or launch raises.
    """
    _check_rows("acc", acc)
    rows, n = acc.shape
    _check_k(k, n, iters)
    _check_geometry("cluster", cluster, cluster_sizes(n), n)
    if rows == 0:       # no live row (every worker dead): nothing to launch
        return (torch.empty_like(acc), torch.empty_like(acc),
                torch.empty((0,), dtype=torch.int32, device=acc.device))
    count("topk_compress", rows=rows, n=n, iters=iters)
    if acc.device.type == "meta":   # a dry run: the outputs' shapes
        return (torch.empty_like(acc), torch.empty_like(acc),
                torch.empty((rows,), dtype=torch.int32, device=acc.device))
    if acc.device.type == "cpu":
        return ref.topk_compress_ref(acc, k, iters=iters, sign=sign)
    if acc.device.type != "cuda":
        raise RuntimeError(f"topk_compress: unsupported device {acc.device}")
    lib = _build.load()
    sel = torch.empty_like(acc)
    mem = torch.empty_like(acc)
    cnt = torch.empty((rows,), dtype=torch.int32, device=acc.device)
    ptrs = (acc.data_ptr(), sel.data_ptr(), mem.data_ptr(), cnt.data_ptr())
    args = (rows, n, int(k), int(iters), int(bool(sign)))
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        if n <= SHORT_ROW:
            _build.check(lib.qs_topk_compress_f32(*ptrs, *args, stream))
        else:
            index = acc.device.index
            if cluster is None:
                geo = card_cluster_geometry(rows, n, index)
            elif cluster_capacity(index, cluster, _chunk(n, cluster)) > 0:
                geo = ClusterGeometry(cluster, _chunk(n, cluster))
            else:
                raise ValueError(f"a cluster of {cluster} blocks does not "
                                 f"schedule on {acc.device}")
            _build.check(lib.qs_topk_compress_cluster_f32(
                *ptrs, *args, *geo, stream))
    return sel, mem, cnt


def topk_compact(acc: torch.Tensor, k: int, kcap: int, *, iters: int = 24,
                 sign: bool = False, group: Optional[int] = None):
    """acc: [rows, n] float32 -> (idx [rows, kcap] int32, val [rows, kcap]
    float32, new_mem [rows, n] float32, cnt [rows] int32): the survivors
    of :func:`topk_compress`'s threshold in ascending index order, the
    first ``kcap`` of them emitted (later ones stay in the memory), the
    sentinel ``(n, 0)`` in the empty slots.

    A CUDA tensor launches the kernel on the current stream, on the route
    ``compact_geometry`` picks from the shape, the warp route with
    ``group`` rows a block where given (one of ``compact_groups(n,
    kcap)``; any other value raises, on the CPU too); a CPU tensor runs
    the plain version (``ref.topk_compact_ref``); a ``meta`` tensor gets
    empty outputs of the kernel's shapes, counted as a launch.  A failed
    build or launch raises.
    """
    _check_rows("acc", acc)
    rows, n = acc.shape
    _check_k(k, n, iters)
    if not 1 <= kcap <= max(n, 1):
        raise ValueError(f"kcap={kcap} outside [1, {n}]")
    _check_geometry("group", group, compact_groups(n, kcap), n)
    if rows == 0:       # no live row: nothing to launch
        return (torch.empty((0, kcap), dtype=torch.int32, device=acc.device),
                torch.empty((0, kcap), dtype=torch.float32,
                            device=acc.device),
                torch.empty_like(acc),
                torch.empty((0,), dtype=torch.int32, device=acc.device))
    count("topk_compact", rows=rows, n=n, kcap=kcap, iters=iters)
    if acc.device.type == "meta":   # a dry run: the outputs' shapes
        return (torch.empty((rows, kcap), dtype=torch.int32,
                            device=acc.device),
                torch.empty((rows, kcap), dtype=torch.float32,
                            device=acc.device),
                torch.empty_like(acc),
                torch.empty((rows,), dtype=torch.int32, device=acc.device))
    if acc.device.type == "cpu":
        return ref.topk_compact_ref(acc, k, kcap, iters=iters, sign=sign)
    if acc.device.type != "cuda":
        raise RuntimeError(f"topk_compact: unsupported device {acc.device}")
    lib = _build.load()
    idx = torch.empty((rows, kcap), dtype=torch.int32, device=acc.device)
    val = torch.empty((rows, kcap), dtype=torch.float32, device=acc.device)
    mem = torch.empty_like(acc)
    cnt = torch.empty((rows,), dtype=torch.int32, device=acc.device)
    geo = compact_geometry(n, kcap)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.qs_topk_compact_f32(
            acc.data_ptr(), idx.data_ptr(), val.data_ptr(), mem.data_ptr(),
            cnt.data_ptr(), rows, n, int(k), int(kcap), int(iters),
            int(bool(sign)), geo.rows if group is None else group, stream))
    return idx, val, mem, cnt
