"""Fused row-wise Top_k compression + error update (``repro``'s
``kernels/topk_compress.py``), hand-written in CUDA C++ for Hopper, in
its two emission modes:

  * :func:`topk_compress` (``csrc/topk_compress.cu``) — dense survivors,
    the input of the dense all-reduce sync;
  * :func:`topk_compact` (``csrc/topk_compact.cu``) — compact
    ``(idx, val)`` survivor slots, the wire form of the sparse
    all-gather sync.

Both share one threshold (``csrc/common.cuh``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES


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


def topk_compress(acc: torch.Tensor, k: int, *, iters: int = 24,
                  sign: bool = False):
    """acc: [rows, n] float32 -> (selected [rows, n], new_mem [rows, n],
    cnt [rows] int32): the survivors of the bisection threshold (or
    their SignTop_k values), the fused memory ``acc - selected`` and the
    survivor count per row.

    A CUDA tensor launches the kernel on the current stream; a CPU
    tensor runs the plain version (``ref.topk_compress_ref``).  There is
    no other route: a failed build or launch raises.
    """
    _check_rows("acc", acc)
    rows, n = acc.shape
    _check_k(k, n, iters)
    LAUNCHES["topk_compress"] += 1
    if acc.device.type == "cpu":
        return ref.topk_compress_ref(acc, k, iters=iters, sign=sign)
    if acc.device.type != "cuda":
        raise RuntimeError(f"topk_compress: unsupported device {acc.device}")
    lib = _build.load()
    sel = torch.empty_like(acc)
    mem = torch.empty_like(acc)
    cnt = torch.empty((rows,), dtype=torch.int32, device=acc.device)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.qs_topk_compress_f32(
            acc.data_ptr(), sel.data_ptr(), mem.data_ptr(), cnt.data_ptr(),
            rows, n, int(k), int(iters), int(bool(sign)), stream))
    return sel, mem, cnt


def topk_compact(acc: torch.Tensor, k: int, kcap: int, *, iters: int = 24,
                 sign: bool = False):
    """acc: [rows, n] float32 -> (idx [rows, kcap] int32, val [rows, kcap]
    float32, new_mem [rows, n] float32, cnt [rows] int32): the survivors
    of :func:`topk_compress`'s threshold in ascending index order, the
    first ``kcap`` of them emitted (later ones stay in the memory), the
    sentinel ``(n, 0)`` in the empty slots.

    A CUDA tensor launches the kernel on the current stream; a CPU
    tensor runs the plain version (``ref.topk_compact_ref``).  A failed
    build or launch raises.
    """
    _check_rows("acc", acc)
    rows, n = acc.shape
    _check_k(k, n, iters)
    if not 1 <= kcap <= max(n, 1):
        raise ValueError(f"kcap={kcap} outside [1, {n}]")
    LAUNCHES["topk_compact"] += 1
    if acc.device.type == "cpu":
        return ref.topk_compact_ref(acc, k, kcap, iters=iters, sign=sign)
    if acc.device.type != "cuda":
        raise RuntimeError(f"topk_compact: unsupported device {acc.device}")
    lib = _build.load()
    idx = torch.empty((rows, kcap), dtype=torch.int32, device=acc.device)
    val = torch.empty((rows, kcap), dtype=torch.float32, device=acc.device)
    mem = torch.empty_like(acc)
    cnt = torch.empty((rows,), dtype=torch.int32, device=acc.device)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.qs_topk_compact_f32(
            acc.data_ptr(), idx.data_ptr(), val.data_ptr(), mem.data_ptr(),
            cnt.data_ptr(), rows, n, int(k), int(kcap), int(iters),
            int(bool(sign)), stream))
    return idx, val, mem, cnt
