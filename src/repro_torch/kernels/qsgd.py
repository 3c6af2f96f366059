"""Bucketed QSGD stochastic quantization (``repro``'s
``kernels/qsgd.py::qsgd_quantize``), hand-written in CUDA C++ for
Hopper (``csrc/qsgd.cu``).  The uniforms are an operand, so the kernel
is deterministic given its inputs.  Each bucket (row) runs on a
thread-block cluster of ``qsgd_geometry``'s size, each block streaming a
chunk of the row; the blocks add their sums of squares in rank order
through distributed shared memory."""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.kernels.topk_compress import _check_rows, _chunk

#: the cluster sizes the kernel takes (16 is past the portable 8)
QSGD_CLUSTERS = (1, 2, 4, 8, 16)
#: the least a block is given where a row is split: one float4 for each
#: of its 512 threads
QSGD_MIN_CHUNK = 512 * 4


class QsgdGeometry(NamedTuple):
    """How ``qsgd_quantize`` spreads a row over a cluster."""
    cs: int        # blocks a row (the cluster size)
    chunk: int     # elements a block owns (a multiple of 4)


def qsgd_geometry(rows: int, n: int, slots: int) -> QsgdGeometry:
    """The kernel's geometry for ``rows`` buckets of ``n`` floats: block r
    of a row owns elements [r * chunk, (r + 1) * chunk).

    ``slots``: how many of the kernel's blocks the card holds at once.
    The cluster doubles from 1 while every row's blocks still fit the
    card at once (rows * cs <= slots), up to 16, and while each block
    keeps at least ``QSGD_MIN_CHUNK`` floats: the rows' loads spread over
    as many SMs as one wave allows."""
    cs = 1
    while (2 * cs <= QSGD_CLUSTERS[-1] and rows * 2 * cs <= slots
           and _chunk(n, 2 * cs) >= QSGD_MIN_CHUNK):
        cs *= 2
    return QsgdGeometry(cs, max(4, _chunk(n, cs)))


@functools.lru_cache(maxsize=None)
def resident_blocks(index: int) -> int:
    """How many of the kernel's blocks card ``index`` holds at once, as
    the library's occupancy query reports it."""
    with torch.cuda.device(index):
        got = _build.load().qs_qsgd_resident_blocks()
    if got < 0:
        _build.check(-got)
    return got


def _launch(x: torch.Tensor, u: torch.Tensor, s: int,
            geo: QsgdGeometry) -> torch.Tensor:
    """One launch of the kernel at geometry ``geo`` on x's card."""
    out = torch.empty_like(x)
    rows, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_build.load().qs_qsgd_quantize_f32(
            x.data_ptr(), u.data_ptr(), out.data_ptr(), rows, n, int(s),
            geo.cs, geo.chunk, stream))
    return out


def qsgd_quantize(x: torch.Tensor, u: torch.Tensor, s: int) -> torch.Tensor:
    """x, u: [buckets, n] float32 -> dequantized [buckets, n] float32.

    A CUDA tensor launches the kernel on the current stream, at the
    geometry ``qsgd_geometry`` picks for the card; a CPU tensor runs the
    plain version (``ref.qsgd_bucketed_ref``).  There is no other route:
    a failed build or launch raises.
    """
    _check_rows("x", x)
    _check_rows("u", u)
    if u.shape != x.shape or u.device != x.device:
        raise ValueError(f"u {tuple(u.shape)} on {u.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")
    if int(s) < 1:
        raise ValueError(f"s={s} must be >= 1")
    if x.shape[0] == 0:     # no live bucket: nothing to launch
        return torch.empty_like(x)
    LAUNCHES["qsgd"] += 1
    if x.device.type == "cpu":
        return ref.qsgd_bucketed_ref(x, u, s)
    if x.device.type != "cuda":
        raise RuntimeError(f"qsgd_quantize: unsupported device {x.device}")
    geo = qsgd_geometry(*x.shape, resident_blocks(x.device.index))
    return _launch(x, u, s, geo)
