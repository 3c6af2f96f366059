"""The compressed-weight serving GEMMs (``repro``'s
``kernels/sparse_gemm.py``: ``sparse_gemm`` and ``qdq_gemm``),
hand-written in CUDA C++ for Hopper (``csrc/sparse_gemm.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor
runs the kernel's plain version (``ref.sparse_gemm_ref`` /
``ref.qdq_gemm_ref``); a ``meta`` tensor (a dry run) gets an empty
output of the kernel's shape.  There is no other route: a failed build
or launch raises.  Both count one launch per call in ``LAUNCHES``.
``sparse_gemm`` runs one of three kernels, picked inside the launch
(``sparse_route`` mirrors the choice): decode batches (M <= 8) stage x in
shared memory once a block and walk batches of output rows
(``decode_geometry``, ``decode_grid``); prefill widths stage activation
tiles (``tile_geometry``, ``tiled_route``); other batches take a warp per
output row;
``qdq_gemm`` runs bfloat16 activations at M >= 2 on the tensor cores
and the rest on FMAs, one pass over the levels for every 8 rows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import count

_X_DTYPES = (torch.float32, torch.bfloat16)
#: ``sparse_gemm_route``'s kernels: the one the shapes pick, a warp per
#: output row, the tiled one, the decode one
ROUTES = {"auto": -1, "rows": 0, "tiled": 1, "decode": 2}
#: the longest row ``qdq_gemm`` takes: one row of x, as float32, beside
#: the warps' 64 KB of level stages in a block's 227 KB of shared memory
QDQ_MAX_ROW = (232448 - 65536) // 4


class TileGeometry(NamedTuple):
    """The tiled ``sparse_gemm`` kernel's geometry."""
    min_m: int        # M from which the launch may take the tiled kernel
    always_m: int     # M from which it always does
    tile_m: int       # activation rows a block
    tile_r: int       # output rows a block of 16 warps
    tile_r_wide: int  # output rows a block of 32 warps
    chunk_f32: int    # columns a staged chunk, float32 x
    chunk_bf16: int   # columns a staged chunk, bfloat16 x
    smem: int         # shared memory of a block of 32 warps, bytes


def tile_geometry() -> TileGeometry:
    """The tiled kernel's geometry, as the library reports it
    (``qs_sparse_gemm_geometry``)."""
    geo = (ctypes.c_int * 8)()
    _build.check(_build.load().qs_sparse_gemm_geometry(geo))
    return TileGeometry(*geo)


def tiled_route(M: int, R: int, sms: int, geo: TileGeometry) -> bool:
    """Whether ``sparse_gemm`` takes the tiled kernel for [M, n] x
    [R, kcap] on a card of ``sms`` SMs: from ``always_m`` on, and from
    ``min_m`` on where its 16-warp blocks fill a third of the SMs (below
    ``tile_m`` rows its time hardly moves with M).  The launch decides
    in the library; this mirrors it for the tests."""
    if M >= geo.always_m:
        return True
    if M < geo.min_m:
        return False
    blocks = -(-M // geo.tile_m) * -(-R // geo.tile_r)
    return 3 * blocks >= sms


class DecodeGeometry(NamedTuple):
    """The decode ``sparse_gemm`` kernel's geometry."""
    max_m: int   # activation rows it takes at most
    smem: int    # bytes of staged x it takes at most
    warps: int   # warps a block


def decode_geometry() -> DecodeGeometry:
    """The decode kernel's geometry, as the library reports it
    (``qs_sparse_gemm_decode_geometry``)."""
    geo = (ctypes.c_int * 3)()
    _build.check(_build.load().qs_sparse_gemm_decode_geometry(geo))
    return DecodeGeometry(*geo)


def decode_rows(M: int) -> int:
    """Activation rows a staged record holds: M rounded up to 1, 2, 4 or
    8."""
    return 1 if M <= 1 else 2 if M <= 2 else 4 if M <= 4 else 8


def decode_batch(M: int) -> int:
    """Output rows a warp of the decode kernel walks at once: 16 sums a
    lane from 4 activation rows a record up (2 rows at 8, 4 at 4), else
    4."""
    rec = decode_rows(M)
    return 16 // rec if rec >= 4 else 4


def decode_stage_bytes(M: int, n: int, x_bytes: int) -> int:
    """Shared memory the decode kernel stages x in: a record of
    ``decode_rows(M)`` values for each column, the columns rounded up to
    whole 16-byte loads of a row."""
    vc = 16 // x_bytes
    return -(-n // vc) * vc * decode_rows(M) * x_bytes


def decode_grid(M: int, R: int, sms: int, geo: DecodeGeometry) -> tuple:
    """(blocks, output rows a block) of the decode kernel: one block a SM,
    but no more blocks than give each warp a batch of rows (each block
    stages all of x); block b owns rows [b * rows, (b + 1) * rows)."""
    blocks = max(1, min(sms, -(-R // (geo.warps * decode_batch(M)))))
    return blocks, -(-R // blocks)


def sparse_route(M: int, R: int, n: int, x_bytes: int, sms: int,
                 geo: TileGeometry, dgeo: DecodeGeometry) -> str:
    """The kernel ``sparse_gemm`` takes for [M, n] x [R, kcap] with x of
    ``x_bytes`` an element on a card of ``sms`` SMs: "decode" where M <=
    ``dgeo.max_m`` and x fits its staging, else "tiled" where
    ``tiled_route`` says so, else "rows".  The launch decides in the
    library; this mirrors it for the tests."""
    if M <= dgeo.max_m and decode_stage_bytes(M, n, x_bytes) <= dgeo.smem:
        return "decode"
    return "tiled" if tiled_route(M, R, sms, geo) else "rows"


def sparse_gemm(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                row_len: int) -> torch.Tensor:
    """``y[m, r] = sum_s val[r, s] * x[m, idx[r, s]]``.

    x: [M, row_len] float32 or bfloat16 activations; idx int32 / val
    float32: [R, kcap] compact survivor buffers, each row's indices
    ascending with the out-of-row sentinel ``idx = row_len, val = 0``
    after its survivors (the layout ``serve.compressed`` builds).
    Returns [M, R] float32.
    """
    return sparse_gemm_route(x, idx, val, row_len, "auto")


def sparse_gemm_route(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                      row_len: int, route: str) -> torch.Tensor:
    """``sparse_gemm`` on the kernel ``route`` names (``ROUTES``): the
    card tests and the crossover bench run every kernel at one M (the
    decode one refuses M > 8 and x past its staging)."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {sorted(ROUTES)}, got "
                         f"{route!r}")
    _build.check_tensor("x", x, 2, _X_DTYPES)
    _build.check_tensor("idx", idx, 2, (torch.int32,))
    _build.check_tensor("val", val, 2, (torch.float32,))
    M, n = x.shape
    R, kcap = idx.shape
    if n != row_len:
        raise ValueError(f"x has {n} features, buffers expect {row_len}")
    if tuple(val.shape) != (R, kcap):
        raise ValueError(f"val {tuple(val.shape)} != idx {(R, kcap)}")
    dev = _build.device_of(x, idx, val)
    count("sparse_gemm", M=M, n=n, R=R, kcap=kcap,
          x_bytes=x.element_size())
    if dev.type == "meta":
        return torch.empty((M, R), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return ref.sparse_gemm_ref(x, idx, val, row_len)
    lib = _build.load()
    out = torch.empty((M, R), dtype=torch.float32, device=dev)
    _build.check(lib.qs_sparse_gemm_route(
        x.data_ptr(), idx.data_ptr(), val.data_ptr(), out.data_ptr(), M, R,
        n, kcap, int(x.dtype == torch.bfloat16), ROUTES[route],
        _build.stream_of(dev)))
    return out


def qdq_gemm(x: torch.Tensor, levels: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """``y = x @ (levels * scale).T`` with the dequantize fused.

    x: [M, n] float32 or bfloat16; levels: int8 [R, n] QSGD levels
    (sign * xi), n a multiple of 4; scale: float32 [R, 1] per-row scale
    (||w_row|| / s).  Returns [M, R] float32.
    """
    _build.check_tensor("x", x, 2, _X_DTYPES)
    _build.check_tensor("levels", levels, 2, (torch.int8,))
    _build.check_tensor("scale", scale, 2, (torch.float32,))
    M, n = x.shape
    R = levels.shape[0]
    if levels.shape[1] != n:
        raise ValueError(f"x has {n} features, levels rows have "
                         f"{levels.shape[1]}")
    if tuple(scale.shape) != (R, 1):
        raise ValueError(f"scale must be [{R}, 1], got {tuple(scale.shape)}")
    dev = _build.device_of(x, levels, scale)
    count("qdq_gemm", M=M, n=n, R=R, x_bytes=x.element_size())
    if dev.type == "meta":
        return torch.empty((M, R), dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return ref.qdq_gemm_ref(x, levels, scale)
    if n % 4 or levels.data_ptr() % 4:
        raise ValueError(f"qdq_gemm reads levels 4 at a time: row length "
                         f"{n} is not a multiple of 4 or the levels are "
                         f"not 4-byte aligned")
    if n > QDQ_MAX_ROW:
        raise ValueError(f"qdq_gemm stages a row of x in shared memory: at "
                         f"most {QDQ_MAX_ROW} features, got {n}")
    lib = _build.load()
    out = torch.empty((M, R), dtype=torch.float32, device=dev)
    _build.check(lib.qs_qdq_gemm(
        x.data_ptr(), levels.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, R, n, int(x.dtype == torch.bfloat16), _build.stream_of(dev)))
    return out
