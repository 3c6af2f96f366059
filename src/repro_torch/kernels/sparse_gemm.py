"""The compressed-weight serving GEMMs (``repro``'s
``kernels/sparse_gemm.py``: ``sparse_gemm`` and ``qdq_gemm``),
hand-written in CUDA C++ for Hopper (``csrc/sparse_gemm.cu``).

A CUDA tensor launches the kernel on the current stream; a CPU tensor
runs the kernel's plain version (``ref.sparse_gemm_ref`` /
``ref.qdq_gemm_ref``).  There is no other route: a failed build or
launch raises.  Both count one launch per call in ``LAUNCHES``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES

_X_DTYPES = (torch.float32, torch.bfloat16)


def sparse_gemm(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                row_len: int) -> torch.Tensor:
    """``y[m, r] = sum_s val[r, s] * x[m, idx[r, s]]``.

    x: [M, row_len] float32 or bfloat16 activations; idx int32 / val
    float32: [R, kcap] compact survivor buffers, each row's indices
    ascending with the out-of-row sentinel ``idx = row_len, val = 0``
    after its survivors (the layout ``serve.compressed`` builds).
    Returns [M, R] float32.
    """
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
    LAUNCHES["sparse_gemm"] += 1
    if dev.type == "cpu":
        return ref.sparse_gemm_ref(x, idx, val, row_len)
    lib = _build.load()
    out = torch.empty((M, R), dtype=torch.float32, device=dev)
    _build.check(lib.qs_sparse_gemm(
        x.data_ptr(), idx.data_ptr(), val.data_ptr(), out.data_ptr(), M, R,
        n, kcap, int(x.dtype == torch.bfloat16), _build.stream_of(dev)))
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
    LAUNCHES["qdq_gemm"] += 1
    if dev.type == "cpu":
        return ref.qdq_gemm_ref(x, levels, scale)
    if n % 4:
        raise ValueError(f"qdq_gemm reads levels 4 at a time: row length "
                         f"{n} is not a multiple of 4")
    lib = _build.load()
    out = torch.empty((M, R), dtype=torch.float32, device=dev)
    _build.check(lib.qs_qdq_gemm(
        x.data_ptr(), levels.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, R, n, int(x.dtype == torch.bfloat16), _build.stream_of(dev)))
    return out
