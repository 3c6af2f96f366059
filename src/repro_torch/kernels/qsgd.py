"""Bucketed QSGD stochastic quantization (``repro``'s
``kernels/qsgd.py::qsgd_quantize``), hand-written in CUDA C++ for
Hopper (``csrc/qsgd.cu``).  The uniforms are an operand, so the kernel
is deterministic given its inputs."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.launch_stats import LAUNCHES
from repro_torch.kernels.topk_compress import _check_rows


def qsgd_quantize(x: torch.Tensor, u: torch.Tensor, s: int) -> torch.Tensor:
    """x, u: [buckets, n] float32 -> dequantized [buckets, n] float32.

    A CUDA tensor launches the kernel on the current stream; a CPU
    tensor runs the plain version (``ref.qsgd_bucketed_ref``).  There is
    no other route: a failed build or launch raises.
    """
    _check_rows("x", x)
    _check_rows("u", u)
    if u.shape != x.shape or u.device != x.device:
        raise ValueError(f"u {tuple(u.shape)} on {u.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")
    if int(s) < 1:
        raise ValueError(f"s={s} must be >= 1")
    LAUNCHES["qsgd"] += 1
    if x.device.type == "cpu":
        return ref.qsgd_bucketed_ref(x, u, s)
    if x.device.type != "cuda":
        raise RuntimeError(f"qsgd_quantize: unsupported device {x.device}")
    lib = _build.load()
    out = torch.empty_like(x)
    rows, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.qs_qsgd_quantize_f32(
            x.data_ptr(), u.data_ptr(), out.data_ptr(), rows, n, int(s),
            stream))
    return out
