"""Kernel-launch accounting, shared by all kernel families.

The keys are ``repro.kernels.launch_stats.LAUNCHES``'s.  Each wrapper
adds one per call, where it launches its CUDA kernel (or, for a tensor
on the CPU, runs the kernel's plain version in its place), so a run can
show that its main path went through the kernels: reset, run, read.
PyTorch runs eagerly, so a count here is a count of launches, where
``repro`` counts ``pallas_call`` sites at trace time.
"""

from __future__ import annotations

LAUNCHES = {"topk_compress": 0, "topk_compact": 0, "qsgd": 0,
            "sparse_gemm": 0, "qdq_gemm": 0, "flash_decode": 0,
            "paged_decode": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
