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

#: serving page-pool gauges, refreshed by ``ServeEngine.step()`` when the
#: paged KV runtime is active: pages used / free and peak, internal
#: fragmentation (1 - live_tokens / (used_pages * page_size)),
#: preemptions (recompute-from-start evictions) and admission stalls
#: (queue head blocked on pages, not slots).
PAGE_POOL = {"pages_used": 0, "pages_free": 0, "peak_pages_used": 0,
             "fragmentation": 0.0, "preemptions": 0, "admission_stalls": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_page_pool() -> None:
    for k in PAGE_POOL:
        PAGE_POOL[k] = 0.0 if k == "fragmentation" else 0
