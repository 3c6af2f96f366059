"""Kernel-launch accounting, shared by all kernel families.

The keys are ``repro.kernels.launch_stats.LAUNCHES``'s, plus
``flash_attention``: ``repro`` never counts its prefill kernel, the port
does.  Each wrapper adds one per call, where it launches its CUDA kernel
(or, for a tensor on the CPU, runs the kernel's plain version in its
place), so a run can show that its main path went through the kernels:
reset, run, read.  PyTorch runs eagerly, so a count here is a count of
launches, where ``repro`` counts ``pallas_call`` sites at trace time.

A wrapper counts through :func:`count`, which also hands the launch's
shape to the :data:`SINK`, where one is set: the dry run
(``launch/dryrun.py``) sets it to add each launch's bytes and operations
(``launch/roofline.py``'s ``kernel_cost``) to its record, on the ``meta``
device and on the card alike.  A CUDA-graph replay repeats the counts
(``graphs.add_counts``) but not the sink's calls.
"""

from __future__ import annotations

from typing import Callable, Optional

LAUNCHES = {"topk_compress": 0, "topk_compact": 0, "qsgd": 0,
            "sparse_gemm": 0, "qdq_gemm": 0, "flash_decode": 0,
            "paged_decode": 0, "flash_attention": 0}

#: serving page-pool gauges, refreshed by ``ServeEngine.step()`` when the
#: paged KV runtime is active: pages used / free and peak, internal
#: fragmentation (1 - live_tokens / (used_pages * page_size)),
#: preemptions (recompute-from-start evictions) and admission stalls
#: (queue head blocked on pages, not slots).
PAGE_POOL = {"pages_used": 0, "pages_free": 0, "peak_pages_used": 0,
             "fragmentation": 0.0, "preemptions": 0, "admission_stalls": 0}

#: tuning-table resolutions (kernels/autotune.py ``lookup``): ``hit`` — the
#: LRU held the launch's entry, ``miss`` — the table had to be consulted.
#: Counted once per dispatch call that resolves a geometry with
#: ``block_rows`` left on auto: an eager run looks up at every call, a
#: graphed round only when it is captured.
TUNE_CACHE = {"hit": 0, "miss": 0}


#: where :func:`count` sends each launch as ``(kernel, shape)``: None (the
#: default) or a callable the dry run sets for the time of a step
SINK: Optional[Callable[[str, dict], None]] = None


def count(kernel: str, **shape) -> None:
    """One launch of ``kernel`` (a ``LAUNCHES`` key) with ``shape``, the
    arguments of ``roofline.kernel_cost`` for it."""
    LAUNCHES[kernel] += 1
    if SINK is not None:
        SINK(kernel, shape)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def reset_tune_cache() -> None:
    for k in TUNE_CACHE:
        TUNE_CACHE[k] = 0


def reset_page_pool() -> None:
    for k in PAGE_POOL:
        PAGE_POOL[k] = 0.0 if k == "fragmentation" else 0


def total_launches() -> int:
    return sum(LAUNCHES.values())
