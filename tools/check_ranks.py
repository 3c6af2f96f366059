#!/usr/bin/env python3
"""One model-parallel job of ``chip_smoke.py`` alone on one card.

    python3 tools/check_ranks.py tp|ep|tp_ssm [...]

Runs ``chip_smoke.py``'s ``phase_ranks`` for each job named
(``RANK_JOBS``: ``tp`` the dense family's tensor parallelism, ``ep`` the
MoE family's expert parallelism, ``tp_ssm`` the RWKV-6 / Zamba2 tensor
parallelism) by itself: the kernels built, the dry run's records of the
job's cell at ``1x2`` on the ``meta`` device, the ``1x1`` twins and the
whole model's first-step gradient in this process (``rank_twins``), the
two gloo ranks (``rank_runs``), then the phase's checks and kernel
checks.  Fails where the phase does; prints the card, each part's
seconds and the phase's lines.  Needs one GPU.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main(names: list) -> int:
    import torch
    import chip_smoke as cs
    if not names or not set(names) <= set(cs.RANK_JOBS):
        print(f"usage: check_ranks.py {'|'.join(cs.RANK_JOBS)} ...",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("check_ranks: needs a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, autotune
    print(cs.card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp(dir=os.path.join(cs.SRC, "repro_torch",
                                            "kernels", "build"))
    try:
        # the tuning table (empty: the runs are untuned) in the temporary
        # directory, as chip_smoke.py keeps it for its run
        autotune.configure(tmp)
        for name in names:
            dry = cs.timed_phase(cs.rank_dry_records, name,
                                 name=f"{name}_dry_records")
            grads = os.path.join(tmp, name + "_{arch}.pt")
            twins = cs.timed_phase(cs.rank_twins, dev, name, grads,
                                   name=f"{name}_twins")
            ranks = cs.timed_phase(cs.rank_runs, name, grads,
                                   name=f"{name}_ranks")
            cs.timed_phase(cs.phase_ranks, dev, name, dry, twins, ranks,
                           name=f"phase_{name}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"check_ranks: {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
