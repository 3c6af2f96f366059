#!/usr/bin/env python3
"""Expert parallelism of the MoE family alone on one card.

    python3 tools/check_ep.py

Runs ``chip_smoke.py``'s expert-parallel phase by itself: the kernels
built, the dry run's records of EP's cell at ``1x2`` on the ``meta``
device, the ``1x1`` twins and the whole model's first-step gradient in
this process (``ep_twins``), the two gloo ranks (``ep_ranks``), then
``phase_ep``'s checks and kernel checks.  Fails where ``phase_ep`` does;
prints the card, each part's seconds and ``phase_ep``'s lines.  Needs
one GPU.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("check_ep: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    print(cs.card(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    print(f"built in {time.perf_counter() - t0:.1f}s", flush=True)
    dev = torch.device("cuda")
    from repro_torch.kernels import autotune
    dry = cs.timed_phase(cs.ep_dry_records)
    tmp = tempfile.mkdtemp(dir=os.path.join(cs.SRC, "repro_torch",
                                            "kernels", "build"))
    try:
        # the tuning table (empty: the runs are untuned) in the temporary
        # directory, as chip_smoke.py keeps it for its run
        autotune.configure(tmp)
        grads = os.path.join(tmp, "grads.pt")
        twins = cs.timed_phase(cs.ep_twins, dev, grads)
        ranks = cs.timed_phase(cs.ep_ranks, grads)
        cs.timed_phase(cs.phase_ep, dev, dry, twins, ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"check_ep: {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
