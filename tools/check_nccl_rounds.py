#!/usr/bin/env python3
"""The distributed LM launcher's round runtime over NCCL, one rank a GPU.

    python3 tools/check_nccl_rounds.py [--ranks 4] [--scenario preset:dropout]

Runs ``repro_torch.launch.train`` on the gemma3-1b smoke model at
``--mesh Nx1`` with the NCCL backend, ``chip_smoke.py``'s LM_RANKS steps
and H, on both wires, under ``--runtime round`` (the default) and
``--runtime step`` (eager).  Across several NCCL ranks the round runtime
is the per-step composition (``core.distributed.round_fused``): fails
unless it reports ``fused`` False and its record (losses, kinds, bits
up and down, launches per sync) and final master equal the step
runtime's.  Prints each run's ms a step and ms a round.  With
``--scenario SPEC`` it then runs both wires again under that fleet
scenario (partial participation on the mesh, ``--aggregate mean_S``).
Needs N GPUs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--scenario", default=None,
                    help="also run under this fleet scenario")
    args = ap.parse_args()
    if torch.cuda.device_count() < args.ranks:
        print(f"needs {args.ranks} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint
    from repro_torch.tree import tree_leaves

    print(cs.card(), flush=True)
    _build.build()                  # once, before the ranks load it
    like = tf.init_params(torch.Generator().manual_seed(0),
                          get_config(cs.LM["arch"], smoke=True), device="cpu")
    build = os.path.join(cs.SRC, "repro_torch", "kernels", "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        cells = [(wire, ()) for wire in ("sparse_allgather", "dense_psum")]
        if args.scenario:
            cells += [(wire, ("--scenario", args.scenario, "--aggregate",
                              "mean_S"))
                      for wire in ("sparse_allgather", "dense_psum")]
        for wire, extra in cells:
            name = wire + (f" {args.scenario}" if extra else "")
            tag = wire + ("_scn" if extra else "")
            runs = {rt: cs._rank_run(tmp, f"{tag}_{rt}", wire, "kernel", rt,
                                     backend="nccl", ranks=args.ranks,
                                     extra=extra)
                    for rt in ("round", "step")}
            g, e = runs["round"], runs["step"]
            if g["fused"] is not False or g.get("captures") != 0:
                raise AssertionError(f"{name}: fused {g['fused']}, captures "
                                     f"{g.get('captures')}")
            for key in ("loss", "kind", "bits_up", "bits_down",
                        "launches_per_sync"):
                if g[key] != e[key]:
                    raise AssertionError(f"{name}: {key} differs between "
                                         "the runtimes")
            a = tree_leaves(checkpoint.restore(g["ckpt"], like))
            b = tree_leaves(checkpoint.restore(e["ckpt"], like))
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{name}: masters differ")
            H = cs.LM_RANKS["H"]
            print(f"nccl rounds {name}: R = {args.ranks}, round runtime "
                  "(per-step composition) equals --runtime step (record "
                  "and master); " + json.dumps({
                      "round_ms_per_step_median":
                          float(np.median(g["ms"][2 * H:])),
                      "step_ms_per_step_median":
                          float(np.median(e["ms"][2 * H:])),
                      "round_ms": g["round_ms"],
                      "kind": g["kind"],
                      "bits_up": g["bits_up"][-1]}), flush=True)
    print(json.dumps({"ok": True, "ranks": args.ranks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
