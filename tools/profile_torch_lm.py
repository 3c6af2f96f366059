#!/usr/bin/env python3
"""Where a distributed LM training step's time goes in the PyTorch/CUDA
port, on one GPU.

    python3 tools/profile_torch_lm.py [--wire sparse_allgather|dense_psum]

Builds ``chip_smoke.py``'s LM training run through the launcher's own
set-up (gemma3-1b at full width and depth, random bf16 weights,
``lm_hetero``, R = 1, batch 2 of 2048 tokens, H = 4), takes one local
and one sync step to warm up, then profiles the next local step and the
sync step after it under ``torch.profiler``.  Prints each step's host
time, the device time of the kernels that ran in it and the device's
busy share, then the operators that take the most device time.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--wire", default="sparse_allgather",
                    choices=["sparse_allgather", "dense_psum"])
    args = ap.parse_args()

    import chip_smoke as cs
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    LM = cs.LM
    largs = lt.parser().parse_args(
        ["--arch", LM["arch"], "--mesh", "1x1", "--policy", "preset:arch",
         "--batch", str(LM["batch"]), "--seq", str(LM["seq"]),
         "--steps", str(2 * LM["H"]), "--H", str(LM["H"]),
         "--wire", args.wire])
    mesh = make_mesh(largs.mesh, device=largs.device)
    try:
        run = lt.setup(largs, lt.resolve_policy_arg(largs), mesh)
        state, batches = run.state, list(run.batches())
        run.state = None
        kinds = ["sync" if lt.is_sync(t, largs) else "local"
                 for t in range(len(batches))]
        first_local = kinds.index("local", kinds.index("sync") + 1)
        last_sync = len(kinds) - 1
        for t in range(first_local):               # warm-up: local, sync
            step = run.sync_step if kinds[t] == "sync" else run.local_step
            state, loss = step(state, batches[t], run.rng)
        float(loss)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for t in (first_local, last_sync):
                step = run.sync_step if kinds[t] == "sync" else run.local_step
                with torch.profiler.record_function(f"step {kinds[t]}"):
                    state, loss = step(state, batches[t], run.rng)
                    float(loss)                       # synchronizes
    finally:
        mesh.close()
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    steps = [e for e in evs if e.name.startswith("step ")
             and e.device_type != cuda]
    kernels = [e for e in evs if e.device_type == cuda
               and not e.name.startswith("step ")]
    print(f"wire {args.wire}: host ms per step and the device time of the "
          f"kernels that ran in it")
    for st in sorted(steps, key=lambda e: e.time_range.start):
        mine = [k for k in kernels
                if st.time_range.start <= k.time_range.start
                < st.time_range.end]
        busy_us = sum(k.time_range.elapsed_us() for k in mine)
        host_us = st.time_range.elapsed_us()
        print(f"  {st.name}: host {host_us / 1e3:.2f} ms, device "
              f"{busy_us / 1e3:.2f} ms ({100 * busy_us / host_us:.1f} % "
              f"busy), {len(mine)} kernels")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
