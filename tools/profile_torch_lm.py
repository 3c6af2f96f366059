#!/usr/bin/env python3
"""Where a distributed LM training round's time goes in the PyTorch/CUDA
port, on one GPU.

    python3 tools/profile_torch_lm.py [--wire sparse_allgather|dense_psum]
        [--runtime round|step]

Builds ``chip_smoke.py``'s LM training run through the launcher's own
set-up (gemma3-1b at full width and depth, random bf16 weights,
``lm_hetero``, R = 1, batch 2 of 2048 tokens, H = 4), runs two rounds
(H - 1 local steps and a sync) to warm up, then profiles the next two
rounds under ``torch.profiler``: ``--runtime round`` (the default) as
the launcher's round program, each round one CUDA graph replay (its
first call runs eagerly, its second captures); ``--runtime step`` step
by step, eagerly, the loss read after each step as the launcher reads
it.  Prints each round's host time, the device time of the kernels that
ran in it and the device's busy share, then the operators that take the
most device time.  Needs a CUDA device.
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
    ap.add_argument("--runtime", default="round", choices=["round", "step"])
    args = ap.parse_args()

    import chip_smoke as cs
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    LM = cs.LM
    H = LM["H"]
    largs = lt.parser().parse_args(
        ["--arch", LM["arch"], "--mesh", "1x1", "--policy", "preset:arch",
         "--batch", str(LM["batch"]), "--seq", str(LM["seq"]),
         "--steps", str(4 * H), "--H", str(H), "--wire", args.wire,
         "--runtime", args.runtime])
    mesh = make_mesh(largs.mesh, device=largs.device)
    try:
        run = lt.setup(largs, lt.resolve_policy_arg(largs), mesh)
        state = run.state
        run.state = None
        if args.runtime == "round":
            from repro_torch.core.engine import stack_window
            host = list(run.host_batches())
            rounds = [stack_window(host[i:i + H], 1, H)
                      for i in range(0, len(host), H)]

            def one_round(state, r):
                state, losses, _ = run.round_fn(state, rounds[r], run.rng)
                losses.tolist()                       # synchronizes
                return state
        else:
            batches = list(run.batches())

            def one_round(state, r):
                for t in range(r * H, (r + 1) * H):
                    step = (run.sync_step if lt.is_sync(t, largs)
                            else run.local_step)
                    state, loss = step(state, batches[t], run.rng)
                    float(loss)                       # synchronizes
                return state
        for r in range(2):                            # warm-up (capture)
            state = one_round(state, r)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for r in (2, 3):
                with torch.profiler.record_function(f"round {r + 1}"):
                    state = one_round(state, r)
        captures = (run.round_fn.captures
                    if args.runtime == "round" else 0)
    finally:
        mesh.close()
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    steps = [e for e in evs if e.name.startswith("round ")
             and e.device_type != cuda]
    kernels = [e for e in evs if e.device_type == cuda
               and not e.name.startswith("round ")]
    print(f"wire {args.wire}, runtime {args.runtime} ({captures} "
          f"captures): host ms per round of {H} steps and the device time "
          f"of the kernels that ran in it")
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
