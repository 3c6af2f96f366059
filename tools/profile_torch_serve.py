#!/usr/bin/env python3
"""Where a serving decode step's time goes in the PyTorch/CUDA port, on
one GPU.

    python3 tools/profile_torch_serve.py [--layout paged|paged-int8|contiguous]

Builds ``chip_smoke.py``'s serving configuration (Yi-6B at full width and
depth, random bf16 weights, compressed at load under ``lm_hetero``,
batch 8, decode attention through the kernels), admits the first eight
requests and takes a few warm-up steps, then profiles ``--steps`` decode
steps that admit nothing under ``torch.profiler``.  Prints each step's
host time, the device time of the kernels that ran in it and the
device's busy share, then the operators that take the most device and
host time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), HERE]

LAYOUTS = {"paged": {"paged": True}, "paged-int8": {"paged": True,
                                                     "kv_quant": True},
           "contiguous": {}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", default="paged", choices=sorted(LAYOUTS))
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()

    import chip_smoke as cs
    from repro_torch.configs import get_config, get_policy_preset
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serve import compressed as sc
    from repro_torch.serve.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("yi-6b"), use_pallas=True)
    params = sc.compress_tree(
        tf.init_params(torch.Generator(device=dev).manual_seed(
            cs.SERVE["seed"]), cfg, device=dev),
        get_policy_preset("arch", "yi-6b"))
    torch.cuda.empty_cache()
    layout = dict(LAYOUTS[args.layout])
    if layout:
        layout["page_size"] = cs.SERVE["page_size"]
    eng = ServeEngine(params, cfg, max_batch=cs.SERVE["max_batch"],
                      max_len=cs.SERVE["max_len"],
                      prompt_pad=cs.SERVE["prompt_pad"],
                      dispatch=DispatchConfig(mode="auto"), **layout)
    cs.serve_requests(eng, cfg.vocab)
    for _ in range(3):               # admits the first batch, warms up
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = eng.admissions
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps):
            with torch.profiler.record_function(f"step {i}"):
                eng.step()           # ends in a copy of the next tokens
    if eng.admissions != before:
        raise AssertionError("a profiled step admitted a request")
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    steps = [e for e in evs if e.name.startswith("step ")
             and e.device_type != cuda]
    kernels = [e for e in evs if e.device_type == cuda
               and not e.name.startswith("step ")]
    print(f"layout {args.layout}: per decode step, host ms and the device "
          f"time of the kernels that ran in it")
    for st in sorted(steps, key=lambda e: e.time_range.start):
        mine = [k for k in kernels
                if st.time_range.start <= k.time_range.start
                < st.time_range.end]
        busy_us = sum(k.time_range.elapsed_us() for k in mine)
        host_us = st.time_range.elapsed_us()
        print(f"  {st.name}: host {host_us / 1e3:.2f} ms, device "
              f"{busy_us / 1e3:.2f} ms ({100 * busy_us / host_us:.1f} % "
              f"busy), {len(mine)} kernels")
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
