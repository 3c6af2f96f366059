#!/usr/bin/env python3
"""Where a serving step's time goes in the PyTorch/CUDA port, on one
GPU.

    python3 tools/profile_torch_serve.py [--config yi-6b|gemma3-1b-unscanned]
        [--layout paged|paged-int8|contiguous] [--prefill] [--eager]

Builds one of ``chip_smoke.py``'s serving configurations at full width
and depth (random bf16 weights, compressed at load under ``lm_hetero``,
the kernels on): Yi-6B at batch 8 (``--layout`` picks the KV layout), or
gemma3-1b unscanned at batch 4, contiguous, whose prefill runs the
flash-attention kernel.  Admits the first batch and takes a few warm-up
steps (the engine's CUDA graphs are captured there), then profiles
``--steps`` decode steps that admit nothing under ``torch.profiler``;
with ``--prefill`` it profiles ``--steps`` admissions of one
``prompt_pad``-token prompt instead (the engine's admission, into the
slot or pages of its last one; the engine is not stepped after).  The
engine runs graphed (its default on the card); ``--eager`` runs the same
calls eagerly (``cuda_graphs=False``).  Prints each profiled call's host
time, the device time of the kernels that ran in it and the device's
busy share, then the operators that take the most device and host time.
Needs a CUDA device.
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
    ap.add_argument("--config", default="yi-6b",
                    choices=["yi-6b", "gemma3-1b-unscanned"])
    ap.add_argument("--layout", default="paged", choices=sorted(LAYOUTS))
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--eager", action="store_true")
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
    if args.config == "yi-6b":
        spec, arch = cs.SERVE, "yi-6b"
        cfg = dataclasses.replace(get_config(arch), use_pallas=True)
        layout = dict(LAYOUTS[args.layout])
        if layout:
            layout["page_size"] = spec["page_size"]
    else:
        spec, arch = cs.FLASH_SERVE, cs.FLASH_SERVE["arch"]
        cfg = dataclasses.replace(get_config(arch), use_pallas=True,
                                  scan_layers=False)
        layout, args.layout = {}, "contiguous"
    params = sc.compress_tree(
        tf.init_params(torch.Generator(device=dev).manual_seed(
            spec["seed"]), cfg, device=dev),
        get_policy_preset("arch", arch))
    torch.cuda.empty_cache()
    dispatch = DispatchConfig(mode="auto")
    eng = ServeEngine(params, cfg, max_batch=spec["max_batch"],
                      max_len=spec["max_len"],
                      prompt_pad=spec["prompt_pad"], dispatch=dispatch,
                      cuda_graphs=not args.eager, **layout)
    cs.serve_requests(eng, cfg.vocab, spec)
    for _ in range(3):               # admits the first batch, warms up
        eng.step()
    eng._adm_toks.copy_(torch.randint(
        0, cfg.vocab, (1, spec["prompt_pad"]), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1)))

    def call():
        if args.prefill:
            eng._admit_call()        # the engine's admission, as it runs
            torch.cuda.synchronize()
        else:
            eng.step()               # ends in a copy of the next tokens

    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = eng.admissions
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(args.steps):
            with torch.profiler.record_function(f"step {i}"):
                call()
    if eng.admissions != before:
        raise AssertionError("a profiled step admitted a request")
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    steps = [e for e in evs if e.name.startswith("step ")
             and e.device_type != cuda]
    kernels = [e for e in evs if e.device_type == cuda
               and not e.name.startswith("step ")]
    what = (f"admission of {spec['prompt_pad']} tokens" if args.prefill
            else "decode step")
    mode = "eager" if args.eager else f"graphed, captures {eng.captures}"
    print(f"{args.config}, layout {args.layout}, {mode}: per {what}, host "
          f"ms and the device time of the kernels that ran in it")
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
