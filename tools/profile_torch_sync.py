#!/usr/bin/env python3
"""Where a sync step's time goes in the PyTorch/CUDA port, on one GPU.

    python3 tools/profile_torch_sync.py [--operator RowSignTopK|TopK|QSGD]

Runs ``chip_smoke.py``'s ResNet-50 configuration (R=8, per-worker batch
8, 224x224, dispatch "auto") for H=4 steps — three local steps and one
sync step — once to warm up and once under ``torch.profiler``.  Prints
the host time of each step, the device time summed over all kernels,
the device's busy share of the profiled window, and the operators that
take the most device and host time.  Needs a CUDA device.
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
    ap.add_argument("--operator", default="RowSignTopK",
                    choices=["RowSignTopK", "TopK", "QSGD"])
    args = ap.parse_args()

    import chip_smoke as cs
    from repro_torch.core.operators import QSGDQuantizer, RowSignTopK, TopK
    from repro_torch.data import make_image_data, worker_batches
    from repro_torch.models import resnet
    from repro_torch.optim import momentum_sgd, piecewise_decay
    from repro_torch.train import RunConfig, train
    from repro_torch.tree import value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    op = {"RowSignTopK": RowSignTopK(k=0.01, row_len=4096, m=2),
          "TopK": TopK(k=0.01), "QSGD": QSGDQuantizer(s=15)}[args.operator]
    cfg = cs.model_config()
    params = resnet.init_params(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    x, y = make_image_data(**cs.IMAGES)
    grad_fn = value_and_grad(lambda p, b: resnet.loss_fn(p, b, cfg)[0])

    class LabelledClock(cs.StepClock):
        """chip_smoke's step clock, with each step a profiler range."""

        def __iter__(self):
            for i, b in enumerate(super().__iter__()):
                with torch.profiler.record_function(f"step {i}"):
                    yield b

    def run_once():
        clock = LabelledClock(worker_batches(x, y, cs.R, cs.B, cs.H, seed=1,
                                             feature_key="images"))
        run = RunConfig(total_steps=cs.H, R=cs.R, H=cs.H, runtime="step",
                        dispatch="auto", log_every=1)
        train(grad_fn, params, momentum_sgd(0.9), op,
              piecewise_decay(0.05, [100, 130]), clock, run, smooth=1,
              device=dev)
        return clock.step_ms()

    print("warm-up step ms", run_once(), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step_ms = run_once()
    # each step ends in a device sync (the trainer reads the loss), so a
    # kernel that starts inside a step's host range ran in that step; the
    # step ranges themselves also appear on the device timeline, as
    # annotations, and are no kernels
    evs = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    steps = [e for e in evs if e.name.startswith("step ")
             and e.device_type != cuda]
    kernels = [e for e in evs if e.device_type == cuda
               and not e.name.startswith("step ")]
    print(f"operator {args.operator}: per step, host ms and the device "
          f"time of the kernels that ran in it")
    for st in sorted(steps, key=lambda e: e.time_range.start):
        busy_us = sum(k.time_range.elapsed_us() for k in kernels
                      if st.time_range.start <= k.time_range.start
                      < st.time_range.end)
        host_us = st.time_range.elapsed_us()
        print(f"  {st.name}: host {host_us / 1e3:.1f} ms, device "
              f"{busy_us / 1e3:.1f} ms ({100 * busy_us / host_us:.1f} % "
              f"busy)")
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    return 0


if __name__ == "__main__":
    sys.exit(main())
