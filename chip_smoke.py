#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card's name and power limit; TF32 off for matmuls and cuDNN (the
   CPU tests run in full float32);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with times: the kernel, the plain
   version, one PyTorch library call for the same function where there
   is one (a yardstick only, never called by the port), and the bound
   (the larger of the bytes it must move over 3.35 TB/s and its float32
   operations over 67 TFLOP/s, the H100 SXM's published peaks);
4. the main path: ``train`` on ResNet-50 at full width (25,541,672
   parameters), R=8 workers, per-worker batch 8, 224x224 images, T=8,
   H=4, under RowSignTopK, TopK and QSGD, with the launch counts per
   sync; then a small ResNet on the card with dispatch "kernel" against
   dispatch "reference" (same losses, same wire bits).

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
R, B, T, H = 8, 8, 8, 4       # workers, per-worker batch, steps, local steps
IMAGES = {"n": 512, "hw": 224, "classes": 1000, "seed": 0}
N_PARAMS = 25_541_672         # ResNet-50 at full width, 1000 classes
DISPATCH = "auto"
#: the kernel each operator must launch, and how often per sync round
WANT_PER_SYNC = {"RowSignTopK": ("topk_compress", 1),
                 "TopK": ("topk_compress", 5), "QSGD": ("qsgd", 5)}


def model_config():
    from repro_torch.models import resnet
    return resnet.resnet50_config(num_classes=IMAGES["classes"])


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up,
    from CUDA events around the whole run."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_topk(dev, rows: int, n: int, k: int, sign: bool, reps: int):
    """topk_compress against its plain version: counts and survivor masks
    exactly, plain Top_k values and memory bit for bit, SignTop_k values
    within rtol 1e-6 (its norm is a float sum in another order)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_compress import topk_compress
    g = torch.Generator(device=dev).manual_seed(rows + n + k)
    x = torch.randn((rows, n), generator=g, device=dev)
    sel, mem, cnt = topk_compress(x, k, sign=sign)
    sel_r, mem_r, cnt_r = ref.topk_compress_ref(x, k, sign=sign)
    torch.cuda.synchronize()
    if not torch.equal(cnt, cnt_r):
        raise AssertionError(f"topk counts differ at {rows}x{n} k={k}")
    if not torch.equal(sel != 0, sel_r != 0):
        raise AssertionError(f"topk survivor masks differ at {rows}x{n}")
    err = max(float((sel - sel_r).abs().max()),
              float((mem - mem_r).abs().max()))
    if sign:
        torch.testing.assert_close(sel, sel_r, rtol=1e-6, atol=0)
        # memory = acc - sel: its error is sel's, absolute
        torch.testing.assert_close(
            mem, mem_r, rtol=1e-6, atol=1e-6 * float(sel_r.abs().max()))
    elif err != 0.0:
        raise AssertionError(f"topk values differ by {err} at {rows}x{n}")
    del sel, mem, cnt, sel_r, mem_r, cnt_r
    ms = time_ms(lambda: topk_compress(x, k, sign=sign), reps)
    plain_ms = time_ms(lambda: ref.topk_compress_ref(x, k, sign=sign),
                       max(1, reps // 4))
    library_ms = time_ms(lambda: torch.topk(x.abs(), k, dim=1), reps)
    iters = 24
    elems = rows * n
    bms, by = bound_ms(12.0 * elems + 4.0 * rows,
                       3.0 * (iters + 4) * elems)
    return {"shape": [rows, n], "k": k, "sign": sign, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by}


def check_qsgd(dev, rows: int, n: int, s: int, reps: int):
    """qsgd_quantize against its plain version on shared uniforms: within
    rtol 1e-6 except at most 16 elements, which may sit one level
    (norm/s) apart where u lies within rounding of the fraction."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.qsgd import qsgd_quantize
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = torch.randn((rows, n), generator=g, device=dev)
    u = torch.rand((rows, n), generator=g, device=dev)
    out = qsgd_quantize(x, u, s)
    out_r = ref.qsgd_bucketed_ref(x, u, s)
    torch.cuda.synchronize()
    far = ~torch.isclose(out, out_r, rtol=1e-6, atol=0)
    level = torch.sqrt((x * x).sum(dim=1, keepdim=True)) / s
    off_by_level = torch.isclose((out - out_r).abs(), level.expand_as(out),
                                 rtol=1e-4, atol=0)
    n_far = int(far.sum())
    if n_far > 16 or not bool(off_by_level[far].all()):
        raise AssertionError(f"qsgd differs at {n_far} elements "
                             f"({rows}x{n})")
    err = float((out - out_r).abs().max())
    ms = time_ms(lambda: qsgd_quantize(x, u, s), reps)
    plain_ms = time_ms(lambda: ref.qsgd_bucketed_ref(x, u, s), reps)
    bms, by = bound_ms(12.0 * rows * n, 12.0 * rows * n)
    return {"shape": [rows, n], "s": s, "max_abs_err": err,
            "mismatched_levels": n_far, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bms, "bound_by": by}


def phase_kernels(dev):
    """The shapes of the ResNet-50 main path at R=8 (all workers' rows of
    a bucket share one launch): RowSignTopK's one bucket of 6164 rows of
    4096 per worker, k=41; global TopK's longest bucket (2 leaves of
    512Ki) and its 64Ki bucket (7 leaves); QSGD's same two buckets; plus
    single-worker shapes."""
    topk = [check_topk(dev, R * 6164, 4096, 41, False, 10),
            check_topk(dev, R * 6164, 4096, 41, True, 10),
            check_topk(dev, R * 2, 524288, 5243, False, 5),
            check_topk(dev, 8, 524288, 5243, False, 5),
            check_topk(dev, R * 7, 65536, 655, False, 10),
            check_topk(dev, 8, 65536, 655, False, 10)]
    qsgd = [check_qsgd(dev, R * 2, 524288, 15, 10),
            check_qsgd(dev, R * 7, 65536, 15, 10),
            check_qsgd(dev, 1, 524288, 15, 10),
            check_qsgd(dev, 7, 65536, 15, 10)]
    for row in topk + qsgd:
        print("kernel check", json.dumps(row), flush=True)
    return topk, qsgd


class StepClock:
    """Wraps the batch stream: the trainer reads the loss and the ledger
    (a device sync) at the end of every step before it asks for the next
    batch, so the time between two requests is one step."""

    def __init__(self, batches):
        self.batches = batches
        self.marks: list = []

    def __iter__(self):
        import torch
        for b in self.batches:
            torch.cuda.synchronize()
            self.marks.append(time.perf_counter())
            yield b
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def phase_train(dev):
    import numpy as np
    import torch
    from repro_torch.core.operators import QSGDQuantizer, RowSignTopK, TopK
    from repro_torch.core.schedule import fixed_schedule
    from repro_torch.data import make_image_data, worker_batches
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import resnet
    from repro_torch.optim import momentum_sgd, piecewise_decay
    from repro_torch.train import RunConfig, train
    from repro_torch.tree import tree_leaves, value_and_grad

    cfg = model_config()
    params = resnet.init_params(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"resnet50 parameters {n_params} in "
          f"{len(tree_leaves(params))} leaves", flush=True)
    if n_params != N_PARAMS:
        raise AssertionError(f"ResNet-50 has {n_params} parameters")
    t0 = time.perf_counter()
    x, y = make_image_data(**IMAGES)
    print(f"data {x.shape} made in {time.perf_counter() - t0:.1f}s",
          flush=True)
    grad_fn = value_and_grad(lambda p, b: resnet.loss_fn(p, b, cfg)[0])
    n_syncs = int(fixed_schedule(T, H).sum())
    totals = {k: 0 for k in LAUNCHES}
    runs = []
    for name, op in (("RowSignTopK", RowSignTopK(k=0.01, row_len=4096, m=2)),
                     ("TopK", TopK(k=0.01)),
                     ("QSGD", QSGDQuantizer(s=15))):
        run = RunConfig(total_steps=T, R=R, H=H, runtime="step",
                        dispatch=DISPATCH, log_every=1, seed=0)
        clock = StepClock(worker_batches(x, y, R, B, T, seed=1,
                                         feature_key="images"))
        reset_launches()
        state, hist = train(grad_fn, params, momentum_sgd(0.9), op,
                            piecewise_decay(0.05, [100, 130]), clock, run,
                            smooth=1, device=dev)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        for k, v in launches.items():
            totals[k] += v
        mask = fixed_schedule(T, H)
        step_ms = clock.step_ms()
        local = [ms for ms, s in zip(step_ms, mask) if not s]
        sync = [ms for ms, s in zip(step_ms, mask) if s]
        row = {"operator": name, "loss": hist.loss, "bits_up": hist.bits,
               "bits_down": hist.bits_down, "rounds": hist.rounds[-1],
               "ms_per_step": step_ms,
               "ms_per_local_step": float(np.mean(local[1:] or local)),
               "ms_per_sync_step": float(np.mean(sync)),
               "launches": {k: v for k, v in launches.items() if v}}
        print("train", json.dumps(row), flush=True)
        if not all(np.isfinite(hist.loss)):
            raise AssertionError(f"{name}: loss not finite: {hist.loss}")
        kern, per_sync = WANT_PER_SYNC[name]
        if launches[kern] != per_sync * n_syncs:
            raise AssertionError(
                f"{name}: {launches[kern]} {kern} launches in {n_syncs} "
                f"syncs, want {per_sync} per sync")
        for leaf in tree_leaves((state.master, state.local, state.memory,
                                 state.master_view, state.inner)):
            if leaf.device.type != dev.type:
                raise AssertionError(f"{name}: state tensor on {leaf.device}")
        if hist.bits[-1] <= 0 or hist.rounds[-1] != n_syncs:
            raise AssertionError(f"{name}: ledger {hist.bits[-1]} bits, "
                                 f"{hist.rounds[-1]} rounds")
        runs.append(row)
        del state
    return runs, totals


def phase_small_agreement(dev):
    """The trainer on a small ResNet on the card: dispatch "kernel" (every
    eligible leaf through the CUDA kernels) against "reference" (the
    dense operators, torch.topk): identical wire bits and rounds, losses
    within rtol 1e-4."""
    import numpy as np
    import torch
    from repro_torch.core.operators import RowSignTopK, TopK
    from repro_torch.data import make_image_data, worker_batches
    from repro_torch.models import resnet
    from repro_torch.optim import constant, momentum_sgd
    from repro_torch.train import RunConfig, train
    from repro_torch.tree import value_and_grad

    cfg = resnet.ResNetConfig(stage_sizes=(1, 1), bottleneck=True, width=8,
                              num_classes=10, stem_stride=2)
    params = resnet.init_params(torch.Generator().manual_seed(1), cfg,
                                device=dev)
    x, y = make_image_data(n=64, hw=16, classes=10, seed=2)
    grad_fn = value_and_grad(lambda p, b: resnet.loss_fn(p, b, cfg)[0])
    for op in (RowSignTopK(k=0.05, row_len=128, m=2), TopK(k=0.05)):
        hists = {}
        for mode in ("kernel", "reference"):
            run = RunConfig(total_steps=4, R=2, H=2, runtime="step",
                            dispatch=mode, log_every=1)
            _, hists[mode] = train(
                grad_fn, params, momentum_sgd(0.9), op, constant(0.05),
                worker_batches(x, y, 2, 4, 4, seed=3, feature_key="images"),
                run, device=dev)
        k, r = hists["kernel"], hists["reference"]
        if k.bits != r.bits or k.rounds != r.rounds:
            raise AssertionError(f"{type(op).__name__}: ledgers differ "
                                 f"{k.bits} vs {r.bits}")
        np.testing.assert_allclose(k.loss, r.loss, rtol=1e-4)
        print(f"small agreement {type(op).__name__}: bits {k.bits} "
              f"losses {k.loss}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "kernels", "csrc")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import _build

    name_power = card()
    print(name_power, flush=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    lib = _build.build()
    if not lib.startswith(os.path.join(SRC, "repro_torch", "kernels")):
        raise AssertionError(f"kernel library {lib} outside the checkout")
    print(f"built {[os.path.relpath(s, HERE) for s in _build.sources()]} "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)

    topk, qsgd = phase_kernels(dev)
    runs, totals = phase_train(dev)
    phase_small_agreement(dev)

    head_topk, head_qsgd = topk[1], qsgd[0]
    kernels = [
        {"name": "topk_compress", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
         "replaces": "src/repro/kernels/topk_compress.py:86",
         "launches": totals["topk_compress"], **{
             k: head_topk[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
         "shape": head_topk["shape"]},
        {"name": "qsgd_quantize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qsgd.cu",
         "replaces": "src/repro/kernels/qsgd.py:36",
         "launches": totals["qsgd"], **{
             k: head_qsgd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
         "shape": head_qsgd["shape"]},
    ]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
