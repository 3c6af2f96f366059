#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card's name and power limit; TF32 off for matmuls and cuDNN (the
   CPU tests run in full float32);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with device times (torch.profiler,
   or CUDA events where the profiler records no device activity):
   the kernel, the plain version, one PyTorch library call for the same
   function where there is one (a yardstick only, never called by the
   port), and the bound (the larger of the bytes it must move over
   3.35 TB/s and its operations over the peak for their type: 67
   TFLOP/s float32, 989 TFLOP/s for the bf16 tensor-core attention; the
   H100 SXM's published peaks);
4. the training path: ``train`` on ResNet-50 at full width (25,541,672
   parameters), R=8 workers, per-worker batch 8, 224x224 images, T=12,
   H=4, under RowSignTopK, TopK and QSGD, each twice under cuDNN's
   deterministic algorithms: the round runtime (the default; each round
   one CUDA graph captured at round 2, round 3 a pure replay) and
   ``runtime="step"`` (eager), with the same History, launches and
   master, ms a round and a step and peak memory for both; RowSignTopK
   also under cuDNN's default algorithms for the times, T=20 (the median
   over rounds 3-5); then a small
   ResNet on the card with dispatch "kernel" against dispatch
   "reference" (same losses, same wire bits); then the paper's two
   algorithm wrappers on ResNet-50 at the same width (T=4, H=2):
   RowSignTopK through ``qsparse.run`` with the per-group ledger and
   QSGD through ``async_qsparse.run`` on an ``async_schedule`` mask, each
   equal to ``engine.run`` on the same inputs in every state tensor and
   both ledgers, and each wrapper's ``run_rounds`` (graphed) equal to its
   ``run``, the group ledgers adding up to the totals, 1 and 5
   launches per sync; then the paper's convex problem (Section 5.2,
   softmax regression, d = 7850): ``topk_compress`` and
   ``qsgd_quantize`` against their plain versions at the shapes its
   dispatcher builds (15 rows of 7,840 and 10 floats zero-padded to 7936
   and 128 columns, k = 40 and 1, s = 15), then the quickstart's two
   methods (R=8, T=300) and bench_convex's TopK-SGD, EF-QSGD and QTop_k
   (R=15, T=400), each under dispatch "auto" and "kernel" (EF-QSGD's
   shared uniforms on the per-step runtime), and under "kernel" graphed
   against ``runtime="step"`` (the same History, one capture), TopK-SGD
   also overlapped (windows of 8 rounds), with bits, rounds, bits to
   the target loss and ms a round and a step; then Algorithm 2 at
   bench_async's sizes (TopK, R=15, T=400, H=4), the round runtime
   against ``runtime="step"`` (the same History and launches; captures
   the tail masks that repeat, at most ``engine.MAX_PROGRAMS``), with
   the schedule's distinct and repeated round shapes at H = 4 and 8;
   then fleet scenarios, the fault runtime and resume: ResNet-50 as
   above (deterministic cuDNN) under ``faults="preset:none"`` (equal to
   the fault-free RowSignTopK cell), ``preset:chaos`` with damped
   staleness and ``scenario="preset:flaky_fleet"`` (mean_S, TopK), each
   graphed and eager with the same History, ``round_blocks``, master,
   per-worker state, queue and launches, printing the queue's bytes,
   peak memory, captures and distinct fault-round shapes; a
   ``preset:crashy`` QSGD run writing full snapshots and a fresh run
   resumed from ``full_step_6`` (the whole run's History tail and final
   state); bench_scenarios' convex row (QTop_k, support_weighted, R =
   15, T = 150) at participation 1.0 (equal to the plain schedule) and
   0.5; Algorithm 2 with executed staleness (TopK, ``preset:delayed``):
   ``async_qsparse.run_faults`` = ``engine.run_faults`` =
   ``engine.run_fault_rounds``;
5. the serving path: the four serving kernels against their plain
   versions at Yi-6B's shapes (step 3's checks and times), then Yi-6B at
   full width and depth (random weights from a seed) compressed at load
   under its ``lm_hetero`` policy and served by ``ServeEngine`` three
   times -- paged with a bf16 pool, paged with int8 pages, contiguous --
   all through the decode-attention kernels, 16 requests of 64-128
   prompt tokens and 64 new tokens each, with the launch counts per
   step and the serving metrics.  Every serving run here and in steps 6
   and 8 runs the engine's decode step and admission as CUDA graphs (its
   default on the card) and then again eagerly (``cuda_graphs=False``)
   in this process: the same greedy tokens, launch counts and serving
   counters, one capture of each graph, both runs' step times and TTFTs
   printed.  Then the yi-6b smoke model in float32 served with dispatch
   "kernel" (graphed) against "reference" (eager; a graphed engine under
   it raises): the same tokens;
6. the unscanned serving path, whose prefill runs the flash-attention
   kernel: ``flash_attention`` against its plain version at gemma3-1b's
   prefill shapes (2048 tokens under the 1024 window and global, a
   ragged 1100) and Yi-6B's heads (step 3's checks and times, with
   ``scaled_dot_product_attention`` as the yardstick), and the gemma3-1b
   run's GEMMs at its shapes: ``sparse_gemm`` at a 2048-token prefill and
   at decode (batch 4, all five matrix shapes), ``qdq_gemm`` on the tied 262144 x 1152 head at
   decode and for a prefill's last token; then gemma3-1b at
   full width and depth, unscanned (``scan_layers=False,
   use_pallas=True``), compressed at load under ``lm_hetero`` and served
   contiguous by the continuous scheduler, 8 requests of 1100-2048
   prompt tokens padded to 2048 and 32 new tokens each, asserting 26
   ``flash_attention`` launches per admission, 26 ``flash_decode`` per
   decode step, 182 ``sparse_gemm`` and 1 ``qdq_gemm`` per step or
   prefill, no densify and finite logits; then the gemma3-1b and yi-6b
   smoke models unscanned with dispatch "kernel" against "reference"
   (logits within 1e-4, same tokens);
7. the distributed LM training path: ``topk_compact`` and
   ``topk_compress`` against their plain versions at gemma3-1b's shapes
   (each at every stack's rows: 179,712, 26,624 and 6,656)
   (step 3's checks and times), then the port's launcher
   ``repro_torch.launch.train`` on gemma3-1b at full width and depth
   (999,812,736 parameters, random weights from a seed) under its
   ``lm_hetero`` policy, R = 1 (``--mesh 1x1``, NCCL), batch 2 of 2048
   tokens, 12 steps at H = 4, on the ``sparse_allgather`` wire and on
   ``dense_psum``, each under ``--runtime round`` (the default: fused,
   one capture holding the wire's NCCL collectives) and ``--runtime
   step`` with the same record step by
   step, asserting 7 ``topk_compact`` / ``topk_compress`` launches per
   sync; gemma3-1b again under ``--scenario preset:dropout --aggregate
   mean_S`` (partial participation on the mesh), graphed against
   ``--runtime step``; then the gemma3-1b smoke model at R = 2 ranks
   sharing the card over gloo, spawned from here: dispatch "kernel"
   against "reference" (same losses, equal wire bits), the sparse wire
   against the dense one (masters within 1e-5), the round runtime
   (per-step fallback under gloo) against ``--runtime step`` (equal),
   and both wires under the same scenario (equal kinds and bits);
8. checkpoints from trainer to server, gemma3-1b at full width: step
   6's compressed unscanned tree, saved as a compact-v1 checkpoint as
   soon as step 6 has served it and then dropped, loaded by
   ``load_compact`` and served by a ServeEngine (step 6's greedy tokens,
   resident bytes equal, no densify, prefill through
   ``flash_attention``); then through ``launch/serve.py``'s ``main
   --checkpoint`` (layers stacked, as the arch config says): step 7's
   dense-wire master (the launcher's ``--ckpt``) served with
   ``--compressed`` (tokens equal to compressing the restored master
   in-process), and that compressed tree saved as compact-v1 and served
   (tokens equal to an in-process engine on the same tree), with bytes
   on disk and seconds to save and to load.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
R, B, T, H = 8, 8, 12, 4      # workers, per-worker batch, steps, local steps
T_TIME = 20                   # steps of the ResNet-50 timing pair
IMAGES = {"n": 512, "hw": 224, "classes": 1000, "seed": 0}
N_PARAMS = 25_541_672         # ResNet-50 at full width, 1000 classes
DISPATCH = "auto"
#: the serving run: Yi-6B served from compressed weights
SERVE = {"max_batch": 8, "max_len": 512, "prompt_pad": 128, "page_size": 16,
         "requests": 16, "prompt_min": 64, "new_tokens": 64, "seed": 0}
#: the unscanned serving run: gemma3-1b, whose prefill runs the
#: flash-attention kernel (prompts past its 1024 window)
FLASH_SERVE = {"arch": "gemma3-1b", "max_batch": 4, "max_len": 2304,
               "prompt_pad": 2048, "requests": 8, "prompt_min": 1100,
               "new_tokens": 32, "seed": 0}
#: launches per decode step / per prefill on Yi-6B under lm_hetero: 7
#: Top_k matmuls in each of 32 layers, the QSGD head once, one decode
#: attention per layer
YI_LAYERS = 32
#: the LM training run: gemma3-1b at full size through the launcher
LM = {"arch": "gemma3-1b", "batch": 2, "seq": 2048, "steps": 12, "H": 4,
      "n_params": 999_812_736, "topk_stacks": 7}
#: the multi-rank agreement run: the gemma3-1b smoke model, ranks sharing
#: the one card over gloo
LM_RANKS = {"ranks": 2, "steps": 8, "H": 2}
#: the wrapper run: ResNet-50 as in the training run, a few steps at H = 2
WRAP = {"T": 4, "H": 2, "seed": 0}
#: float32 additions into a ResNet-50 ledger a sync, bounded above:
#: 161 leaves x 8 workers; the group and total ledgers may part by at
#: most this many roundings of 2^-24 each (about 1e-4 of the total)
WRAP_ADDS = 1700
#: the paper's convex runs (Section 5.2: softmax regression on mnist_like,
#: d = 7850 in two leaves of 7,840 and 10 floats, lr = 60 / (100 + t)):
#: the quickstart's two methods and bench_convex's methods that meet a
#: kernel rule (TopK-SGD, EF-QSGD) or draw as one does (QTop_k)
K_CONVEX = 40 / 7850.0
CONVEX = {
    "n": 4000, "b": 8, "target": 1.0, "leaves": (7840, 10),
    "methods": [
        {"name": "quickstart vanilla SGD", "op": "identity", "kw": {},
         "R": 8, "T": 300, "H": 1, "log_every": 50, "batch_seed": 1},
        {"name": "quickstart Qsparse-local SignTopK", "op": "signtopk",
         "kw": {"k": 0.01, "m": 1}, "R": 8, "T": 300, "H": 4,
         "log_every": 50, "batch_seed": 1},
        {"name": "topk_sgd", "op": "topk", "kw": {"k": K_CONVEX}, "R": 15,
         "T": 400, "H": 1, "log_every": 25, "batch_seed": 0,
         "kernel": "topk_compress", "per_sync": 2, "overlap": True},
        {"name": "ef_qsgd_4bit", "op": "qsgd", "kw": {"s": 15}, "R": 15,
         "T": 400, "H": 1, "log_every": 25, "batch_seed": 0,
         "kernel": "qsgd", "per_sync": 2},
        {"name": "qtopk_4bit", "op": "qtopk", "kw": {"k": K_CONVEX, "s": 15},
         "R": 15, "T": 400, "H": 1, "log_every": 25, "batch_seed": 0},
    ]}
#: Algorithm 2 on the convex problem at bench_async.py's sizes (TopK,
#: sync gaps U[1, H]); the round shapes are also counted at H = 8
ASYNC_CONVEX = {"R": 15, "T": 400, "H": 4, "shapes_at_H": (4, 8)}
#: how far "kernel" may sit from "auto" where their arithmetic differs
#: (largest relative gap over the log points, bits and smoothed loss);
#: each limit lies within 2-20x of the gaps measured on the H100
#: (TopK-SGD 5.1e-5 / 5.1e-3, EF-QSGD 5.4e-6 / 5.3e-7), which repeat
#: exactly from run to run
CONVEX_TOL = {"qsgd": {"bits": 1e-4, "loss": 1e-5},
              "topk": {"bits": 1e-4, "loss": 1e-2}}
#: serving gemma3-1b from checkpoints through launch/serve.py (layers
#: stacked): the LM run's dense master at short prompts, then its
#: compressed tree as compact-v1 at the unscanned run's prompt lengths
CKPT_SERVE = {"arch": "gemma3-1b", "smoke": False,
              "compact": {"max_batch": 4, "max_len": 2304,
                          "prompt_len": 2048, "new_tokens": 32,
                          "requests": 8},
              "dense": {"max_batch": 4, "max_len": 256, "prompt_len": 128,
                        "new_tokens": 16, "requests": 8}}
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


#: how the kernels were timed in this run: "profiler" until profiler
#: sessions miss device activity PROFILE_TRIES times in a row, then
#: "events" for the rest of it
TIMING = {"clock": "profiler"}
#: a profiler (CUPTI) session now and then records no device activity at
#: all, and later in a run some sessions record only some of the kernels
#: launched (6 or 8 of 10 once the training and serving phases have run):
#: so many sessions are tried before the run gives the profiler up
PROFILE_TRIES = 3


def _device_events(fn, reps: int) -> list:
    """The device activity (kernels, copies, memsets) of ``reps`` calls of
    ``fn`` in one torch.profiler (CUPTI) session, retried while a session
    records no kernel or fewer kernels than the host launched (runtime
    calls named ``*Launch*``); empty where every try did."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        kernels = sum(not e.name.startswith(("Memcpy", "Memset"))
                      for e in events)
        launched = sum(e.device_type != cuda and "Launch" in e.name
                       for e in prof.events())
        if events and kernels >= launched:
            return events
    return []


def _event_ms(fn, reps: int) -> float:
    """Milliseconds per call between two CUDA events around ``reps``
    back-to-back calls: the device time plus whatever gaps the host's
    launches leave between kernels."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` per call after a warm-up call: the
    kernels (and copies) its ``reps`` calls ran on the card, summed from
    a torch.profiler (CUPTI) trace, because CUDA events around
    back-to-back calls also count the gaps that the host's launch
    overhead leaves between kernels of a few microseconds.  Where
    PROFILE_TRIES sessions in a row miss device activity, this and every
    later timing of the run falls back to CUDA events, and ``TIMING``
    says so."""
    import torch
    fn()
    torch.cuda.synchronize()
    if TIMING["clock"] == "profiler":
        events = _device_events(fn, reps)
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
        TIMING["clock"] = "events"
        print(f"timing: {PROFILE_TRIES} profiler sessions in a row recorded "
              "no device activity or fewer kernels than were launched; "
              "CUDA events time this and every later kernel of the run",
              flush=True)
    ms = _event_ms(fn, reps)
    if ms <= 0:
        raise AssertionError("CUDA events measured no time")
    return ms


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_topk(dev, rows: int, n: int, k: int, sign: bool, reps: int,
               live: int = None):
    """topk_compress against its plain version: counts and survivor masks
    exactly, plain Top_k values and memory bit for bit, SignTop_k values
    within rtol 1e-6 (its norm is a float sum in another order).
    ``live``: columns past it are zero, as the dispatcher pads a leaf."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_compress import topk_compress
    g = torch.Generator(device=dev).manual_seed(rows + n + k)
    x = torch.randn((rows, n), generator=g, device=dev)
    x[:, n if live is None else live:] = 0.0
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
    return {"shape": [rows, n], "k": k, "sign": sign, "live": live or n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bms, "bound_by": by}


def check_qsgd(dev, rows: int, n: int, s: int, reps: int, live: int = None):
    """qsgd_quantize against its plain version on shared uniforms: within
    rtol 1e-6 except at most 16 elements, which may sit one level
    (norm/s) apart where u lies within rounding of the fraction.
    ``live``: columns past it are zero in x and u, as the dispatcher pads
    a leaf."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.qsgd import (qsgd_geometry, qsgd_quantize,
                                          resident_blocks)
    g = torch.Generator(device=dev).manual_seed(rows + n)
    x = torch.randn((rows, n), generator=g, device=dev)
    u = torch.rand((rows, n), generator=g, device=dev)
    x[:, n if live is None else live:] = 0.0
    u[:, n if live is None else live:] = 0.0
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
    geo = qsgd_geometry(rows, n,
                        resident_blocks(torch.cuda.current_device()))
    return {"shape": [rows, n], "s": s, "live": live or n, "max_abs_err": err,
            "mismatched_levels": n_far, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "geometry": list(geo)}


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


def round_times(marks: list, t_end: float, plans) -> list:
    """ms per round from a StepClock's marks (one at each batch request)
    and the time the run ended: a round runs from its first batch
    request to the next round's (the last to ``t_end``).  The same
    measure for both runtimes: the per-step loop asks for each batch
    after the step before ended, the round loop for a round's batches
    after the round before ended."""
    starts = [p.start for p in plans]
    ends = [marks[s] for s in starts[1:]] + [t_end]
    return [(e - marks[s]) * 1e3 for s, e in zip(starts, ends)]


def runtime_timing(round_ms: list, plans) -> dict:
    """ms a round and ms a step, the median over the rounds past the
    second (a graph's first two calls run eagerly and capture)."""
    import numpy as np
    late = [(ms, p.length) for ms, p in zip(round_ms, plans)][2:] or [
        (round_ms[-1], plans[-1].length)]
    return {"ms_per_round": round_ms,
            "ms_per_step_median": float(np.median([ms / L
                                                   for ms, L in late]))}


def _free_graphs() -> None:
    """A dropped round runtime's graphs sit in reference cycles: collect
    them, then hand their pools back."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(dev):
    """ResNet-50 at full width through ``train`` under each operator,
    twice: the round runtime (the default; each round a CUDA graph) and
    ``runtime="step"`` (eager), under cuDNN's deterministic algorithms
    (its training kernels are otherwise not deterministic run to run):
    History, launches and the final master equal, one capture."""
    import numpy as np
    import torch
    from repro_torch.core import rounds
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
    mask = fixed_schedule(T, H)
    plans = rounds.compile_rounds(mask)
    n_syncs = int(mask.sum())
    totals = {k: 0 for k in LAUNCHES}
    runs = []
    fault_free = None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, op in (
                ("RowSignTopK", RowSignTopK(k=0.01, row_len=4096, m=2)),
                ("TopK", TopK(k=0.01)), ("QSGD", QSGDQuantizer(s=15))):
            out = {}
            for runtime in ("round", "step"):
                run = RunConfig(total_steps=T, R=R, H=H, runtime=runtime,
                                dispatch=DISPATCH, log_every=1, seed=0)
                clock = StepClock(worker_batches(x, y, R, B, T, seed=1,
                                                 feature_key="images"))
                _free_graphs()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launches()
                state, hist = train(grad_fn, params, momentum_sgd(0.9), op,
                                    piecewise_decay(0.05, [100, 130]), clock,
                                    run, smooth=1, device=dev)
                torch.cuda.synchronize()
                t_end = time.perf_counter()
                launches = dict(LAUNCHES)
                for k, v in launches.items():
                    totals[k] += v
                timing = {**runtime_timing(round_times(clock.marks, t_end,
                                                       plans), plans),
                          "peak_device_bytes":
                              torch.cuda.max_memory_allocated(dev),
                          "captures": hist.captures}
                for leaf in tree_leaves((state.master, state.local,
                                         state.memory, state.master_view,
                                         state.inner)):
                    if leaf.device.type != dev.type:
                        raise AssertionError(f"{name}: state tensor on "
                                             f"{leaf.device}")
                # the graphed state aliases the round program's buffers
                master = [t.clone() for t in tree_leaves(state.master)]
                out[runtime] = (hist, launches, timing, master)
                del state
            (hist, launches, timing, master), (ref, ref_launches, ref_timing,
                                               ref_master) = (
                out["round"], out["step"])
            for f in ("steps", "loss", "bits", "bits_down", "rounds"):
                if getattr(hist, f) != getattr(ref, f):
                    raise AssertionError(f"{name}: History.{f} differs "
                                         "between the runtimes")
            if launches != ref_launches or not all(
                    torch.equal(a, b) for a, b in zip(master, ref_master)):
                raise AssertionError(f"{name}: launches or masters differ "
                                     "between the runtimes")
            if timing["captures"] != 1 or ref_timing["captures"] != 0:
                raise AssertionError(f"{name}: captures {timing['captures']}")
            row = {"operator": name, "loss": hist.loss, "bits_up": hist.bits,
                   "bits_down": hist.bits_down, "rounds": hist.rounds[-1],
                   "graphed": timing, "eager": ref_timing,
                   "launches": {k: v for k, v in launches.items() if v}}
            print("train", json.dumps(row), flush=True)
            if not all(np.isfinite(hist.loss)):
                raise AssertionError(f"{name}: loss not finite: {hist.loss}")
            kern, per_sync = WANT_PER_SYNC[name]
            if launches[kern] != per_sync * n_syncs:
                raise AssertionError(
                    f"{name}: {launches[kern]} {kern} launches in {n_syncs} "
                    f"syncs, want {per_sync} per sync")
            if hist.bits[-1] <= 0 or hist.rounds[-1] != n_syncs:
                raise AssertionError(f"{name}: ledger {hist.bits[-1]} bits, "
                                     f"{hist.rounds[-1]} rounds")
            runs.append(row)
            if name == "RowSignTopK":
                # the reference of the fault runtime's preset:none cell
                fault_free = (hist, master)
            del out, master, ref_master
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # the times users see: cuDNN's default algorithms (not deterministic
    # run to run, so no equality is asserted), RowSignTopK, both runtimes,
    # T_TIME steps (the median over three rounds past the second)
    timing = {}
    plans = rounds.compile_rounds(fixed_schedule(T_TIME, H))
    for runtime in ("round", "step"):
        clock = StepClock(worker_batches(x, y, R, B, T_TIME, seed=1,
                                         feature_key="images"))
        _free_graphs()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        _, hist = train(grad_fn, params, momentum_sgd(0.9),
                        RowSignTopK(k=0.01, row_len=4096, m=2),
                        piecewise_decay(0.05, [100, 130]), clock,
                        RunConfig(total_steps=T_TIME, R=R, H=H,
                                  runtime=runtime, dispatch=DISPATCH,
                                  log_every=1, seed=0),
                        smooth=1, device=dev)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        for k, v in LAUNCHES.items():
            totals[k] += v
        timing[runtime] = {
            **runtime_timing(round_times(clock.marks, t_end, plans), plans),
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
            "captures": hist.captures}
    print("train timing (cuDNN's default algorithms) RowSignTopK",
          json.dumps({"graphed": timing["round"], "eager": timing["step"]}),
          flush=True)
    _free_graphs()
    return runs, totals, fault_free


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

# ---------------------------------------------------------------------------
# the paper's two algorithm wrappers, and the convex methods
# ---------------------------------------------------------------------------


def _same_state(st, ref, what: str) -> None:
    """A wrapper's state against the engine's after the same run: every
    field the wrapper keeps (its exact-broadcast views are rebuilt, not
    kept) equal, tensors bit for bit."""
    import torch
    from repro_torch.tree import tree_leaves
    for f in st._fields:
        a, b = getattr(st, f), getattr(ref, f)
        if a is None:
            continue
        if isinstance(a, int):
            same = a == b
        else:
            la, lb = tree_leaves(a), tree_leaves(b)
            same = len(la) == len(lb) and all(
                torch.equal(x, y) for x, y in zip(la, lb))
        if not same:
            raise AssertionError(f"{what}: the wrapper and the engine "
                                 f"differ in {f}")


def _group_ledger_total(leaf_bits, total, what: str) -> float:
    """The per-group ledger adds up to the total ledger.  Both are float32
    folds of the same per-leaf, per-worker terms in other orders (groups
    first, or workers first), and above 2^24 bits each addition rounds by
    at most 2^-24 of the running total: WRAP_ADDS additions bound the
    relative gap by WRAP_ADDS * 2^-24 (1e-4)."""
    gap = abs(float(leaf_bits.double().sum()) - float(total))
    rel = gap / max(float(total), 1.0)
    if rel > WRAP_ADDS * 2.0 ** -24:
        raise AssertionError(f"{what}: groups sum to "
                             f"{float(leaf_bits.double().sum())}, total "
                             f"{float(total)}")
    return rel


def phase_wrappers(dev):
    """ResNet-50 at full width through the paper's two algorithm wrappers
    (R = 8, batch 8 a worker, 224x224, T = WRAP["T"] steps at H = 2):
    RowSignTopK through ``qsparse.run`` with the per-group ledger, QSGD
    through ``async_qsparse.run`` on an ``async_schedule`` mask, each
    held to ``engine.run`` on the same inputs and generator state (same
    code: every state tensor and both ledgers equal, cuDNN pinned to its
    deterministic algorithms for the phase).  Returns the launches of
    the wrapper runs."""
    import numpy as np
    import torch
    from repro_torch.core import async_qsparse, engine, qsparse, rounds
    from repro_torch.core.operators import QSGDQuantizer, RowSignTopK
    from repro_torch.core.schedule import async_schedule, fixed_schedule
    from repro_torch.data import make_image_data, worker_batches
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import resnet
    from repro_torch.optim import momentum_sgd, piecewise_decay
    from repro_torch.tree import value_and_grad

    T, Hw = WRAP["T"], WRAP["H"]
    cfg = model_config()
    params = resnet.init_params(torch.Generator().manual_seed(0), cfg,
                                device=dev)
    x, y = make_image_data(**IMAGES)
    grad_fn = value_and_grad(lambda p, b: resnet.loss_fn(p, b, cfg)[0])
    inner, lr = momentum_sgd(0.9), piecewise_decay(0.05, [100, 130])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    totals = {k: 0 for k in LAUNCHES}
    cases = (
        ("RowSignTopK", "qsparse", RowSignTopK(k=0.01, row_len=4096, m=2),
         fixed_schedule(T, Hw)),
        ("QSGD", "async_qsparse", QSGDQuantizer(s=15),
         async_schedule(T, R, Hw, seed=WRAP["seed"])),
    )
    try:
        for name, wrapper, op, mask in cases:
            runs = {}
            for driver in (wrapper, "engine", "rounds"):
                sync = wrapper == "qsparse"
                mod = {"qsparse": qsparse, "async_qsparse": async_qsparse,
                       "engine": engine}.get(driver)
                kw = {"global_rounds": sync} if driver == "engine" else {}
                if driver == "rounds":
                    # the wrapper's round runtime, graphed
                    mod = qsparse if sync else async_qsparse
                    make, drive = mod.make_superstep, mod.run_rounds
                else:
                    make, drive = mod.make_step, mod.run
                state = mod.init(params, inner, R, leaf_ledger=True,
                                 device=dev)
                step = make(grad_fn, inner, op, lr, R,
                            dispatch=DispatchConfig(mode=DISPATCH),
                            leaf_ledger=True, **kw)
                clock = StepClock(worker_batches(x, y, R, B, T, seed=1,
                                                 feature_key="images"))
                gen = torch.Generator(device=dev).manual_seed(WRAP["seed"])
                _free_graphs()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launches()
                state, losses = drive(state, step, clock, mask, gen)
                torch.cuda.synchronize()
                plans = rounds.compile_rounds(mask)
                timing = {**runtime_timing(round_times(
                    clock.marks, time.perf_counter(), plans), plans),
                    "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
                runs[driver] = (state, losses, dict(LAUNCHES),
                                clock.step_ms(),
                                step, timing)
            rst, rlosses, rlaunches, _, sup, rtiming = runs.pop("rounds")
            _same_state(rst, runs[wrapper][0], f"{name} rounds")
            plans = rounds.compile_rounds(mask)
            shapes = {(p.length, np.asarray(p.mask).tobytes()) for p in plans}
            repeated = sum(
                sum((p.length, np.asarray(p.mask).tobytes()) == k
                    for p in plans) > 1 for k in shapes)
            if (rlosses != runs[wrapper][1] or rlaunches != runs[wrapper][2]
                    or sup.captures != repeated):
                raise AssertionError(
                    f"{name}: {wrapper}.run_rounds differs from run "
                    f"(captures {sup.captures}, want {repeated})")
            print(f"wrappers {name}: {wrapper}.run_rounds equals {wrapper}"
                  f".run; {len(plans)} rounds of {len(shapes)} shapes, "
                  f"{sup.captures} captured; graphed "
                  f"{json.dumps(rtiming)}, eager "
                  f"{json.dumps(runs[wrapper][5])}", flush=True)
            del rst, sup
            (st, losses, launches, step_ms, _, _) = runs[wrapper]
            ref_st, ref_losses = runs["engine"][:2]
            _same_state(st, ref_st, name)
            if losses != ref_losses:
                raise AssertionError(f"{name}: losses differ")
            up_gap = _group_ledger_total(st.leaf_bits, st.bits, name)
            down_gap = _group_ledger_total(st.leaf_bits_down, st.bits_down,
                                           name)
            any_sync = mask.reshape(T, -1).any(axis=1)
            n_syncs = int(any_sync.sum())
            kern, per_sync = WANT_PER_SYNC[name]
            if launches[kern] != per_sync * n_syncs or sum(
                    launches.values()) != launches[kern]:
                raise AssertionError(f"{name} via {wrapper}: launches "
                                     f"{launches} in {n_syncs} syncs")
            if not all(np.isfinite(losses)):
                raise AssertionError(f"{name}: loss not finite: {losses}")
            for k, v in launches.items():
                totals[k] += v
            local = [ms for ms, s in zip(step_ms, any_sync) if not s]
            sync = [ms for ms, s in zip(step_ms, any_sync) if s]
            # an async mask may sync some worker at every step
            local_ms = float(np.mean(local[1:] or local)) if local else None
            row = {"operator": name, "wrapper": wrapper, "loss": losses,
                   "rounds": st.rounds, "bits_up": float(st.bits),
                   "bits_down": float(st.bits_down),
                   "leaf_groups": list(engine.leaf_group_names(st.master)),
                   "leaf_bits": st.leaf_bits.tolist(),
                   "leaf_bits_down": st.leaf_bits_down.tolist(),
                   "groups_vs_total_rel_gap": [up_gap, down_gap],
                   "launches_per_sync": launches[kern] / n_syncs,
                   "ms_per_step": step_ms,
                   "ms_per_local_step": local_ms,
                   "ms_per_sync_step": float(np.mean(sync))}
            print("wrappers", json.dumps(row), flush=True)
            del runs, st, ref_st
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return totals


def convex_run(dev, method: dict, dispatch: str, rng=None,
               runtime: str = "round", overlap: bool = False):
    """One of the paper's convex runs (softmax regression on mnist_like,
    d = 7850) through ``train``: its History, launches and timing (ms a
    round and a step, graphed or eager)."""
    import torch
    from repro_torch.core import rounds
    from repro_torch.core.operators import make_operator
    from repro_torch.data import mnist_like, worker_batches
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import softmax
    from repro_torch.optim import inverse_time, sgd
    from repro_torch.train import RunConfig, train
    from repro_torch.train.trainer import make_mask
    from repro_torch.tree import value_and_grad
    x, y = mnist_like(CONVEX["n"], seed=0)
    cfg = softmax.SoftmaxConfig(l2=1.0 / len(x))
    grad_fn = value_and_grad(lambda p, b: softmax.loss_fn(p, b, cfg)[0])
    R_, T_ = method["R"], method["T"]
    run = RunConfig(total_steps=T_, R=R_, H=method["H"],
                    log_every=method["log_every"], seed=0,
                    target_loss=CONVEX["target"], dispatch=dispatch,
                    runtime=runtime, overlap=overlap,
                    asynchronous=method.get("asynchronous", False))
    clock = StepClock(worker_batches(x, y, R_, CONVEX["b"], T_,
                                     seed=method["batch_seed"]))
    _free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    _, hist = train(grad_fn, softmax.init_params(cfg, device=dev), sgd(),
                    make_operator(method["op"], **method["kw"]),
                    inverse_time(60.0, 100.0), clock, run, device=dev,
                    rng=rng)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    plans = rounds.compile_rounds(make_mask(run))
    timing = runtime_timing(round_times(clock.marks, t_end, plans), plans)
    timing["ms_per_round"] = float(sum(timing["ms_per_round"][2:])
                                   / max(len(plans) - 2, 1))
    timing["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev)
    return hist, dict(LAUNCHES), timing


def _same_history(a, b, what: str) -> None:
    for f in ("steps", "loss", "bits", "bits_down", "rounds",
              "bits_to_target", "steps_to_target"):
        if getattr(a, f) != getattr(b, f):
            raise AssertionError(f"{what}: History.{f} differs")


def qsgd_uniforms(dev, method: dict, dispatch: str):
    """One draw of the run's uniforms for EF-QSGD, handed out in the order
    each dispatch mode consumes them (leaf by leaf; "auto" a worker at a
    time, "kernel" a leaf's workers as one [R, d] draw), so that both
    modes quantize with the same randomness."""
    import torch
    from repro_torch.core.operators import Uniforms
    g = torch.Generator(device=dev).manual_seed(7)
    R_ = method["R"]
    feed = []
    for _ in range(method["T"]):                 # H = 1: a sync a step
        for d in CONVEX["leaves"]:
            u = torch.rand((R_, d), generator=g, device=dev)
            feed += [u] if dispatch == "kernel" else list(u.unbind(0))
    return Uniforms(feed)


def phase_convex(dev):
    """The paper's Section 5.2 problem on the card: the quickstart's two
    methods (R = 8, T = 300) and bench_convex's methods that reach a
    kernel rule or share its draws (R = 15, T = 400), each once under
    dispatch "auto" (these leaves, 7,840 and 10 floats, are below the
    kernels' min_size: the reference operators) and once under
    "kernel".  Where no kernel rule applies the two runs are one
    computation and must agree exactly; EF-QSGD gets the same uniforms in
    both modes and is held within CONVEX_TOL (the kernel's norm sums in
    another order, so a level can round the other way); Top_k's kernel
    keeps every coordinate tied with its threshold (``repro``'s rule)
    where the reference keeps exactly k, so its bits may only grow.
    Before the runs, both kernels are held to their plain versions at
    the shapes the dispatcher builds here: a leaf's R rows zero-padded
    to 128 columns, Top_k's k resolved per leaf.  Returns the launches
    under "kernel" and those checks."""
    import numpy as np
    import torch
    from repro_torch.core.operators import resolve_k
    from repro_torch.kernels.dispatch import LANES
    checks = {"topk": [], "qsgd": []}
    for method in CONVEX["methods"]:
        kern = method.get("kernel")
        for d in CONVEX["leaves"] if kern else ():
            n = -(-d // LANES) * LANES
            if kern == "topk_compress":
                row = check_topk(dev, method["R"], n,
                                 resolve_k(method["kw"]["k"], d), False, 20,
                                 live=d)
            else:
                row = check_qsgd(dev, method["R"], n, method["kw"]["s"], 20,
                                 live=d)
            checks["topk" if kern == "topk_compress" else "qsgd"].append(row)
            print("kernel check", kern, json.dumps(row), flush=True)
    totals = {}
    for method in CONVEX["methods"]:
        name = method["name"]
        out = {}
        qsgd = method["op"] == "qsgd"
        for dispatch in ("auto", "kernel"):
            # EF-QSGD's two modes quantize with one feed of uniforms, which
            # a CUDA graph cannot hold: the per-step runtime
            rng = qsgd_uniforms(dev, method, dispatch) if qsgd else None
            out[dispatch] = convex_run(dev, method, dispatch, rng,
                                       runtime="step" if qsgd else "round")
            if rng is not None and rng.remaining():
                raise AssertionError(f"{name}: {rng.remaining()} uniforms "
                                     "left over")
        # the round runtime (graphed) against the per-step runtime (eager)
        # under "kernel", one generator seed each: the same History
        gen = (lambda: torch.Generator(device=dev).manual_seed(3)) \
            if qsgd else (lambda: None)
        graphed = (convex_run(dev, method, "kernel", gen()) if qsgd
                   else out["kernel"])
        eager = convex_run(dev, method, "kernel", gen(), runtime="step")
        for h in (graphed, eager):
            if any(v for k, v in h[1].items() if k != method.get("kernel")):
                raise AssertionError(f"{name}: launches {h[1]}")
        _same_history(graphed[0], eager[0], f"{name} round vs step")
        if graphed[1] != eager[1] or graphed[0].captures != 1:
            raise AssertionError(f"{name}: launches {graphed[1]} / "
                                 f"{eager[1]}, captures "
                                 f"{graphed[0].captures}")
        if method.get("overlap"):
            over = convex_run(dev, method, "kernel", overlap=True)
            _same_history(over[0], graphed[0], f"{name} overlap vs round")
            print(f"convex {name}: overlap (window 8) equals the serial "
                  f"round runtime, {over[0].captures} capture(s), "
                  f"{over[2]['ms_per_step_median']:.3f} ms a step", flush=True)
        (ha, la, _), (hk, lk, _) = out["auto"], out["kernel"]
        if any(la.values()):
            raise AssertionError(f"{name}: auto launched {la}")
        kern = method.get("kernel")
        n_syncs = hk.rounds[-1]
        want = {kern: method["per_sync"] * n_syncs} if kern else {}
        if {k: v for k, v in lk.items() if v} != want:
            raise AssertionError(f"{name}: kernel launches {lk}, want "
                                 f"{want}")
        if ha.rounds != hk.rounds or ha.steps != hk.steps:
            raise AssertionError(f"{name}: rounds differ")
        bits_rel = max(abs(a - b) / a for a, b in zip(ha.bits, hk.bits))
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(ha.loss, hk.loss))
        tol = CONVEX_TOL.get(method["op"])
        if tol is None:
            if ha.bits != hk.bits or ha.loss != hk.loss or \
                    ha.bits_to_target != hk.bits_to_target:
                raise AssertionError(f"{name}: auto and kernel differ "
                                     f"({ha.bits[-1]} / {hk.bits[-1]} bits)")
        else:
            if bits_rel > tol["bits"] or loss_rel > tol["loss"]:
                raise AssertionError(f"{name}: bits within {bits_rel}, "
                                     f"losses within {loss_rel}")
            if method["op"] == "topk" and any(
                    b < a for a, b in zip(ha.bits, hk.bits)):
                raise AssertionError(f"{name}: the kernel counted fewer "
                                     "survivors than k")
        if not all(np.isfinite(ha.loss + hk.loss)):
            raise AssertionError(f"{name}: loss not finite")
        row = {"method": name, "R": method["R"], "T": method["T"],
               "H": method["H"], "rounds": hk.rounds[-1],
               "bits": [ha.bits[-1], hk.bits[-1]],
               "bits_to_target": [ha.bits_to_target, hk.bits_to_target],
               "steps_to_target": [ha.steps_to_target, hk.steps_to_target],
               "final_loss": [ha.loss[-1], hk.loss[-1]],
               "bits_rel_gap": bits_rel, "loss_rel_gap": loss_rel,
               "graphed": graphed[2], "eager": eager[2],
               "kernel_launches_per_sync": (lk[kern] / n_syncs if kern
                                            else 0)}
        print("convex", json.dumps(row), flush=True)
        for k, v in lk.items():
            totals[k] = totals.get(k, 0) + v
    for k, v in convex_async(dev).items():
        totals[k] = totals.get(k, 0) + v
    return totals, checks


def round_shapes(mask) -> dict:
    """A schedule's rounds, its distinct round shapes (length, tail mask)
    and those that run more than once (the ones the round runtime
    captures, at most ``engine.RoundRunner``'s ``max_programs``)."""
    from repro_torch.core import rounds
    import numpy as np
    counts: dict = {}
    plans = rounds.compile_rounds(mask)
    for p in plans:
        key = (p.length, np.asarray(p.mask).tobytes())
        counts[key] = counts.get(key, 0) + 1
    return {"rounds": len(plans), "distinct": len(counts),
            "repeated": sum(n > 1 for n in counts.values())}


def convex_async(dev) -> dict:
    """Algorithm 2 through ``train`` at the paper's Section 5.2.3 sizes
    (``benchmarks/bench_async.py``'s TopK rows: R = 15, T = 400, sync
    gaps drawn U[1, H]): the round runtime (the default) against
    ``runtime="step"``, one generator seed each.  Rounds close wherever
    any worker syncs, so nearly every round is one step with its own
    tail mask: History and launches equal, captures = the shapes that
    repeat, at most ``max_programs``.  Returns the launches."""
    import torch
    from repro_torch.core import schedule
    from repro_torch.core.engine import MAX_PROGRAMS
    for H_ in ASYNC_CONVEX["shapes_at_H"]:
        print(f"convex async shapes at R = {ASYNC_CONVEX['R']}, H = {H_}, "
              f"T = {ASYNC_CONVEX['T']}: " + json.dumps(round_shapes(
                  schedule.async_schedule(ASYNC_CONVEX["T"],
                                          ASYNC_CONVEX["R"], H_, seed=0))),
              flush=True)
    method = {"name": "async_topk_H4", "op": "topk",
              "kw": {"k": K_CONVEX}, "R": ASYNC_CONVEX["R"],
              "T": ASYNC_CONVEX["T"], "H": ASYNC_CONVEX["H"],
              "log_every": 25, "batch_seed": 0, "asynchronous": True}
    gen = lambda: torch.Generator(device=dev).manual_seed(3)  # noqa: E731
    graphed = convex_run(dev, method, "kernel", gen())
    eager = convex_run(dev, method, "kernel", gen(), runtime="step")
    _same_history(graphed[0], eager[0], "async TopK round vs step")
    shapes = round_shapes(schedule.async_schedule(
        method["T"], method["R"], method["H"], seed=0))
    want = min(shapes["repeated"], MAX_PROGRAMS)
    if graphed[1] != eager[1] or graphed[0].captures != want or \
            not graphed[1].get("topk_compress"):
        raise AssertionError(f"async TopK: launches {graphed[1]} / "
                             f"{eager[1]}, captures {graphed[0].captures}, "
                             f"want {want}")
    print("convex async " + json.dumps(
        {"method": method["name"], "R": method["R"], "T": method["T"],
         "H": method["H"], **shapes, "captures": graphed[0].captures,
         "rounds_synced": graphed[0].rounds[-1], "bits": graphed[0].bits[-1],
         "graphed": graphed[2], "eager": eager[2]}), flush=True)
    return graphed[1]

# ---------------------------------------------------------------------------
# fleet scenarios, the fault runtime and resume
# ---------------------------------------------------------------------------

#: the fault and scenario cells on ResNet-50 (the training run's R, B, T,
#: H): (tag, operator, RunConfig fields)
FAULT_CELLS = (
    ("none", "RowSignTopK", {"faults": "preset:none"}),
    ("chaos", "RowSignTopK", {"faults": "preset:chaos",
                              "staleness_weight": "damped"}),
    ("flaky_fleet", "TopK", {"scenario": "preset:flaky_fleet",
                             "aggregate": "mean_S"}),
)
#: the resume cell: a whole run writing full snapshots, then a fresh run
#: resumed from the first one
RESUME = {"faults": "preset:crashy", "ckpt_every": 6, "from": 6}
#: bench_scenarios.py's convergence row (softmax regression, QTop_k,
#: support_weighted) at two participations; T cut from its 300 to 150
#: (the run's time: the p = 0.5 masks run at the eager speed)
SCENARIO_CONVEX = {"R": 15, "T": 150, "H": 4, "b": 8, "k": K_CONVEX,
                   "s": 15, "participation": (1.0, 0.5), "seed": 1}
#: Algorithm 2 with executed staleness on the convex problem (T as above)
ASYNC_FAULTS = {"R": 15, "T": 150, "H": 4, "faults": "preset:delayed"}


def _digest(tree):
    """A bit-level digest of a state tree: each leaf's float32 bit
    patterns summed as int64 (any flipped bit moves it)."""
    import torch
    from repro_torch.tree import tree_leaves
    return [int(t.contiguous().view(torch.int32).sum(dtype=torch.int64))
            if t.dtype == torch.float32 else int(t.sum())
            for t in tree_leaves(tree)]


def resnet_fault_run(dev, setup, op_name: str, runtime: str, **kw) -> dict:
    """ResNet-50 through ``train`` under a fault spec or a scenario: its
    History, launches, the master (cloned), digests of the per-worker
    state and the queue, the queue's tags and bytes, captures and
    distinct round shapes, peak memory and seconds."""
    import torch
    from repro_torch.core.operators import QSGDQuantizer, RowSignTopK, TopK
    from repro_torch.data import worker_batches
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.optim import momentum_sgd, piecewise_decay
    from repro_torch.train import RunConfig, train
    from repro_torch.tree import tree_leaves
    params, grad_fn, x, y = setup
    op = {"RowSignTopK": RowSignTopK(k=0.01, row_len=4096, m=2),
          "TopK": TopK(k=0.01), "QSGD": QSGDQuantizer(s=15)}[op_name]
    run = RunConfig(total_steps=T, R=R, H=H, runtime=runtime,
                    dispatch=DISPATCH, log_every=1, seed=0, **kw)
    _free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t0 = time.perf_counter()
    state, hist = train(grad_fn, params, momentum_sgd(0.9), op,
                        piecewise_decay(0.05, [100, 130]),
                        worker_batches(x, y, R, B, T, seed=1,
                                       feature_key="images"),
                        run, smooth=1, device=dev)
    torch.cuda.synchronize()
    out = {"hist": hist, "launches": dict(LAUNCHES),
           "seconds": time.perf_counter() - t0,
           "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
           "master": [t.clone() for t in tree_leaves(state.master)],
           "digest": _digest((state.master_view, state.local, state.memory,
                              state.inner, state.inflight)),
           "arrive_at": (None if state.arrive_at is None
                         else state.arrive_at.tolist()),
           "queue_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(state.inflight))}
    del state
    _free_graphs()
    return out


def _same_run(a: dict, b: dict, what: str, hist_only: bool = False) -> None:
    import torch
    for f in ("steps", "loss", "bits", "bits_down", "rounds"):
        if getattr(a["hist"], f) != getattr(b["hist"], f):
            raise AssertionError(f"{what}: History.{f} differs")
    if not all(torch.equal(p, q) for p, q in zip(a["master"], b["master"])):
        raise AssertionError(f"{what}: masters differ")
    if hist_only:
        return
    if a["hist"].round_blocks and b["hist"].round_blocks and \
            a["hist"].round_blocks != b["hist"].round_blocks:
        raise AssertionError(f"{what}: round_blocks differ")
    for k in ("launches", "digest", "arrive_at"):
        if a[k] != b[k]:
            raise AssertionError(f"{what}: {k} differs")


def phase_faults(dev, fault_free) -> dict:
    """ResNet-50 at full width under the fault runtime and a fleet
    scenario, each graphed (``runtime="round"``) and eager
    (``runtime="step"``) with the same History, ``round_blocks``,
    master, ledgers, per-worker state and queue, and launches, under
    cuDNN's deterministic algorithms: ``preset:none`` (also equal to the
    fault-free RowSignTopK cell of the training phase), ``preset:chaos``
    with damped staleness (the queue's bytes, captures and distinct
    fault-round shapes printed), ``flaky_fleet`` under mean_S; then
    resume: ``preset:crashy`` with QSGD writing full snapshots, and a
    fresh run resumed from the first, which ends in the whole run's
    state with its History tail.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.data import make_image_data
    from repro_torch.models import resnet
    from repro_torch.train import checkpoint
    from repro_torch.tree import value_and_grad
    cfg = model_config()
    setup = (resnet.init_params(torch.Generator().manual_seed(0), cfg,
                                device=dev),
             value_and_grad(lambda p, b: resnet.loss_fn(p, b, cfg)[0]),
             *make_image_data(**IMAGES))
    totals: dict = {}
    name_power = card()

    def count(run):
        for k, v in run["launches"].items():
            totals[k] = totals.get(k, 0) + v

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    build = os.path.join(SRC, "repro_torch", "kernels", "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build)
    try:
        for tag, op_name, kw in FAULT_CELLS:
            g = resnet_fault_run(dev, setup, op_name, "round", **kw)
            e = resnet_fault_run(dev, setup, op_name, "step", **kw)
            _same_run(g, e, f"faults {tag} round vs step")
            count(g)
            count(e)
            if tag == "none":
                ref_hist, ref_master = fault_free
                _same_run(g, {"hist": ref_hist, "master": ref_master},
                          "preset:none vs the fault-free cell",
                          hist_only=True)
            h = g["hist"]
            if not all(np.isfinite(h.loss)) or h.bits[-1] <= 0:
                raise AssertionError(f"faults {tag}: loss {h.loss}, bits "
                                     f"{h.bits[-1]}")
            print("faults " + json.dumps({
                "card": name_power, "cell": tag, "operator": op_name, **kw,
                "loss": h.loss,
                "bits_up": h.bits[-1], "bits_down": h.bits_down[-1],
                "rounds": h.rounds[-1], "round_blocks": h.round_blocks,
                "queue_bytes": g["queue_bytes"], "captures": h.captures,
                "round_shapes": h.round_shapes,
                "peak_device_bytes": {"graphed": g["peak_device_bytes"],
                                      "eager": e["peak_device_bytes"]},
                "seconds": {"graphed": g["seconds"],
                            "eager": e["seconds"]},
                "launches": {k: v for k, v in g["launches"].items() if v}}),
                flush=True)
            del g, e
        # resume: the whole run writes full_step_6 and full_step_12
        ck = os.path.join(tmp, "resume")
        kw = {"faults": RESUME["faults"], "ckpt_dir": ck,
              "ckpt_every": RESUME["ckpt_every"]}
        whole = resnet_fault_run(dev, setup, "QSGD", "round", **kw)
        eager = resnet_fault_run(dev, setup, "QSGD", "step",
                                 faults=RESUME["faults"])
        _same_run(whole, eager, "resume cell: whole round vs step")
        fulls = sorted(int(n.rsplit("_", 1)[1]) for n in os.listdir(ck)
                       if n.startswith("full_step_"))
        snap_bytes = dir_bytes(os.path.join(ck, f"full_step_{fulls[0]}"))
        for n in fulls:
            if n != RESUME["from"]:
                shutil.rmtree(os.path.join(ck, f"full_step_{n}"))
        t0 = time.perf_counter()
        resumed = resnet_fault_run(dev, setup, "QSGD", "round",
                                   faults=RESUME["faults"], ckpt_dir=ck,
                                   resume=True)
        a, b = whole["hist"], resumed["hist"]
        k = a.steps.index(RESUME["from"] + 1)
        for f in ("steps", "loss", "bits", "bits_down", "rounds"):
            if getattr(a, f)[k:] != getattr(b, f):
                raise AssertionError(f"resume: History.{f} tail differs")
        for key in ("digest", "arrive_at"):
            if whole[key] != resumed[key]:
                raise AssertionError(f"resume: final {key} differs")
        if not all(torch.equal(p, q) for p, q in zip(whole["master"],
                                                      resumed["master"])):
            raise AssertionError("resume: final master differs")
        for run in (whole, eager, resumed):
            count(run)
        print("faults resume " + json.dumps({
            "card": name_power, **RESUME, "operator": "QSGD",
            "snapshots": fulls,
            "snapshot_bytes": snap_bytes, "queue_bytes": whole["queue_bytes"],
            "loss": a.loss, "bits_up": a.bits[-1], "rounds": a.rounds[-1],
            "captures": a.captures, "round_shapes": a.round_shapes,
            "resumed_seconds": time.perf_counter() - t0,
            "seconds": {"graphed": whole["seconds"],
                        "eager": eager["seconds"]}}), flush=True)
        del whole, eager, resumed
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)
    _free_graphs()
    return totals


def scenario_convex_run(dev, participation, runtime: str):
    """bench_scenarios.py's convergence row through ``train``: softmax
    regression, QTop_k (k = 40 of 7850, s = 15), support_weighted, under
    ``Scenario(participation=p)`` (None: the plain schedule)."""
    import torch
    from repro_torch.core import scenarios as scn
    from repro_torch.core.operators import QuantizedSparsifier
    from repro_torch.data import mnist_like, worker_batches
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import softmax
    from repro_torch.optim import inverse_time, sgd
    from repro_torch.train import RunConfig, train
    from repro_torch.tree import tree_leaves, value_and_grad
    c = SCENARIO_CONVEX
    x, y = mnist_like(CONVEX["n"], seed=0)
    cfg = softmax.SoftmaxConfig(l2=1.0 / len(x))
    grad_fn = value_and_grad(lambda p, b: softmax.loss_fn(p, b, cfg)[0])
    run = RunConfig(
        total_steps=c["T"], R=c["R"], H=c["H"], log_every=25, seed=0,
        runtime=runtime, aggregate="support_weighted",
        scenario=(None if participation is None else scn.Scenario(
            participation=participation, seed=c["seed"])))
    _free_graphs()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = train(grad_fn, softmax.init_params(cfg, device=dev), sgd(),
                        QuantizedSparsifier(k=c["k"], s=c["s"]),
                        inverse_time(60.0, 100.0),
                        worker_batches(x, y, c["R"], c["b"], c["T"], seed=0),
                        run, device=dev)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / c["T"]
    master = [t.clone() for t in tree_leaves(state.master)]
    return hist, master, dict(LAUNCHES), ms


def phase_scenarios_convex(dev) -> dict:
    """The convex problem under fleet scenarios and executed staleness:
    bench_scenarios' convergence row at participation 1.0 (equal to the
    plain schedule bit for bit) and 0.5, each graphed and eager with the
    same History and master; then Algorithm 2 with executed staleness
    (TopK, R = 15, ``preset:delayed``): ``async_qsparse.run_faults``
    equal to ``engine.run_faults``, and ``engine.run_fault_rounds``
    (graphed) equal to both.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.core import async_qsparse, engine, scenarios as scn
    from repro_torch.core import schedule
    from repro_torch.core.operators import TopK
    from repro_torch.data import mnist_like, worker_batches
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import softmax
    from repro_torch.optim import inverse_time, sgd
    from repro_torch.tree import tree_leaves, value_and_grad
    totals: dict = {}
    plain = scenario_convex_run(dev, None, "round")
    for p in SCENARIO_CONVEX["participation"]:
        g = scenario_convex_run(dev, p, "round")
        e = scenario_convex_run(dev, p, "step")
        for run, what in ((e, "round vs step"),) + (
                ((plain, "p = 1.0 vs the plain schedule"),) if p == 1.0
                else ()):
            for f in ("steps", "loss", "bits", "bits_down", "rounds"):
                if getattr(g[0], f) != getattr(run[0], f):
                    raise AssertionError(f"scenario p={p} {what}: "
                                         f"History.{f} differs")
            if not all(torch.equal(a, b) for a, b in zip(g[1], run[1])):
                raise AssertionError(f"scenario p={p} {what}: masters "
                                     "differ")
        for run in (g, e):
            for k, v in run[2].items():
                totals[k] = totals.get(k, 0) + v
        mask = scn.Scenario(participation=p, seed=SCENARIO_CONVEX[
            "seed"]).mask(SCENARIO_CONVEX["T"], SCENARIO_CONVEX["R"],
                          SCENARIO_CONVEX["H"])
        print("scenario convex " + json.dumps({
            "participation": p, "p_hat": scn.participation_of(mask),
            "final_loss": g[0].loss[-1], "bits": g[0].bits[-1],
            "rounds": g[0].rounds[-1], "captures": g[0].captures,
            "round_shapes": g[0].round_shapes,
            "ms_per_step": {"graphed": g[3], "eager": e[3]}}), flush=True)
    c = ASYNC_FAULTS
    x, y = mnist_like(CONVEX["n"], seed=0)
    cfg = softmax.SoftmaxConfig(l2=1.0 / len(x))
    grad_fn = value_and_grad(lambda p, b: softmax.loss_fn(p, b, cfg)[0])
    spec = scn.parse_faults(c["faults"])
    mask = schedule.async_schedule(c["T"], c["R"], c["H"], seed=0)
    tables = spec.tables(c["T"], c["R"])
    batches = list(worker_batches(x, y, c["R"], CONVEX["b"], c["T"], seed=0))
    kw = dict(queue_depth=spec.depth, dispatch=DispatchConfig(mode="kernel"))
    outs = {}
    for name in ("async_qsparse", "engine", "engine_rounds"):
        params = softmax.init_params(cfg, device=dev)
        args = (grad_fn, sgd(), TopK(k=K_CONVEX), inverse_time(60.0, 100.0),
                c["R"])
        _free_graphs()
        reset_launches()
        t0 = time.perf_counter()
        if name == "async_qsparse":
            st = async_qsparse.init(params, sgd(), c["R"], device=dev,
                                    queue_depth=spec.depth)
            fn = async_qsparse.make_fault_step(*args, **kw)
            st, losses = async_qsparse.run_faults(st, fn, batches, mask,
                                                  tables)
        else:
            st = engine.init(params, sgd(), c["R"], device=dev,
                             queue_depth=spec.depth)
            make = (engine.make_fault_step if name == "engine"
                    else engine.make_fault_superstep)
            drive = (engine.run_faults if name == "engine"
                     else engine.run_fault_rounds)
            fn = make(*args, global_rounds=False, **kw)
            st, losses = drive(st, fn, batches, mask, tables)
        torch.cuda.synchronize()
        outs[name] = {
            "losses": losses, "launches": dict(LAUNCHES),
            "ms_per_step": (time.perf_counter() - t0) * 1e3 / c["T"],
            "leaves": [t.clone() if isinstance(t, torch.Tensor) else
                       np.asarray(t).tolist()
                       for t in tree_leaves(tuple(st))],
            "captures": getattr(fn, "captures", 0),
            "shapes": getattr(fn, "shapes", 0)}
        for k, v in LAUNCHES.items():
            totals[k] = totals.get(k, 0) + v
        del st, fn
    ref = outs["engine"]
    for name in ("async_qsparse", "engine_rounds"):
        o = outs[name]
        same = len(o["leaves"]) == len(ref["leaves"]) and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(o["leaves"], ref["leaves"]))
        if not same or o["losses"] != ref["losses"] or \
                o["launches"] != ref["launches"]:
            raise AssertionError(f"executed staleness: {name} differs from "
                                 "engine.run_faults")
    if not ref["launches"].get("topk_compress"):
        raise AssertionError("executed staleness launched no topk_compress")
    print("async faults " + json.dumps({
        **c, "final_loss": ref["losses"][-1],
        "captures": outs["engine_rounds"]["captures"],
        "round_shapes": outs["engine_rounds"]["shapes"],
        "launches": {k: v for k, v in ref["launches"].items() if v},
        "ms_per_step": {n: o["ms_per_step"] for n, o in outs.items()}}),
        flush=True)
    return totals



# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------


def close_to_scale(out, want, rtol: float, scale: float, what: str) -> float:
    """Hold ``out`` to ``want`` within rtol and ``scale`` times the
    largest |want|; returns the largest absolute difference."""
    import torch
    o, w = out.float(), want.float()
    torch.testing.assert_close(
        o, w, rtol=rtol, atol=scale * float(w.abs().max()),
        msg=lambda m: f"{what}: {m}")
    return float((o - w).abs().max())


def close_per_row(out, want, scale: float, what: str) -> tuple:
    """Hold ``out`` to ``want`` within ``scale`` times the largest |want|
    of each row (the last dim: one position or token and one head), so
    that rows which average many keys, whose outputs are small, are held
    to their own size and not to the largest row's.  Returns the largest
    absolute difference and the largest difference over its row's
    largest |want|."""
    import torch
    o, w = out.float(), want.float()
    diff = (o - w).abs()
    top = w.abs().amax(dim=-1, keepdim=True)
    bad = diff > scale * top
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} outputs differ by "
            f"more than {scale} of their row's largest |output|; worst "
            f"{float((diff / top.clamp_min(1e-30)).max())}")
    return float(diff.max()), float((diff / top.clamp_min(1e-30)).max())


def compact_buffers(g, R: int, n: int, k: int, kcap: int, dev):
    """k ascending random survivors per row, the sentinel (n, 0) after
    them (compress_tree's layout); row 0 empty."""
    import torch
    idx = torch.full((R, kcap), n, dtype=torch.int32, device=dev)
    keys = torch.rand((R, n), generator=g, device=dev)
    idx[:, :k] = torch.sort(torch.topk(keys, k, dim=1).indices,
                            dim=1).values.to(torch.int32)
    val = torch.zeros((R, kcap), device=dev)
    val[:, :k] = torch.randn((R, k), generator=g, device=dev)
    idx[0], val[0] = n, 0.0
    return idx, val


def check_sparse_gemm(dev, M: int, R: int, n: int, k: int, reps: int):
    """sparse_gemm on bf16 activations against its plain version
    (densify, float32 matmul): within 1e-5 of the largest output, float32
    sums in another order.  The library call is torch.matmul against the
    densified float32 weight."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_gemm import sparse_gemm
    g = torch.Generator(device=dev).manual_seed(M + R + n)
    idx, val = compact_buffers(g, R, n, k, 128, dev)
    x = torch.randn((M, n), generator=g, device=dev).to(torch.bfloat16)
    err = close_to_scale(sparse_gemm(x, idx, val, n),
                         ref.sparse_gemm_ref(x, idx, val, n), 1e-5, 1e-5,
                         f"sparse_gemm {M}x{n} -> {R}")
    ms = time_ms(lambda: sparse_gemm(x, idx, val, n), reps)
    plain_ms = time_ms(lambda: ref.sparse_gemm_ref(x, idx, val, n), reps)
    w = torch.zeros((R, n + 1), device=dev)
    w.scatter_add_(1, idx.long(), val)
    w, xf = w[:, :n].contiguous(), x.float()
    library_ms = time_ms(lambda: torch.matmul(xf, w.T), reps)
    nnz = int((idx < n).sum())
    bms, by = bound_ms(8.0 * nnz + 2.0 * M * n + 4.0 * M * R, 2.0 * M * nnz)
    return {"shape": [M, n, R], "kcap": 128, "k_row": k, "nnz": nnz,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by}


def check_qdq_gemm(dev, M: int, R: int, n: int, reps: int):
    """qdq_gemm on a QSGD head (R x n int8 levels: Yi-6B's 64000 x 4096,
    gemma3-1b's tied 262144 x 1152) against its plain version
    (dequantize, float32 matmul): within 1e-5 of the largest output.
    Library call: torch.matmul against the dequantized float32 weight."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_gemm import qdq_gemm
    g = torch.Generator(device=dev).manual_seed(M + R)
    lv = torch.randint(-15, 16, (R, n), generator=g, device=dev,
                       dtype=torch.int8)
    scale = torch.rand((R, 1), generator=g, device=dev) * 0.01
    x = torch.randn((M, n), generator=g, device=dev).to(torch.bfloat16)
    err = close_to_scale(qdq_gemm(x, lv, scale),
                         ref.qdq_gemm_ref(x, lv, scale), 1e-5, 1e-5,
                         f"qdq_gemm {M}x{n} x {R}")
    ms = time_ms(lambda: qdq_gemm(x, lv, scale), reps)
    plain_ms = time_ms(lambda: ref.qdq_gemm_ref(x, lv, scale), reps)
    w, xf = lv.float() * scale, x.float()
    library_ms = time_ms(lambda: torch.matmul(xf, w.T), reps)
    del w
    bms, by = bound_ms(1.0 * R * n + 4.0 * R + 2.0 * M * n + 4.0 * M * R,
                       2.0 * M * R * n)
    return {"shape": [M, n, R], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
            "bound_by": by}


def decode_lengths(g, B: int, dev):
    """Row lengths as the serve run has them: 64-128 prompt tokens plus up
    to 64 decoded; row 0 a free slot (length 0)."""
    import torch
    lengths = torch.randint(64, 193, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0] = 0
    return lengths


def sdpa_ms(q, k, v, live, reps: int) -> float:
    """One F.scaled_dot_product_attention call over already-gathered,
    contiguous KV (expanded to every query head), the yardstick for the
    decode kernels."""
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)                                 # [B, H, 1, hd]
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    mask = live[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), reps)


def check_paged_decode(dev, quant: bool, reps: int):
    """paged_decode at Yi-6B's decode shapes (batch 8, 32 query / 4 kv
    heads of 128, pages of 16, 32 table entries per row, a 256-page
    pool) against its plain version (gather, dequantize, masked softmax):
    within one bf16 rounding (2^-7) of each row's (position and head's)
    largest output, so that a faulty split merge shows; the free slot's
    row exactly zero."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode
    B, H, KV, hd, ps, P, n_pages = 8, 32, 4, 128, 16, 32, 256
    g = torch.Generator(device=dev).manual_seed(10 + int(quant))
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(torch.bfloat16)
    shape = (n_pages, ps, KV, hd)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        ks = torch.rand((n_pages, ps), generator=g, device=dev) * 0.02
        vs = torch.rand((n_pages, ps), generator=g, device=dev) * 0.02
    else:
        kp = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        vp = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        ks = vs = torch.zeros((n_pages, ps), device=dev)
    lengths = decode_lengths(g, B, dev)
    tables = torch.randperm(n_pages, generator=g, device=dev)[:B * P]
    tables = tables.reshape(B, P).to(torch.int32)
    need = ((lengths + ps - 1) // ps).clamp(min=1)
    tables[torch.arange(P, device=dev)[None, :] >= need[:, None]] = -1
    args = (q, kp, vp, ks, vs, tables, lengths)
    out = paged_decode(*args)
    if out[0].any():
        raise AssertionError("paged_decode: a length-0 row is not zero")
    err, row_err = close_per_row(out, ref.paged_decode_ref(*args), 2 ** -7,
                                 f"paged_decode quant={quant}")
    ms = time_ms(lambda: paged_decode(*args), reps)
    plain_ms = time_ms(lambda: ref.paged_decode_ref(*args), reps)
    tbl = tables.long().clamp(min=0)
    kg, vg = kp[tbl].float(), vp[tbl].float()
    if quant:
        kg = kg * ks[tbl][..., None, None]
        vg = vg * vs[tbl][..., None, None]
    kg = kg.reshape(B, P * ps, KV, hd).to(torch.bfloat16)
    vg = vg.reshape(B, P * ps, KV, hd).to(torch.bfloat16)
    live = torch.arange(P * ps, device=dev)[None, :] < lengths[:, None]
    library_ms = sdpa_ms(q, kg, vg, live, reps)
    tokens = int(lengths.sum())
    elem = 1 if quant else 2
    nbytes = (2.0 * tokens * KV * hd * elem + (8.0 * tokens if quant else 0)
              + 2 * 2.0 * B * H * hd + 4.0 * B * P + 4.0 * B)
    bms, by = bound_ms(nbytes, 4.0 * H * hd * tokens)
    return {"shape": [B, H, KV, hd], "pool": [n_pages, ps],
            "quant": quant, "tokens": tokens, "max_abs_err": err,
            "max_row_rel_err": row_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention over gathered KV",
            "bound_ms": bms, "bound_by": by}


def check_flash_decode(dev, reps: int, B=8, H=32, KV=4, hd=128, C=512,
                       lengths=None):
    """flash_decode against its plain version, by default at Yi-6B's
    decode shapes (batch 8, a 512-slot ring cache, 4 kv heads, a validity
    mask per row: the serve run's lengths, row 0 full): within one bf16
    rounding of each row's largest output.  ``lengths`` ([lo, hi)) draws
    the rows' valid slots instead."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_decode
    g = torch.Generator(device=dev).manual_seed(
        20 if lengths is None else 20 + C)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, C, KV, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, C, KV, hd), generator=g, device=dev).to(torch.bfloat16)
    if lengths is None:
        lengths = decode_lengths(g, B, dev)
        lengths[0] = C               # every row needs a valid slot
    else:
        lengths = torch.randint(*lengths, (B,), generator=g, device=dev)
    valid = torch.arange(C, device=dev)[None, :] < lengths[:, None]
    err, row_err = close_per_row(flash_decode(q, k, v, valid),
                                 ref.flash_decode_ref(q, k, v, valid),
                                 2 ** -7, "flash_decode")
    ms = time_ms(lambda: flash_decode(q, k, v, valid), reps)
    plain_ms = time_ms(lambda: ref.flash_decode_ref(q, k, v, valid), reps)
    library_ms = sdpa_ms(q, k, v, valid, reps)
    tokens = int(valid.sum())
    nbytes = 2.0 * tokens * KV * hd * 2 + B * C + 2 * 2.0 * B * H * hd
    bms, by = bound_ms(nbytes, 4.0 * H * hd * tokens)
    return {"shape": [B, H, KV, hd], "cache": C, "tokens": tokens,
            "max_abs_err": err, "max_row_rel_err": row_err, "ms": ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention over the same KV",
            "bound_ms": bms, "bound_by": by}


#: flash_decode correctness cases (B, H, KV, hd, C, slots): gemma3-1b's
#: shapes, a row with no valid slot (the uniform average), splits with no
#: valid slot, one slot, a ragged last chunk, a cache the unsplit kernel
#: refused (8 heads on 16384 slots), head groups that are not a power of 2
DECODE_CASES = (
    (4, 4, 1, 256, 1024, "full"), (4, 4, 1, 256, 2304, "ragged"),
    (4, 4, 1, 256, 1024, "empty_row"), (4, 8, 2, 128, 2304, "empty_split"),
    (3, 8, 2, 64, 1, "full"), (2, 8, 2, 64, 1000, "ragged"),
    (1, 8, 1, 128, 16384, "ragged"), (2, 12, 2, 80, 300, "ragged"),
    (2, 16, 1, 64, 700, "ragged"))


def check_flash_decode_cases(dev) -> dict:
    """flash_decode against its plain version at DECODE_CASES, in float32
    (within 1e-5 of the largest output) and bfloat16 (2^-7 of each row's
    largest output), with a mask per row and one shared mask; the empty
    row against the mean of V.
    Correctness only; returns the largest error per dtype."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_decode
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for B, H, KV, hd, C, slots in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=dev).manual_seed(C + H)
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for shape in ((B, 1, H, hd), (B, C, KV, hd),
                                     (B, C, KV, hd)))
            pos = torch.arange(C, device=dev)[None, :].expand(B, C)
            if slots == "ragged":
                lengths = torch.randint(1, C + 1, (B, 1), generator=g,
                                        device=dev)
                valid = pos < lengths
            elif slots == "empty_split":
                valid = pos >= C - 10
            else:
                valid = pos < C
            if slots == "empty_row":
                valid = valid.clone()
                valid[0] = False
            tol = 2 ** -7 if dtype == torch.bfloat16 else 1e-5
            name = str(dtype).split(".")[1]
            for mask in (valid, valid[0]):
                what = f"flash_decode {name} {[B, H, KV, hd, C]} {slots}"
                out = flash_decode(q, k, v, mask)
                want = ref.flash_decode_ref(q, k, v, mask)
                err = close_per_row(out, want, tol, what)[0] \
                    if dtype == torch.bfloat16 else \
                    close_to_scale(out, want, tol, tol, what)
                errs[name] = max(errs[name], err)
                if slots == "empty_row":
                    mean = v[0].float().mean(dim=0).repeat_interleave(
                        H // KV, dim=0)
                    close_to_scale(out[0, 0], mean, tol, tol, what)
    torch.cuda.synchronize()
    return errs


def live_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal (window > 0: sliding-window) mask
    keeps in a sequence of S positions."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def kernel_names(fn) -> list:
    """The device kernels one call of ``fn`` runs (torch.profiler); empty
    where the profiler records no device activity."""
    import torch
    fn()
    torch.cuda.synchronize()
    if TIMING["clock"] != "profiler":
        return []
    return sorted({e.name for e in _device_events(fn, 1)})


def sdpa_backend(names: list) -> str:
    """The backend scaled_dot_product_attention ran, from its kernels'
    names (cuDNN's own names say "flash" too, so it is tested first);
    "not measured" without them."""
    if not names:
        return "not measured"
    joined = " ".join(names).lower()
    for key, backend in (("cudnn", "cudnn"), ("flash", "flash"),
                         ("fmha", "efficient"), ("efficient", "efficient")):
        if key in joined:
            return backend
    return "math"


def check_flash_attention(dev, B: int, S: int, H: int, KV: int, D: int,
                          window: int, reps: int):
    """flash_attention_fwd in bf16 (the tensor-core route) against its
    plain version (float32 scores, a masked softmax): within one bf16
    rounding (2^-7) of the largest output of each row (position and
    head), the rounding of P to bf16 and of the output.
    The bound counts the live (causal / window) pairs: 4 D operations per
    pair and query head at the bf16 tensor-core peak (989 TFLOP/s)
    against q, k, v and the output moved once; ``bound_f32_ms`` is the
    same operations at the float32 peak outside the tensor cores (67
    TFLOP/s), the bound of the float32 FMA route.  Library call:
    scaled_dot_product_attention on the same tensors, K and V repeated
    per group, is_causal for the global form and a boolean window mask
    for the local one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        ROUTES, flash_attention_fwd, split_tiles)
    g = torch.Generator(device=dev).manual_seed(S + H + max(window, 0))
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(
        torch.bfloat16) for h in (H, KV, KV))
    out = flash_attention_fwd(q, k, v, window=window)
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("flash_attention: non-finite output")
    err, row_err = close_per_row(
        out, ref.flash_attention_ref(q, k, v, window=window), 2 ** -7,
        f"flash_attention S={S} H={H} D={D} w={window}")
    del out
    ms = time_ms(lambda: flash_attention_fwd(q, k, v, window=window), reps)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                       window=window),
                       max(1, reps // 2))
    G = H // KV
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    if window > 0:
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] > pos[:, None] - window)

        def lib():
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=mask)
    else:
        def lib():
            return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    library_ms = time_ms(lib, reps)
    names = kernel_names(lib)
    pairs = B * live_pairs(S, window)
    ops = 4.0 * D * H * pairs
    nbytes = 2.0 * B * S * D * (2 * H + 2 * KV)
    bms, by = bound_ms(nbytes, ops, BF16_OPS_PER_S)
    return {"shape": [B, S, H, KV, D], "window": window, "dtype": "bfloat16",
            "route": ROUTES[torch.bfloat16],
            "split_tiles": split_tiles(S, H, KV, D, window),
            "live_pairs": pairs, "max_abs_err": err,
            "max_row_rel_err": row_err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention",
            "library_backend": sdpa_backend(names),
            "library_kernels": [n[:100] for n in names], "bound_ms": bms,
            "bound_by": by,
            "bound_f32_ms": ops / F32_OPS_PER_S * 1e3}


def phase_flash_kernels(dev):
    """flash_attention at the shapes prefill gives it: gemma3-1b's (one
    2048-token prompt, 4 query heads on one kv head of 256) under its
    1024 window and global, a ragged 1100-token prompt, and Yi-6B's
    heads (32 on 4 of 128), causal.  Then the unscanned gemma3-1b serve
    run's other kernels at its own shapes: sparse_gemm at prefill (2048
    rows; w1's 1152 -> 6912 at k 12, w2's 6912 -> 1152 at k 69) and at
    decode (batch 4: w1 / w3, w2, wq 1152 -> 1024, wo 1024 -> 1152 at k
    10, wk / wv 1152 -> 256), qdq_gemm on the tied 262144 x 1152 head at decode
    (batch 4) and for a prefill's last token, and flash_decode at batch 4
    over a 1024-slot window ring (full) and the 2304-slot global ring
    (1100-2080 valid slots), then flash_decode's correctness cases
    (DECODE_CASES).  Returns the timed flash_attention rows, the gemma3-1b
    flash_decode rows and the gemma3-1b GEMM rows by kernel."""
    rows = [check_flash_attention(dev, 1, 2048, 4, 1, 256, 1024, 10),
            check_flash_attention(dev, 1, 2048, 4, 1, 256, -1, 10),
            check_flash_attention(dev, 1, 1100, 4, 1, 256, 1024, 10),
            check_flash_attention(dev, 1, 2048, 32, 4, 128, -1, 10)]
    for row in rows:
        print("kernel check flash_attention", json.dumps(row), flush=True)
    gemm = {"sparse_gemm": [check_sparse_gemm(dev, 2048, 6912, 1152, 12, 5),
                            check_sparse_gemm(dev, 2048, 1152, 6912, 69, 5),
                            check_sparse_gemm(dev, 4, 6912, 1152, 12, 20),
                            check_sparse_gemm(dev, 4, 1152, 6912, 69, 20),
                            check_sparse_gemm(dev, 4, 1024, 1152, 12, 20),
                            check_sparse_gemm(dev, 4, 1152, 1024, 10, 20),
                            check_sparse_gemm(dev, 4, 256, 1152, 12, 20)],
            "qdq_gemm": [check_qdq_gemm(dev, 4, 262144, 1152, 10),
                         check_qdq_gemm(dev, 1, 262144, 1152, 10)]}
    for name, checks in gemm.items():
        for row in checks:
            print("kernel check", name, "(gemma3-1b)", json.dumps(row),
                  flush=True)
    decode = []
    for C, lengths in ((1024, (1024, 1025)), (2304, (1100, 2081))):
        decode.append(check_flash_decode(dev, 10, B=4, H=4, KV=1, hd=256,
                                         C=C, lengths=lengths))
        print("kernel check flash_decode (gemma3-1b decode)",
              json.dumps(decode[-1]), flush=True)
    errs = check_flash_decode_cases(dev)
    print(f"kernel check flash_decode: {len(DECODE_CASES)} cases x 2 dtypes "
          f"x 2 mask forms agree, largest error {errs}", flush=True)
    return rows, decode, gemm


def phase_serve_kernels(dev):
    """The serving kernels at the Yi-6B serve run's shapes: the Top_k
    matmuls at decode (batch 8: w1 / w3, w2, wq / wo, wk / wv) and at
    prefill (128 prompt tokens), the QSGD head at decode and for the
    prefill's last token, the page pool in bf16 and int8, the ring
    cache."""
    rows = {
        "sparse_gemm": [check_sparse_gemm(dev, 8, 11008, 4096, 41, 20),
                        check_sparse_gemm(dev, 8, 4096, 11008, 110, 20),
                        check_sparse_gemm(dev, 8, 4096, 4096, 41, 20),
                        check_sparse_gemm(dev, 8, 512, 4096, 41, 20),
                        check_sparse_gemm(dev, 128, 11008, 4096, 41, 5)],
        "qdq_gemm": [check_qdq_gemm(dev, 8, 64000, 4096, 10),
                     check_qdq_gemm(dev, 1, 64000, 4096, 10)],
        "paged_decode": [check_paged_decode(dev, False, 20),
                         check_paged_decode(dev, True, 20)],
        "flash_decode": [check_flash_decode(dev, 20)],
    }
    for name, checks in rows.items():
        for row in checks:
            print("kernel check", name, json.dumps(row), flush=True)
    return rows


def serve_requests(eng, vocab: int, spec: dict) -> None:
    import numpy as np
    rng = np.random.RandomState(spec["seed"])
    for _ in range(spec["requests"]):
        plen = int(rng.randint(spec["prompt_min"], spec["prompt_pad"] + 1))
        eng.submit(rng.randint(0, vocab, plen).tolist(),
                   max_new_tokens=spec["new_tokens"])


class FiniteLogits:
    """For one engine run, one device flag: every decode step's logits
    were finite.  Read from the engine's static ``logits`` buffer after
    each step that decoded, so a graphed run (whose model calls run only
    at its capture) is read as an eager one is."""

    def __init__(self, eng):
        self.eng, self.steps, self.flag = eng, eng.steps, None

    def after_step(self) -> None:
        if self.eng.steps == self.steps:
            return
        self.steps = self.eng.steps
        ok = self.eng.logits.isfinite().all()
        self.flag = ok if self.flag is None else self.flag & ok

    @property
    def ok(self) -> bool:
        return self.flag is not None and bool(self.flag)


def engine_run(params, cfg, layout: dict, spec: dict, graphs: bool) -> dict:
    """One ServeEngine run of ``spec``'s requests, graphed or eager
    (``cuda_graphs``): every step timed on the host clock (a step ends in
    a device-to-host copy of the next tokens, so it is synchronous);
    steps that admitted requests also ran their prefills, each step's
    admissions timed by CUDA events around them (ms a prefill: the
    median over the admitting steps after the first, and the first,
    which ran the warm-ups and the admission's capture).  Returns the
    tokens, the counters, the captures and the times."""
    import gc
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.serve import compressed as sc
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, max_batch=spec["max_batch"],
                      max_len=spec["max_len"],
                      prompt_pad=spec["prompt_pad"],
                      dispatch=DispatchConfig(mode=DISPATCH),
                      cuda_graphs=graphs, **layout)
    serve_requests(eng, cfg.vocab, spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.reset_stats()
    reset_launches()
    decode_ms, admit_ms, admits = [], [], []
    admit = eng._admit

    def timed_admit():
        # CUDA events around the step's admissions: the stream's time
        # from their start to their end (the host waits on the previous
        # step's tokens, so the stream is idle when the first is recorded)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        n = admit()
        ev[1].record()
        if n:
            admits.append((ev, n))
        return n

    eng._admit = timed_admit
    finite = FiniteLogits(eng)
    t0 = time.perf_counter()
    while eng.pending:
        before = eng.admissions
        t = time.perf_counter()
        eng.step()
        ms = (time.perf_counter() - t) * 1e3
        finite.after_step()
        (admit_ms if eng.admissions > before else decode_ms).append(ms)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    # ms a prefill: the first admitting step ran each graph's warm-up and
    # capture, so it stands apart
    per_prefill = [ev[0].elapsed_time(ev[1]) / n for ev, n in admits]
    out = {"launches": dict(LAUNCHES), "stats": dict(sc.STATS),
           "finite": finite.ok, "captures": eng.captures,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    res = eng.run()                  # nothing pending: collects the results
    step = float(np.median(decode_ms))
    ttft = [m.ttft_s * 1e3 for m in res["metrics"].values()]
    out.update(
        outputs=res["outputs"], steps=eng.steps, prefills=eng.admissions,
        pool=res.get("pool"),
        decode_ms_per_step=step, decode_ms_mean=float(np.mean(decode_ms)),
        admit_step_ms_mean=float(np.mean(admit_ms)),
        admit_ms_per_prefill=float(np.median(per_prefill[1:])),
        admit_ms_first_step=per_prefill[0],
        ttft_ms_min=min(ttft), ttft_ms_p50=float(np.median(ttft)),
        ttft_ms_max=max(ttft),
        tokens_per_s=sum(len(t) for t in res["outputs"].values()) / wall,
        wall_s=wall)
    del eng, res
    gc.collect()                     # the graphs hold the engine's bodies
    torch.cuda.empty_cache()
    return out


def serve_run(params, cfg, name: str, layout: dict, dev, spec: dict,
              want_fn):
    """``spec``'s requests served graphed (the engine's default on the
    card, the main path) and then eager (``cuda_graphs=False``) in this
    process: the same greedy tokens, ``LAUNCHES`` and ``STATS``, one
    decode and one admission capture in the graphed run and none in the
    eager one.  ``want_fn(steps, prefills)`` gives the launches each
    kernel must have made; every logit must be finite.  Prints both
    runs' times and returns the graphed run's launches and tokens."""
    runs = {"graphed": engine_run(params, cfg, layout, spec, True),
            "eager": engine_run(params, cfg, layout, spec, False)}
    g, e = runs["graphed"], runs["eager"]
    for mode, r in runs.items():
        want = want_fn(r["steps"], r["prefills"])
        for k, v in r["launches"].items():
            if v != want.get(k, 0):
                raise AssertionError(
                    f"{name} {mode}: {v} {k} launches, want "
                    f"{want.get(k, 0)} ({r['steps']} decode steps, "
                    f"{r['prefills']} prefills)")
        if r["stats"]["densify"]:
            raise AssertionError(f"{name} {mode}: densified "
                                 f"{r['stats']['densify']}")
        if not r["finite"]:
            raise AssertionError(f"{name} {mode}: non-finite logits")
        outs = r["outputs"]
        if sorted(outs) != list(range(spec["requests"])) or any(
                len(t) != spec["new_tokens"] or min(t) < 0
                or max(t) >= cfg.vocab for t in outs.values()):
            raise AssertionError(f"{name} {mode}: bad outputs")
    if g["captures"] != {"decode": 1, "admit": 1} or \
            e["captures"] != {"decode": 0, "admit": 0}:
        raise AssertionError(f"{name}: captures graphed {g['captures']}, "
                             f"eager {e['captures']}")
    for key in ("outputs", "launches", "stats", "steps", "prefills"):
        if g[key] != e[key]:
            raise AssertionError(f"{name}: graphed and eager {key} differ")
    # launches per decode step (decode attention), per prefill (prefill
    # attention) or per step or prefill (the GEMMs)
    per = {"flash_decode": g["steps"], "paged_decode": g["steps"],
           "flash_attention": g["prefills"]}
    calls = g["steps"] + g["prefills"]
    timed = ("decode_ms_per_step", "decode_ms_mean", "admit_step_ms_mean",
             "admit_ms_per_prefill", "admit_ms_first_step", "ttft_ms_min",
             "ttft_ms_p50",
             "ttft_ms_max", "tokens_per_s", "wall_s", "peak_device_bytes")
    row = {"run": name, "steps": g["steps"], "prefills": g["prefills"],
           **{k: g[k] for k in timed},
           "eager": {k: e[k] for k in timed},
           "speedup": {k: e[k] / g[k] for k in (
               "decode_ms_per_step", "admit_ms_per_prefill", "ttft_ms_p50")},
           "tokens_equal": True, "captures": g["captures"],
           "launches_per_call": {k: v / per.get(k, calls)
                                 for k, v in g["launches"].items() if v},
           "launches": {k: v for k, v in g["launches"].items() if v}}
    if layout.get("paged"):
        pool = g["pool"]
        row.update(peak_pool_pages=pool["peak_pages_used"],
                   n_pages=pool["n_pages"], preemptions=pool["preemptions"],
                   admission_stalls=pool["admission_stalls"])
    print("serve", json.dumps(row), flush=True)
    return g["launches"], g["outputs"]


def phase_serve(dev):
    """Yi-6B at full width and depth, random bf16 weights from a seeded
    generator, compressed at load under lm_hetero (the dense tree is let
    go), then served three times.  Returns the kernel launches summed
    over the three runs."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_policy_preset
    from repro_torch.models import transformer as tf
    from repro_torch.serve import compressed as sc
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config("yi-6b"), use_pallas=True)
    t0 = time.perf_counter()
    params = tf.init_params(
        torch.Generator(device=dev).manual_seed(SERVE["seed"]), cfg,
        device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"yi-6b has {n_params} parameters, want "
                             f"{cfg.param_count()}")
    params = sc.compress_tree(params, get_policy_preset("arch", "yi-6b"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sizes = sc.tree_bytes(params)
    print(f"yi-6b {n_params} parameters, resident {sizes['compressed']} "
          f"bytes compressed (dense {sizes['dense']}), init + compress "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    totals = {}
    for name, layout in (
            ("paged bf16", {"paged": True, "page_size": SERVE["page_size"]}),
            ("paged int8", {"paged": True, "page_size": SERVE["page_size"],
                            "kv_quant": True}),
            ("contiguous", {})):
        attn = "paged_decode" if layout.get("paged") else "flash_decode"

        def want(steps, prefills, attn=attn):
            calls = steps + prefills
            return {"sparse_gemm": 7 * YI_LAYERS * calls, "qdq_gemm": calls,
                    attn: YI_LAYERS * steps}

        for k, v in serve_run(params, cfg, name, layout, dev, SERVE,
                              want)[0].items():
            totals[k] = totals.get(k, 0) + v
    del params
    torch.cuda.empty_cache()
    return totals


def phase_serve_flash(dev, tmp: str):
    """gemma3-1b at full width and depth (999,812,736 parameters),
    unscanned (a list of 26 per-layer dicts) so that prefill runs
    the flash-attention kernel, random bf16 weights from a seeded
    generator, compressed at load under lm_hetero, served contiguous by
    the continuous scheduler: 8 prompts of 1100-2048 tokens (past the
    1024 window) padded to 2048, 32 new tokens each.  The compressed tree
    is then saved as a compact-v1 checkpoint under ``tmp`` and dropped.
    Returns the launches, and what the checkpoint phase holds the saved
    tree to: its path, config, bytes, greedy tokens and seconds to save."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_policy_preset
    from repro_torch.models import transformer as tf
    from repro_torch.serve import compressed as sc
    from repro_torch.train import checkpoint
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(FLASH_SERVE["arch"]),
                              scan_layers=False, use_pallas=True)
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = tf.init_params(
        torch.Generator(device=dev).manual_seed(FLASH_SERVE["seed"]), cfg,
        device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    if n_params != cfg.param_count() or len(params["layers"]) != L:
        raise AssertionError(f"{cfg.name}: {n_params} parameters in "
                             f"{len(params['layers'])} layers")
    policy = get_policy_preset("arch", FLASH_SERVE["arch"])
    params = sc.compress_tree(params, policy)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sizes = sc.tree_bytes(params)
    print(f"{cfg.name} unscanned: {n_params} parameters, resident "
          f"{sizes['compressed']} bytes compressed (dense {sizes['dense']}), "
          f"init + compress {time.perf_counter() - t0:.1f}s", flush=True)

    def want(steps, prefills):
        calls = steps + prefills
        return {"flash_attention": L * prefills, "flash_decode": L * steps,
                "sparse_gemm": 7 * L * calls, "qdq_gemm": calls}

    launches, outs = serve_run(params, cfg, f"{cfg.name} unscanned "
                               "contiguous", {}, dev, FLASH_SERVE, want)
    saved = {"path": os.path.join(tmp, "compact_unscanned"), "cfg": cfg,
             "sizes": sizes, "outputs": outs, "want": want}
    t0 = time.perf_counter()
    checkpoint.save_compact(saved["path"], params, step=0,
                            policy=policy.to_dict())
    saved["save_s"] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    return launches, saved


def phase_serve_agreement(dev, arch: str = "yi-6b", unscanned: bool = False):
    """A smoke model in float32 on the card, compressed under its
    preset, with dispatch "kernel" (the CUDA kernels) against "reference"
    (their plain versions): prefill and decode logits within rtol 1e-4 /
    atol 1e-4 (float32 sums in another order), the same greedy tokens
    from paged, paged-int8 and contiguous engines (contiguous only for an
    unscanned stack, whose prefill runs the flash-attention kernel)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_policy_preset
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import transformer as tf
    from repro_torch.serve import compressed as sc
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config(arch, smoke=True), use_pallas=True,
                              scan_layers=not unscanned)
    params = sc.compress_tree(
        tf.init_params(torch.Generator(device=dev).manual_seed(1), cfg,
                       device=dev), get_policy_preset("arch", arch))
    modes = {m: DispatchConfig(mode=m) for m in ("kernel", "reference")}
    toks = torch.randint(0, cfg.vocab, (3, 21), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    logits = {}
    for m, dcfg in modes.items():
        reset_launches()
        lg, cache, _ = tf.prefill(params, {"tokens": toks}, cfg, dcfg,
                                  max_len=32)
        want = cfg.n_layers if unscanned and m == "kernel" else 0
        if LAUNCHES["flash_attention"] != want:
            raise AssertionError(f"{arch}: {LAUNCHES['flash_attention']} "
                                 f"flash_attention launches, want {want}")
        out = [lg[:, 0]]
        tok = lg[:, 0].argmax(-1)
        for pos in range(21, 25):
            lg, cache = tf.decode_step(params, cache, tok, pos, cfg, dcfg)
            out.append(lg)
            tok = lg.argmax(-1)
        logits[m] = torch.stack(out)
    torch.testing.assert_close(logits["kernel"], logits["reference"],
                               rtol=1e-4, atol=1e-4)
    err = float((logits["kernel"] - logits["reference"]).abs().max())
    reqs = [([5, 6, 7], 12), ([1], 9), ([9, 8, 7, 6, 5], 14), ([3, 3], 10),
            ([11, 2, 4, 200, 17], 11), ([8], 8)]
    kw = dict(max_batch=3, max_len=24, prompt_pad=6)
    layouts = [{"paged": True, "page_size": 4},
               {"paged": True, "page_size": 4, "kv_quant": True}, {}]
    if unscanned:
        # prompts past the smoke gemma3's 16-token window
        reqs = [(list(range(1, 20)), 12), ([1], 9), ([9, 8] * 9, 14),
                ([3, 3], 10), (list(range(40, 57)), 11), ([8], 8)]
        kw = dict(max_batch=3, max_len=40, prompt_pad=20)
        layouts = layouts[2:]
    for layout in layouts:
        outs = {}
        for m, dcfg in modes.items():
            # the kernels graphed (the engine's default on the card), the
            # plain versions eager: a graphed reference engine raises
            eng = ServeEngine(params, cfg, dispatch=dcfg, **kw, **layout,
                              cuda_graphs="auto" if m == "kernel" else False)
            for p, n in reqs:
                eng.submit(p, n)
            outs[m] = eng.run()["outputs"]
            want = {"decode": 1, "admit": 1} if m == "kernel" else {
                "decode": 0, "admit": 0}
            if eng.captures != want:
                raise AssertionError(f"serve agreement {layout} {m}: "
                                     f"captures {eng.captures}")
        if outs["kernel"] != outs["reference"]:
            raise AssertionError(f"serve agreement {layout}: tokens differ")
    try:
        ServeEngine(params, cfg, dispatch=modes["reference"], **kw,
                    **layouts[-1])
    except ValueError as exc:
        refused = str(exc)
    else:
        raise AssertionError("a graphed engine under reference dispatch "
                             "did not raise")
    where = ("contiguous" if unscanned
             else "paged / paged-int8 / contiguous")
    print(f"serve agreement {arch}{' unscanned' if unscanned else ''}: "
          f"logits within {err:.3g}, tokens equal on {where} (kernels "
          f"graphed, plain versions eager)", flush=True)
    print(f"serve agreement: a graphed reference engine raises: {refused}",
          flush=True)


# ---------------------------------------------------------------------------
# the distributed LM training path
# ---------------------------------------------------------------------------


def check_compact(dev, rows: int, n: int, k: int, kcap: int, sign: bool,
                  reps: int, ties: bool = False):
    """topk_compact against its plain version: idx, counts and sentinels
    exactly; plain Top_k values and memory bit for bit; SignTop_k values
    within rtol 1e-6 (its norm is a float sum in another order) and the
    memory at the emitted slots within that error, exact elsewhere.
    ``ties``: rows of equal magnitudes, every element a survivor, so the
    first kcap are emitted and the rest stay in the memory."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.topk_compress import topk_compact
    g = torch.Generator(device=dev).manual_seed(rows + n + k)
    if ties:
        x = torch.where(torch.rand((rows, n), generator=g, device=dev) < 0.5,
                        -1.5, 1.5)
        x[:, :5] = 3.0
    else:
        x = torch.randn((rows, n), generator=g, device=dev)
    idx, val, mem, cnt = topk_compact(x, k, kcap, sign=sign)
    idx_r, val_r, mem_r, cnt_r = ref.topk_compact_ref(x, k, kcap, sign=sign)
    torch.cuda.synchronize()
    what = f"topk_compact {rows}x{n} k={k} sign={sign} ties={ties}"
    if not (torch.equal(cnt, cnt_r) and torch.equal(idx, idx_r)):
        raise AssertionError(f"{what}: slots or counts differ")
    empty = torch.arange(kcap, device=dev)[None, :] >= cnt[:, None]
    if not (bool((idx[empty] == n).all()) and bool((val[empty] == 0).all())):
        raise AssertionError(f"{what}: sentinels wrong")
    if ties and not bool((cnt == kcap).all()):
        raise AssertionError(f"{what}: the tied rows did not fill kcap")
    err = max(float((val - val_r).abs().max()),
              float((mem - mem_r).abs().max()))
    if sign:
        torch.testing.assert_close(val, val_r, rtol=1e-6, atol=0)
        emitted = torch.zeros_like(x, dtype=torch.bool)
        at = torch.arange(rows, device=dev)[:, None].expand_as(idx)
        emitted[at[~empty], idx[~empty].long()] = True
        if not torch.equal(mem[~emitted], mem_r[~emitted]):
            raise AssertionError(f"{what}: memory off the emitted slots")
        torch.testing.assert_close(
            mem[emitted], mem_r[emitted], rtol=1e-6,
            atol=1e-6 * float(val_r.abs().max()))
    elif err != 0.0:
        raise AssertionError(f"{what}: values differ by {err}")
    out = {"shape": [rows, n], "k": k, "kcap": kcap, "sign": sign,
           "ties": ties, "max_abs_err": err,
           "survivors": int(cnt.sum())}
    del idx, val, mem, cnt, idx_r, val_r, mem_r, cnt_r
    if reps:
        out["ms"] = time_ms(lambda: topk_compact(x, k, kcap, sign=sign),
                            reps)
        out["plain_ms"] = time_ms(
            lambda: ref.topk_compact_ref(x, k, kcap, sign=sign), 2)
        out["library_ms"] = time_ms(lambda: torch.topk(x.abs(), k, dim=1),
                                    reps)
        elems, iters = rows * n, 24
        out["bound_ms"], out["bound_by"] = bound_ms(
            8.0 * elems + 8.0 * rows * kcap + 4.0 * rows,
            3.0 * (iters + 4) * elems)
    return out


def phase_lm_kernels(dev):
    """The compression kernels at the LM path's shapes (gemma3-1b under
    lm_hetero compresses each stack along its 1152-wide axis, k 12, kcap
    128): topk_compact (the sparse wire) at w1 / w2 / w3's 179,712 rows
    and wq / wo's 26,624, sign and not, at wk / wv's 6,656, and on a
    heavy-tie block that overflows kcap; topk_compress (the dense wire)
    at w1 / w2 / w3's rows, sign and not, wq / wo's 26,624 and wk / wv's
    6,656."""
    rows = [check_compact(dev, 179712, 1152, 12, 128, False, 10),
            check_compact(dev, 179712, 1152, 12, 128, True, 10),
            check_compact(dev, 26624, 1152, 12, 128, False, 10),
            check_compact(dev, 26624, 1152, 12, 128, True, 10),
            check_compact(dev, 6656, 1152, 12, 128, False, 10),
            check_compact(dev, 4096, 1152, 12, 128, False, 0, ties=True),
            check_compact(dev, 4096, 1152, 12, 128, True, 0, ties=True)]
    for row in rows:
        print("kernel check topk_compact", json.dumps(row), flush=True)
    dense = [check_topk(dev, 179712, 1152, 12, False, 10),
             check_topk(dev, 179712, 1152, 12, True, 10),
             check_topk(dev, 26624, 1152, 12, False, 10),
             check_topk(dev, 6656, 1152, 12, False, 10)]
    for row in dense:
        print("kernel check topk_compress", json.dumps(row), flush=True)
    return rows, dense


def lm_run(wire: str, dev, ckpt=None, runtime: str = "round",
           extra: tuple = ()):
    """The launcher on gemma3-1b at full size, R = 1: returns its record
    and the launches it made (counted from 0 at its start).  ``ckpt``: a
    directory for the launcher's ``--ckpt`` (the master at the end);
    ``extra``: more flags (a scenario)."""
    import numpy as np
    import torch
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.launch import train as lt
    argv = ["--arch", LM["arch"], "--mesh", "1x1", "--policy", "preset:arch",
            "--batch", str(LM["batch"]), "--seq", str(LM["seq"]),
            "--steps", str(LM["steps"]), "--H", str(LM["H"]),
            "--wire", wire, "--dispatch", DISPATCH, "--runtime", runtime,
            *extra]
    if ckpt:
        argv += ["--ckpt", ckpt]
    _free_graphs()
    torch.cuda.synchronize()
    reset_launches()
    rec = lt.main(argv)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _free_graphs()
    kinds = rec["kind"]
    n_syncs = kinds.count("sync")
    kern = "topk_compact" if wire == "sparse_allgather" else "topk_compress"
    want = {kern: LM["topk_stacks"] * n_syncs}
    for k, v in launches.items():
        if v != want.get(k, 0):
            raise AssertionError(f"LM {wire}: {v} {k} launches in {n_syncs} "
                                 f"syncs, want {want.get(k, 0)}")
    if rec["n_params"] != LM["n_params"]:
        raise AssertionError(f"gemma3-1b has {rec['n_params']} parameters")
    if not all(np.isfinite(rec["loss"])):
        raise AssertionError(f"LM {wire}: loss not finite: {rec['loss']}")
    if runtime == "round" and (rec["fused"] is not True
                               or rec["captures"] != lm_captures(kinds)):
        raise AssertionError(f"LM {wire}: fused {rec['fused']}, captures "
                             f"{rec['captures']}")
    ups, prev = [], 0.0
    for kind, b in zip(kinds, rec["bits_up"]):
        if kind == "sync":
            ups.append(b - prev)
        prev = b
    # ms a round: the round runtime's own, the per-step runtime's summed
    # over each round's steps
    round_ms = rec.get("round_ms") or [
        sum(rec["ms"][i:i + LM["H"]])
        for i in range(0, LM["steps"], LM["H"])]
    late = round_ms[2:] or round_ms[-1:]
    row = {"wire": wire, "runtime": runtime, "loss": rec["loss"],
           "ms_per_step": rec["ms"], "ms_per_round": round_ms,
           "ms_per_step_median": float(np.median(late)) / LM["H"],
           "bits_up_per_sync": ups, "bits_down": rec["bits_down"][-1],
           "peak_device_bytes": rec["peak_device_bytes"],
           "ckpt_s": rec.get("ckpt_s"), "captures": rec.get("captures", 0),
           "launches_per_sync": {k: v / n_syncs for k, v in launches.items()
                                 if v},
           "launches": {k: v for k, v in launches.items() if v}}
    print("lm", json.dumps(row), flush=True)
    return row, launches, rec


def lm_captures(kinds: list) -> int:
    """The round graphs of a launcher run at one rank: the (length, sync)
    round shapes that occur at least twice (the last step always closes
    a round)."""
    shapes, start = {}, 0
    for t, kind in enumerate(kinds):
        if kind == "sync" or t == len(kinds) - 1:
            key = (t - start + 1, kind)
            shapes[key] = shapes.get(key, 0) + 1
            start = t + 1
    return sum(n > 1 for n in shapes.values())


#: the launcher under a fleet scenario: gemma3-1b at R = 1 on the sparse
#: wire, and the smoke model at LM_RANKS' ranks on both wires
LM_SCENARIO = ("--scenario", "preset:dropout", "--aggregate", "mean_S")


def phase_lm_scenario(dev) -> dict:
    """gemma3-1b at full size through the launcher under
    ``--scenario preset:dropout --aggregate mean_S`` on the sparse wire
    (the mesh's partial participation), graphed against ``--runtime
    step``: the same record; ``topk_compact`` launched 7 times a sync."""
    runs, totals = {}, {}
    for runtime in ("round", "step"):
        row, launches, rec = lm_run("sparse_allgather", dev, None, runtime,
                                    LM_SCENARIO)
        runs[runtime] = rec
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
    a, b = runs["round"], runs["step"]
    for k in ("loss", "kind", "bits_up", "bits_down", "launches_per_sync",
              "rounds"):
        if a[k] != b[k]:
            raise AssertionError(f"LM scenario: {k} differs between the "
                                 f"runtimes: {a[k]} / {b[k]}")
    if not totals.get("topk_compact"):
        raise AssertionError("LM scenario: no topk_compact launch")
    print(f"lm scenario {' '.join(LM_SCENARIO)}: round runtime equals "
          f"--runtime step; kinds {a['kind']}, captures {a['captures']}",
          flush=True)
    return totals


def phase_lm(dev, ckpt: str = None):
    """gemma3-1b through the launcher on both wires, each under the round
    runtime (the default: each round a CUDA graph) and ``--runtime
    step`` (eager): the same record step by step (losses, kinds, both
    ledgers, launches per sync).  The uplink bits of each sync agree
    between the wires to the float rounding of the counted survivors
    (the same survivors, one ledger in another layout).  The dense-wire
    round run writes its master to ``ckpt`` (``--ckpt``) where one is
    given."""
    runs, totals = {}, {}
    for wire, path in (("sparse_allgather", None), ("dense_psum", ckpt)):
        for runtime in ("round", "step"):
            row, launches, rec = lm_run(wire, dev,
                                        path if runtime == "round" else None,
                                        runtime)
            runs[wire, runtime] = (row, rec)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
        a, b = runs[wire, "round"][1], runs[wire, "step"][1]
        for k in ("loss", "kind", "bits_up", "bits_down",
                  "launches_per_sync", "rounds"):
            if a[k] != b[k]:
                raise AssertionError(f"LM {wire}: {k} differs between the "
                                     f"runtimes: {a[k]} / {b[k]}")
        print(f"lm {wire}: round runtime equals --runtime step; ms a step "
              f"{runs[wire, 'round'][0]['ms_per_step_median']:.1f} graphed, "
              f"{runs[wire, 'step'][0]['ms_per_step_median']:.1f} eager",
              flush=True)
    sparse, dense = (runs[w, "round"][0] for w in ("sparse_allgather",
                                                    "dense_psum"))
    for a, b in zip(sparse["bits_up_per_sync"], dense["bits_up_per_sync"]):
        # one float32 rounding of a ledger near 4e8 bits is 32 bits
        if abs(a - b) > 2.0 ** -23 * max(abs(a), abs(b)):
            raise AssertionError(f"uplink bits per sync: sparse {a} vs "
                                 f"dense {b}")
    diff = max(abs(a - b) for a, b in zip(sparse["bits_up_per_sync"],
                                          dense["bits_up_per_sync"]))
    print(f"lm wires: uplink bits per sync differ by at most {diff} "
          f"(sparse {sparse['bits_up_per_sync']}, dense "
          f"{dense['bits_up_per_sync']})", flush=True)
    return totals


def _rank_run(tmp: str, tag: str, wire: str, dispatch: str,
              runtime: str = "round", backend: str = "gloo",
              ranks: int = LM_RANKS["ranks"], extra: tuple = ()) -> dict:
    """The launcher on the gemma3-1b smoke model at ``ranks`` ranks (by
    default LM_RANKS' ranks sharing the card over gloo; under NCCL one
    rank a card), with ``extra`` flags (a scenario): rank 0's run record
    (--json) and the path of its master (--ckpt)."""
    from repro_torch.launch.mesh import run_local_ranks
    ckpt, record = os.path.join(tmp, tag), os.path.join(tmp, tag + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LM["arch"], "--smoke", "--mesh", f"{ranks}x1",
           "--steps", str(LM_RANKS["steps"]), "--H", str(LM_RANKS["H"]),
           "--policy", "preset:arch", "--backend", backend, "--wire", wire,
           "--dispatch", dispatch, "--ckpt", ckpt, "--json", record,
           "--runtime", runtime, *extra]
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = run_local_ranks(cmd, ranks, env=env, timeout=300)
    for r, (rc, _out, err) in enumerate(procs):
        if rc != 0:
            raise AssertionError(f"rank {r} of {tag} exited {rc}:\n"
                                 f"{err[-3000:]}")
    with open(record) as f:
        rec = json.load(f)
    if len(rec["loss"]) != LM_RANKS["steps"] or rec["R"] != ranks:
        raise AssertionError(f"{tag}: {len(rec['loss'])} steps, R={rec['R']}")
    rec["ckpt"] = ckpt
    return rec


def phase_lm_ranks(dev):
    """Multi-rank agreement on the one card (the collective path with
    R > 1): dispatch "kernel" (the CUDA kernels) against "reference"
    (their plain versions) gives the same losses and equal wire bits on
    the sparse wire; the sparse wire against the dense one gives equal
    bits and masters within rtol 1e-5 / atol 1e-6 (the mean of R
    payloads summed in another order).  Under gloo a collective on the
    card is staged through the host, which no CUDA graph holds: the
    round runtime (the default) is the per-step composition there
    (``fused`` False), and equals ``--runtime step``."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(
            SRC, "repro_torch", "kernels", "build")) as tmp:
        runs = {tag: _rank_run(tmp, tag, wire, dispatch, runtime, extra=ex)
                for tag, wire, dispatch, runtime, ex in (
                    ("sparse_kernel", "sparse_allgather", "kernel", "round",
                     ()),
                    ("sparse_reference", "sparse_allgather", "reference",
                     "round", ()),
                    ("dense_kernel", "dense_psum", "kernel", "round", ()),
                    ("sparse_step", "sparse_allgather", "kernel", "step",
                     ()),
                    ("sparse_scenario", "sparse_allgather", "kernel",
                     "round", LM_SCENARIO),
                    ("dense_scenario", "dense_psum", "kernel", "round",
                     LM_SCENARIO))}
        st = runs["sparse_step"]
        for t in ("sparse_kernel", "sparse_reference", "dense_kernel"):
            if runs[t]["fused"] is not False:
                raise AssertionError(f"{t}: fused {runs[t]['fused']} over "
                                     "gloo")
        for key in ("loss", "kind", "bits_up", "bits_down",
                    "launches_per_sync"):
            if runs["sparse_kernel"][key] != st[key]:
                raise AssertionError(f"multi-rank round runtime: {key} "
                                     "differs from --runtime step")
        k, r, d = (runs[t] for t in ("sparse_kernel", "sparse_reference",
                                     "dense_kernel"))
        if k["bits_up"] != r["bits_up"] or k["bits_up"] != d["bits_up"]:
            raise AssertionError(f"multi-rank bits differ: {k['bits_up']} / "
                                 f"{r['bits_up']} / {d['bits_up']}")
        np.testing.assert_allclose(k["loss"], r["loss"], rtol=1e-5)
        launched = [sum(c.values()) for c in r["launches_per_sync"]] + [
            c["topk_compact"] - LM["topk_stacks"]
            for c in k["launches_per_sync"]]
        if any(launched):
            raise AssertionError(
                f"multi-rank launches: {k['launches_per_sync']} / "
                f"{r['launches_per_sync']}")
        like = tf.init_params(torch.Generator().manual_seed(0),
                              get_config(LM["arch"], smoke=True),
                              device="cpu")
        masters = {t: tree_leaves(checkpoint.restore(runs[t]["ckpt"], like))
                   for t in ("sparse_kernel", "dense_kernel", "sparse_step")}
        if not all(torch.equal(a, b) for a, b in zip(
                masters["sparse_kernel"], masters["sparse_step"])):
            raise AssertionError("multi-rank round runtime: the master "
                                 "differs from --runtime step")
        err = 0.0
        for a, b in zip(masters["sparse_kernel"], masters["dense_kernel"]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            err = max(err, float((a - b).abs().max()))
        # the same scenario on both wires: the same kinds and bits, the
        # masters as close as the fault-free pair's
        ks, kd = runs["sparse_scenario"], runs["dense_scenario"]
        if ks["kind"] != kd["kind"] or ks["bits_up"] != kd["bits_up"] or \
                ks["bits_down"] != kd["bits_down"]:
            raise AssertionError(f"multi-rank scenario: the wires differ: "
                                 f"{ks['kind']} / {kd['kind']}, "
                                 f"{ks['bits_up']} / {kd['bits_up']}")
        for a, b in zip(*(tree_leaves(checkpoint.restore(r["ckpt"], like))
                          for r in (ks, kd))):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        print(f"lm ranks scenario {' '.join(LM_SCENARIO)}: kinds "
              f"{ks['kind']}, bits equal on both wires "
              f"({ks['bits_up'][-1]})", flush=True)
    print(f"lm ranks: R={LM_RANKS['ranks']} on one card over gloo, "
          f"kernel vs reference losses {k['loss']} / {r['loss']}, bits "
          f"equal ({k['bits_up'][-1]}), sparse vs dense masters within "
          f"{err:.3g}; round runtime (fused False) equals --runtime "
          f"step, {time.perf_counter() - t0:.1f}s", flush=True)



# ---------------------------------------------------------------------------
# checkpoints from trainer to server
# ---------------------------------------------------------------------------


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def launcher_serve(dev, path: str, spec: dict, extra: list):
    """``launch/serve.py``'s ``main`` on a checkpoint: its result and the
    launches it made."""
    import torch
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.launch import serve as launch
    argv = ["--arch", CKPT_SERVE["arch"], "--checkpoint", path, "--flash",
            "--max-batch", str(spec["max_batch"]),
            "--max-len", str(spec["max_len"]),
            "--prompt-len", str(spec["prompt_len"]),
            "--new-tokens", str(spec["new_tokens"]),
            "--requests", str(spec["requests"]), "--dispatch", DISPATCH,
            "--device", dev.type] + (["--smoke"] if CKPT_SERVE["smoke"]
                                     else [])
    torch.cuda.synchronize()
    reset_launches()
    res = launch.main(argv + extra)
    torch.cuda.synchronize()
    return res, dict(LAUNCHES)


def in_process_tokens(params, cfg, spec: dict, dev) -> dict:
    """The launcher's requests through a ServeEngine built here."""
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.launch import serve as launch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, max_batch=spec["max_batch"],
                      max_len=spec["max_len"], prompt_pad=spec["prompt_len"],
                      dispatch=DispatchConfig(mode=DISPATCH))
    for p in launch.synthetic_requests(0, spec["requests"],
                                       spec["prompt_len"], cfg.vocab):
        eng.submit(p, max_new_tokens=spec["new_tokens"])
    return eng.run()["outputs"]


def phase_checkpoint_serve(dev, saved: dict, dense_path: str, tmp: str):
    """gemma3-1b at full width served from checkpoints.  Unscanned
    compact-v1: the unscanned serving run's tree (``saved``), loaded by
    ``load_compact`` and served by a ServeEngine on the unscanned config
    (prefill through ``flash_attention``): the run's greedy tokens,
    resident bytes equal, no densify.  Through ``launch/serve.py``'s
    ``main --checkpoint`` (the layers stacked, as the arch config says):
    the LM run's master (the launcher's ``--ckpt``) with ``--compressed``,
    tokens equal to compressing the restored master in-process; then that
    compressed tree (``lm_hetero``, the manifest's policy)
    ``save_compact``-ed and served, tokens equal to an in-process engine
    on the same in-memory tree.  Returns the launches."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import compressed as sc
    from repro_torch.train import checkpoint
    totals = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    # the unscanned compact-v1 checkpoint, in-process
    cfg = saved["cfg"]
    sc.reset_stats()
    t0 = time.perf_counter()
    comp = checkpoint.load_compact(saved["path"], device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if sc.STATS["densify"] or sc.tree_bytes(comp) != saved["sizes"]:
        raise AssertionError(f"unscanned compact: densify {sc.STATS}, "
                             f"resident {sc.tree_bytes(comp)}, saved "
                             f"{saved['sizes']}")
    launches, outs = serve_run(comp, cfg, f"{cfg.name} unscanned from "
                               "compact-v1", {}, dev, FLASH_SERVE,
                               saved["want"])
    if outs != saved["outputs"]:
        raise AssertionError("unscanned compact: tokens differ from the "
                             "tree's before it was saved")
    add(launches)
    row = {"checkpoint": "compact-v1", "layers": "unscanned",
           "served_by": "load_compact + ServeEngine",
           "bytes_on_disk": dir_bytes(saved["path"]),
           "save_s": saved["save_s"], "load_s": load_s,
           "resident_bytes": saved["sizes"], "tokens_equal": True,
           "launches": {k: v for k, v in launches.items() if v}}
    print("checkpoint serve", json.dumps(row), flush=True)
    del comp
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(CKPT_SERVE["arch"],
                                         smoke=CKPT_SERVE["smoke"]),
                              use_pallas=True)
    L = cfg.n_layers

    def check(res, launches, what, source):
        calls = res["steps"] + res["admissions"]
        want = {"flash_decode": L * res["steps"], "sparse_gemm": 7 * L * calls,
                "qdq_gemm": calls}
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        if res["stats"]["densify"]:
            raise AssertionError(f"{what}: densified")
        if res["source"] != source:
            raise AssertionError(f"{what}: served from {res['source']}")
        if res["captures"] != {"decode": 1, "admit": 1}:
            raise AssertionError(f"{what}: captures {res['captures']}")
        add(launches)

    # dense, compressed once at load with the manifest's policy
    spec = CKPT_SERVE["dense"]
    res, launches = launcher_serve(dev, dense_path, spec, ["--compressed"])
    check(res, launches, "dense", "dense checkpoint -> compressed at load")
    t0 = time.perf_counter()
    master = checkpoint.restore(dense_path, tf.init_params(None, cfg,
                                                           device="meta"),
                                device=dev)
    policy = checkpoint.load_policy(dense_path)
    params = sc.compress_tree(master, policy)
    del master
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if res["sizes"] != sc.tree_bytes(params):
        raise AssertionError("dense: resident bytes differ")
    if res["outputs"] != in_process_tokens(params, cfg, spec, dev):
        raise AssertionError("dense: the launcher's tokens differ from "
                             "compressing the restored master in-process")
    row = {"checkpoint": "dense", "layers": "scanned",
           "served_by": "launch/serve.py --compressed",
           "bytes_on_disk": dir_bytes(dense_path),
           "load_and_compress_s": res["load_s"],
           "in_process_restore_and_compress_s": restore_s,
           "resident_bytes": res["sizes"], "steps": res["steps"],
           "prefills": res["admissions"], "tokens_equal": True,
           "launches": {k: v for k, v in launches.items() if v}}
    print("checkpoint serve", json.dumps(row), flush=True)

    # that compressed tree as compact-v1, through the launcher
    path = os.path.join(tmp, "compact")
    spec = CKPT_SERVE["compact"]
    t0 = time.perf_counter()
    checkpoint.save_compact(path, params, step=0, policy=policy.to_dict())
    save_s = time.perf_counter() - t0
    res, launches = launcher_serve(dev, path, spec, [])
    check(res, launches, "compact", "compact checkpoint")
    if res["sizes"] != sc.tree_bytes(params):
        raise AssertionError(f"compact: resident {res['sizes']}, the tree "
                             f"{sc.tree_bytes(params)}")
    if res["outputs"] != in_process_tokens(params, cfg, spec, dev):
        raise AssertionError("compact: the launcher's tokens differ from "
                             "the in-process engine's")
    row = {"checkpoint": "compact-v1", "layers": "scanned",
           "served_by": "launch/serve.py", "bytes_on_disk": dir_bytes(path),
           "save_s": save_s, "load_s": res["load_s"],
           "resident_bytes": res["sizes"], "steps": res["steps"],
           "prefills": res["admissions"],
           "tokens_per_s": res["tokens_per_s"], "tokens_equal": True,
           "launches": {k: v for k, v in launches.items() if v}}
    print("checkpoint serve", json.dumps(row), flush=True)
    del params
    torch.cuda.empty_cache()
    return totals


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
    serve_checks = phase_serve_kernels(dev)
    flash_checks, gemma_decode, gemma_gemm = phase_flash_kernels(dev)
    runs, totals, fault_free = phase_train(dev)
    phase_small_agreement(dev)
    wrapper_totals = phase_wrappers(dev)
    convex_totals, convex_checks = phase_convex(dev)
    fault_totals = phase_faults(dev, fault_free)
    scenario_totals = phase_scenarios_convex(dev)
    for more in (wrapper_totals, convex_totals, fault_totals,
                 scenario_totals):
        for k, v in more.items():
            totals[k] = totals.get(k, 0) + v
    serve_totals = phase_serve(dev)
    phase_serve_agreement(dev)
    tmp = tempfile.mkdtemp(dir=os.path.join(SRC, "repro_torch", "kernels",
                                            "build"))
    try:
        flash_totals, saved = phase_serve_flash(dev, tmp)
        for arch in ("gemma3-1b", "yi-6b"):
            phase_serve_agreement(dev, arch, unscanned=True)
        compact, lm_topk = phase_lm_kernels(dev)
        dense_ckpt = os.path.join(tmp, "dense")
        lm_totals = phase_lm(dev, dense_ckpt)
        for k, v in phase_lm_scenario(dev).items():
            lm_totals[k] = lm_totals.get(k, 0) + v
        ckpt_totals = phase_checkpoint_serve(dev, saved, dense_ckpt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for more in (flash_totals, ckpt_totals):
        for k, v in more.items():
            serve_totals[k] = serve_totals.get(k, 0) + v
    phase_lm_ranks(dev)

    head_topk, head_qsgd = topk[1], qsgd[0]
    kernels = [
        {"name": "topk_compress", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topk_compress.cu",
         "replaces": "src/repro/kernels/topk_compress.py:86",
         "launches": totals["topk_compress"] + lm_totals["topk_compress"],
         **{
             k: head_topk[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
         "shape": head_topk["shape"],
         # the other shapes: the long rows' cluster kernel among them
         "rows": [{"k": r["k"], "sign": r["sign"], **{
             k: r[k] for k in ("shape", "live", "max_abs_err", "ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}}
             for r in topk + lm_topk + convex_checks["topk"]
             if r is not head_topk]},
        {"name": "qsgd_quantize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/qsgd.cu",
         "replaces": "src/repro/kernels/qsgd.py:36",
         "launches": totals["qsgd"], **{
             k: head_qsgd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
         "shape": head_qsgd["shape"], "geometry": head_qsgd["geometry"],
         "rows": [{k: r[k] for k in ("shape", "live", "geometry",
                                     "max_abs_err",
                                     "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
                  for r in qsgd[1:] + convex_checks["qsgd"]]},
    ]
    for name, src, replaces in (
            ("sparse_gemm", "sparse_gemm.cu", "sparse_gemm.py:90"),
            ("qdq_gemm", "sparse_gemm.cu", "sparse_gemm.py:146"),
            ("paged_decode", "paged_decode.cu", "paged_attention.py:106"),
            ("flash_decode", "flash_decode.cu", "flash_attention.py:144")):
        head = serve_checks[name][0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": serve_totals.get(name, 0), **{
                k: head[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "shape": head["shape"]})
    timed = ("shape", "max_abs_err", "max_row_rel_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")
    # the GEMMs' other rows: Yi-6B's beside the head row, then gemma3-1b's
    for k in kernels:
        if k["name"] in gemma_gemm:
            k["rows"] = [
                {key: r[key] for key in timed + ("k_row",) if key in r}
                for r in serve_checks[k["name"]][1:] + gemma_gemm[k["name"]]]
    # the split decode kernels' other rows beside their head rows
    paged = kernels[-2]
    paged["max_row_rel_err"] = serve_checks["paged_decode"][0][
        "max_row_rel_err"]
    paged["rows"] = [{"quant": r["quant"], **{k: r[k] for k in timed}}
                     for r in serve_checks["paged_decode"][1:]]
    kernels[-1]["max_row_rel_err"] = head["max_row_rel_err"]
    kernels[-1]["rows"] = [{"cache": r["cache"], **{k: r[k] for k in timed}}
                           for r in gemma_decode]
    head = flash_checks[0]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:75",
        "launches": serve_totals["flash_attention"], **{
            k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
        "shape": head["shape"], "window": head["window"],
        "max_row_rel_err": head["max_row_rel_err"],
        "kernel_route": head["route"],
        "rows": [{"window": r["window"], **{k: r[k] for k in timed}}
                 for r in flash_checks[1:]]})
    head = compact[0]
    kernels.append({
        "name": "topk_compact", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_compact.cu",
        "replaces": "src/repro/kernels/topk_compress.py:183",
        "launches": lm_totals["topk_compact"], **{
            k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
        "shape": head["shape"],
        "rows": [{"sign": r["sign"], **{
            k: r[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                              "bound_ms", "bound_by", "library_ms")}}
            for r in compact[1:] if "ms" in r]})
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the path")
    print(f"timing: kernel times by {TIMING['clock']}", flush=True)
    print(card(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
