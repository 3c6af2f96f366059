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
   H100 SXM's published peaks); the long-row kernels' SignTop_k at
   [16, 524288] too;
3b. the launch-geometry tuner (``kernels/autotune.py``), its table in a
   temporary directory for the whole run: the CLI's ``--smoke`` twice
   (tuned 8, then tuned 0 and cached 8); every candidate geometry of
   the main paths' launches (``TUNE_SWEEP``: ResNet-50's TopK buckets,
   plain and SignTop_k, and QSGD buckets, the convex QSGD rows,
   gemma3-1b's ``topk_compact`` rows, plain and sign) against the
   kernel's own, outputs equal bit for bit, and ``paged_decode`` at
   Yi-6B's decode shapes at every pages-a-block candidate within 2^-7
   of each row's largest; each candidate timed, the winner against the
   default.  Every graphed ResNet-50 run of step 4 and gemma3-1b run of
   step 7 tunes first (``RunConfig(tune=True)``, ``--tune``; the
   ``TUNE_CACHE`` counts and the signatures tuned away from the default
   printed), and is held to its eager run, which runs untuned;
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
   (R=15, T=200), each under dispatch "auto" and "kernel" (EF-QSGD's
   shared uniforms on the per-step runtime), and under "kernel" graphed
   against ``runtime="step"`` (the same History, one capture), TopK-SGD
   also overlapped (windows of 8 rounds), with bits, rounds, bits to
   the target loss and ms a round and a step; then Algorithm 2 at
   bench_async's sizes (TopK, R=15, T=200, H=4), the round runtime
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
7b-7d. model parallelism (``phase_ranks``, one job of RANK_JOBS each,
   printed as ``phase_tp``, ``phase_ep`` and ``phase_tp_ssm``): each
   arch through the launcher at ``--mesh 1x2``, two gloo ranks sharing
   the card (each its model shards, the model's collectives staged
   through host memory), 2 steps (the last a sync) on the job's wires,
   against its ``1x1`` eager twin: kinds equal, the ledgers within
   TP_BITS_RTOL (ties in the bf16 deltas), the losses within
   TP_LOSS_RTOL; the first step's gradient of every held leaf, gathered,
   within the job's limit of the whole model's (beside it the witness:
   the ``1x1`` run with the batch rows swapped, the same sums in another
   order), every leaf whole on both ranks with one gradient bit for
   bit; the wire kernel's launches a sync a rank the dry record counts,
   at the shapes ``launch_plans(shards=)`` gives, each held against its
   plain version; per shard against whole leaves on a full-size delta,
   the uplink's bits and output bit for bit; each rank's local and sync
   step of the dry run's ``1x2`` cell within DRY_PEAK_TOL (peak,
   arguments, temporaries), FLOPs and launches equal, and where the job
   profiles, its collectives equal to the record's model-group bytes.
   7b (``tp``): gemma3-1b at full width and depth, batch 2 of 1024, H =
   4, on both wires (the dry cell on the sparse one), within
   TP_GRAD_RTOL.  7c (``ep``):
   qwen3-moe-30b-a3b at full width (128 experts of 768, top-8), cut to 1
   layer, 64 experts a rank, under ``preset:uniform_topk`` on both wires
   (the dry cell on the dense one); each rank's EP region (its experts'
   float32 partials summed over the group) within 2^-7 of each row's
   largest of the whole region on the same inputs, ``dropped`` equal;
   the expert, router and attention leaves within EP_GRAD_RTOL; the
   uplink check on the expert stacks.  7d (``tp_ssm``): rwkv6-3b and
   zamba2-7b at full width, cut to 1 layer (zamba2's shared block
   before it), under ``preset:arch`` on the dense wire, within
   TP_GRAD_RTOL.  The twins run alone before step 7's multi-rank
   phases, the ranks beside them in worker threads (7b then 7c in one,
   7d in another once 7b's ranks and step 7's phases are done), the
   kernel checks after them;
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
   on disk and seconds to save and to load;
9. the other model families: ``flash_attention`` at zamba2-7b's prefill
   (4 x 2048 tokens, 32 heads of 112, causal) and ``flash_decode`` at
   zamba2-7b's and qwen3-moe-30b-a3b's decode shapes (step 3's checks
   and times); rwkv6-3b, zamba2-7b and qwen3-moe-30b-a3b at full width
   and depth (random bf16 weights from a seed) served in-process under
   ``use_pallas``: a prefill of 4 prompts of 1024 / 2048 / 512 tokens
   and 32 greedy ``decode_step`` s, asserting 14 ``flash_attention`` a
   prefill and 14 ``flash_decode`` a step (zamba2-7b) and 48
   ``flash_decode`` a step (qwen3-moe); every kernel call of a first
   prefill and decode step held to its plain version on the same inputs
   (2^-7 of each row's largest), and the first logits to the plain path
   (``use_pallas=False``) within the noise floor that one bf16 rounding's
   error in the embeddings gives; the same shapes in float32 at full
   width and a cut depth (4 / 12 / 4 layers), the kernel path's first
   logits within 2^-7 of the plain path's; the smoke configs in float32
   with dispatch "kernel" against "reference" (the same tokens); then the
   three trained through the launcher at full width, the depth cut for
   the card's memory and the script's time (qwen3-moe 1 layer, rwkv6-3b
   and zamba2-7b 6), R
   = 1 over NCCL, ``preset:arch`` on the sparse wire, batch 2 of 1024, 8
   steps at H = 4, graphed against ``--runtime step`` (the same record),
   the policy's per-leaf table printed and checked against its rule, and
   its ``topk_compact`` launches a sync asserted: one for each sparse
   leaf less those that the dispatch rule's limits send to the plain
   version, each printed with its reason;
10. the dry run (``repro_torch.launch.dryrun``), its records made on
   the ``meta`` device in a process of its own while steps 3-9 run:
   gemma3-1b x train_4k, yi-6b x decode_32k and zamba2-7b x long_500k
   at full size on ``dp256``, each ``ok`` with its roofline terms; step
   7's gemma3-1b cell (one worker, sparse wire, ``preset:arch``) run
   once more as one eager local and one eager sync step, measured as
   the dry run measures: FLOPs equal to the dry run's exactly, launches
   equal (7 ``topk_compact`` a sync), the peak over what was live before
   within 15 % of the predicted argument + temp bytes, and step 7's
   graphed ms a step as a share of the bf16 peak; step 9's zamba2-7b
   prefill's peak within 15 % of its prediction, 14 ``flash_attention``
   as predicted; the gemma3-1b smoke model at 2 gloo ranks on the card,
   one sync step a wire profiled, its collective bytes read from the
   trace equal to the dry run's at ``2x1`` by kind and in total.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package ``repro``.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

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
#: kernel rule (TopK-SGD, EF-QSGD) or draw as one does (QTop_k), at T =
#: 200 where bench_convex runs 400: the first half of its runs (lr does
#: not depend on T), for the script's time limit
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
         "T": 200, "H": 1, "log_every": 25, "batch_seed": 0,
         "kernel": "topk_compress", "per_sync": 2, "overlap": True},
        {"name": "ef_qsgd_4bit", "op": "qsgd", "kw": {"s": 15}, "R": 15,
         "T": 200, "H": 1, "log_every": 25, "batch_seed": 0,
         "kernel": "qsgd", "per_sync": 2},
        {"name": "qtopk_4bit", "op": "qtopk", "kw": {"k": K_CONVEX, "s": 15},
         "R": 15, "T": 200, "H": 1, "log_every": 25, "batch_seed": 0},
    ]}
#: Algorithm 2 on the convex problem at bench_async.py's sizes (TopK,
#: sync gaps U[1, H]) but T = 200 of its 400, for the script's time limit;
#: the round shapes are also counted at H = 8
ASYNC_CONVEX = {"R": 15, "T": 200, "H": 4, "shapes_at_H": (4, 8)}
#: how far "kernel" may sit from "auto" where their arithmetic differs
#: (largest relative gap over the log points, bits and smoothed loss):
#: 2-20x TopK-SGD's gaps on the H100 (5.1e-5 / 5.1e-3), which repeat
#: exactly from run to run.  EF-QSGD is not here: its "auto" run sums
#: the norm in the kernel's order (``tree_norm_reference``), so the two
#: runs are one arithmetic and must agree exactly
CONVEX_TOL = {"topk": {"bits": 1e-4, "loss": 1e-2}}
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


def kernel_bound(kernel: str, **shape) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the bound of one launch of
    ``kernel`` at ``shape`` (``roofline.kernel_cost`` with this run's
    data-dependent counts, over the H100 SXM's data-sheet rates)."""
    from repro_torch.launch import roofline
    return roofline.bound_ms(*roofline.kernel_cost(kernel, **shape))


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
    bms, by = kernel_bound("topk_compress", rows=rows, n=n, iters=24)
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
    bms, by = kernel_bound("qsgd", rows=rows, n=n)
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
            check_topk(dev, 8, 65536, 655, False, 10),
            check_topk(dev, R * 2, 524288, 5243, True, 5)]
    qsgd = [check_qsgd(dev, R * 2, 524288, 15, 10),
            check_qsgd(dev, R * 7, 65536, 15, 10),
            check_qsgd(dev, 1, 524288, 15, 10),
            check_qsgd(dev, 7, 65536, 15, 10)]
    for row in topk + qsgd:
        print("kernel check", json.dumps(row), flush=True)
    for name, row in (("topk_compress", topk[2]), ("qsgd", qsgd[0])):
        print(f"repaired {name} {row['shape']}: {row['ms']:.4f} ms (before "
              f"the repair {BEFORE_REPAIR_MS[name]} ms, PERF.md); SignTop_k "
              f"{topk[-1]['ms']:.4f} ms", flush=True)
    return topk, qsgd


#: the main paths' launches whose geometry the tuner may move, (kernel,
#: rows, n, k, sign): ResNet-50's global TopK buckets at R = 8 (2 leaves
#: of 512Ki, 7 of 64Ki; plain and SignTop_k) and its QSGD buckets, the
#: convex problem's QSGD rows, gemma3-1b's sparse-wire w1 / w2 / w3 rows
TUNE_SWEEP = (
    ("topk_compress", R * 2, 524288, 5243, False),
    ("topk_compress", R * 2, 524288, 5243, True),
    ("topk_compress", R * 7, 65536, 655, False),
    ("topk_compress", R * 7, 65536, 655, True),
    ("qsgd", R * 2, 524288, 15, False),
    ("qsgd", R * 7, 65536, 15, False),
    ("qsgd", 15, 7936, 15, False),
    ("topk_compact", 179712, 1152, 12, False),
    ("topk_compact", 179712, 1152, 12, True),
)
#: the cluster kernels' times at [16, 524288] before their sums took one
#: order (PERF.md §6, PR 19 and PR 16, NVIDIA H100 80GB HBM3 at 700 W),
#: beside which this run's print
BEFORE_REPAIR_MS = {"qsgd": 0.0650, "topk_compress": 0.1293}


def phase_autotune(dev, table_dir: str) -> dict:
    """The tuner (``kernels/autotune.py``) on the card, its table in
    ``table_dir`` (kept for the later phases' tuned runs): the CLI's
    ``--smoke`` twice (tuned 8, then tuned 0 and cached 8); then every
    candidate geometry of the main paths' launches (``TUNE_SWEEP``)
    against the kernel's own pick, outputs equal bit for bit, and
    ``paged_decode`` at Yi-6B's decode shapes at every pages-a-block
    candidate within its tolerance of the plain version (2^-7 of each
    row's largest); each candidate timed as the tuner times it (5
    samples, each a CUDA graph of one batch of back-to-back launches, the
    batch the same for every candidate of a key), the fastest and the
    tuner's winner (``autotune.pick``) printed against the default.
    Returns {key: row}."""
    import io
    import torch
    from repro_torch.kernels import autotune, ref
    from repro_torch.kernels.paged_attention import paged_decode
    autotune.configure(table_dir)
    for want in ("(tuned 8, cached 0)", "(tuned 0, cached 8)"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = autotune.main(["--smoke"])
        print(buf.getvalue(), end="", flush=True)
        if rc != 0 or want not in buf.getvalue():
            raise AssertionError(f"autotune --smoke: rc {rc}, want {want}")
    rows = {}

    def report(key, default, samples, reps, what):
        times = {g: min(v) for g, v in samples.items()}
        best = min(times, key=times.get)
        spread = {str(g): max(v) - min(v) for g, v in samples.items()}
        row = {"us": {str(g): t for g, t in times.items()},
               "spread_us": spread, "batch": reps,
               "default": default, "default_us": times[default],
               "best": best, "best_us": times[best],
               "winner": autotune.pick(samples, default), "outputs": what}
        rows[key.as_str()] = row
        print("autotune sweep", key.as_str(), json.dumps(row), flush=True)

    for kernel, r, n, k, sign in TUNE_SWEEP:
        key = autotune.ShapeKey(kernel, r, n, k, sign)
        run = autotune.launcher(key, dev, seed=1)
        want = [t.clone() for t in run(None)]
        default = autotune.default_geometry(key, dev)
        reps = autotune.batch_size(lambda: run(default), dev)
        samples = {}
        for geo in autotune.block_row_candidates(key, dev):
            for a, b in zip(run(geo), want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"autotune: {key.as_str()} at geometry {geo} differs "
                        f"from the default {default}")
            samples[geo] = autotune.time_samples(lambda: run(geo), dev, 5,
                                                 reps)
        if default not in samples:
            raise AssertionError(f"autotune: default {default} of "
                                 f"{key.as_str()} is not a candidate")
        report(key, default, samples, reps, "equal bit for bit")
        del run, want
    for quant in (False, True):
        args = paged_inputs(dev, quant)
        kp, tables = args[1], args[5]
        key = autotune.ShapeKey("paged_decode", tables.shape[1],
                                kp.shape[1], kp.shape[-1], quant)
        plain = ref.paged_decode_ref(*args)
        default = autotune.default_geometry(key, dev)
        reps = autotune.batch_size(
            lambda: paged_decode(*args, pages_per_block=default), dev)
        samples, worst = {}, 0.0
        for pb in autotune.block_row_candidates(key, dev):
            _, row_err = close_per_row(
                paged_decode(*args, pages_per_block=pb), plain, 2 ** -7,
                f"autotune paged_decode quant={quant} pages a block {pb}")
            worst = max(worst, row_err)
            samples[pb] = autotune.time_samples(
                lambda: paged_decode(*args, pages_per_block=pb), dev, 5,
                reps)
        report(key, default, samples, reps,
               f"within 2^-7 of each row's largest (worst {worst})")
    autotune.clear_cache()
    return rows


@contextlib.contextmanager
def untuned():
    """Dispatch through an empty tuning table: every launch at the
    kernel's own geometry (the runs that the tuned ones are held to)."""
    from repro_torch.kernels import autotune
    keep = os.path.dirname(autotune.table_path())
    empty = tempfile.mkdtemp(dir=keep)
    autotune.configure(empty)
    try:
        yield
    finally:
        autotune.configure(keep)
        shutil.rmtree(empty, ignore_errors=True)


def tuned_report(what: str) -> dict:
    """Print the table's resolutions of a tuned run (``TUNE_CACHE``) and
    the signatures whose winner is not the kernel's own geometry."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.launch_stats import TUNE_CACHE
    table = autotune.load_table()
    away = {}
    for ks, ent in table.items():
        default = autotune.default_geometry(autotune.parse_key(ks))
        if ent.block_rows != (1 if default is None else default):
            away[ks] = {"default": default, "tuned": ent.block_rows,
                        "us": ent.us}
    row = {"tune_cache": dict(TUNE_CACHE), "table_keys": len(table),
           "tuned_away": away}
    print(f"tune {what}", json.dumps(row), flush=True)
    return row


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
    History, launches and the final master equal, one capture.  The
    graphed run tunes first (``RunConfig(tune=True)``), the eager one runs
    untuned: no geometry changes an output."""
    import numpy as np
    import torch
    from repro_torch.core import rounds
    from repro_torch.core.operators import QSGDQuantizer, RowSignTopK, TopK
    from repro_torch.core.schedule import fixed_schedule
    from repro_torch.data import make_image_data, worker_batches
    from repro_torch.kernels.launch_stats import (LAUNCHES, reset_launches,
                                                  reset_tune_cache)
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
                # the graphed run tunes its launches first; the eager one
                # runs every launch at the kernel's own geometry
                tuned = runtime == "round"
                run = RunConfig(total_steps=T, R=R, H=H, runtime=runtime,
                                dispatch=DISPATCH, log_every=1, seed=0,
                                tune=tuned)
                clock = StepClock(worker_batches(x, y, R, B, T, seed=1,
                                                 feature_key="images"))
                _free_graphs()
                torch.cuda.reset_peak_memory_stats(dev)
                reset_launches()
                reset_tune_cache()
                with contextlib.nullcontext() if tuned else untuned():
                    state, hist = train(grad_fn, params, momentum_sgd(0.9),
                                        op, piecewise_decay(0.05, [100, 130]),
                                        clock, run, smooth=1, device=dev)
                torch.cuda.synchronize()
                t_end = time.perf_counter()
                if tuned:
                    tuned_report(f"train {name}")
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


@contextlib.contextmanager
def tree_norm_reference():
    """The reference QSGD operator (``core.operators.qsgd_quantize``, what
    dispatch "auto" runs on leaves below the kernels' min_size) with its
    norm summed in the one order of ``qsgd_quantize``'s kernel
    (``ref.tree_sq_ref``) in place of torch's reduction; the levels as
    the plain version takes them.  EF-QSGD's run diverges, so a norm one
    ulp apart grew into a loss gap of 6.7e-4 over its 200 steps; with
    one order on both sides the runs agree bit for bit."""
    import torch
    from repro_torch.core import operators
    from repro_torch.kernels import ref

    def tree_norm_qsgd(rng, x, s):
        xf = x.reshape(1, -1).to(torch.float32)
        u = operators.uniform(rng, x.shape, x.device).reshape(1, -1)
        norm = torch.sqrt(ref.tree_sq_ref(xf))[:, None]
        return ref._qsgd_levels(xf, u, s, norm).reshape(x.shape)

    plain = operators.qsgd_quantize
    operators.qsgd_quantize = tree_norm_qsgd
    try:
        yield
    finally:
        operators.qsgd_quantize = plain


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
    kernel rule or share its draws (R = 15, T = 200), each once under
    dispatch "auto" (these leaves, 7,840 and 10 floats, are below the
    kernels' min_size: the reference operators) and once under
    "kernel".  Where no kernel rule applies the two runs are one
    computation and must agree exactly, and so must EF-QSGD, which gets
    the same uniforms in both modes and whose "auto" reference sums the
    norm in the kernel's order (``tree_norm_reference``); Top_k's kernel
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
            with (tree_norm_reference() if qsgd and dispatch == "auto"
                  else contextlib.nullcontext()):
                out[dispatch] = convex_run(dev, method, dispatch, rng,
                                           runtime="step" if qsgd
                                           else "round")
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
    (``benchmarks/bench_async.py``'s TopK rows: R = 15, T = 200, sync
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
    bms, by = kernel_bound("sparse_gemm", M=M, n=n, R=R, nnz=nnz,
                           x_bytes=x.element_size())
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
    bms, by = kernel_bound("qdq_gemm", M=M, n=n, R=R,
                           x_bytes=x.element_size())
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


def paged_inputs(dev, quant: bool) -> tuple:
    """``paged_decode``'s arguments at Yi-6B's decode shapes (batch 8, 32
    query / 4 kv heads of 128, pages of 16, 32 table entries per row, a
    256-page pool; bf16 pages or int8 pages with their scales), the row
    lengths of a serve run, row 0 a free slot."""
    import torch
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
    return q, kp, vp, ks, vs, tables, lengths


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
    args = paged_inputs(dev, quant)
    q, kp, vp, ks, vs, tables, lengths = args
    B, _, H, hd = q.shape
    n_pages, ps, KV, _ = kp.shape
    P = tables.shape[1]
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
    bms, by = kernel_bound("paged_decode", B=B, H=H, KV=KV, hd=hd, P=P,
                           page_size=ps, tokens=tokens, quant=quant,
                           elem=q.element_size())
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
    bms, by = kernel_bound("flash_decode", B=B, H=H, KV=KV, hd=hd, C=C,
                           tokens=tokens, elem=q.element_size())
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
    from repro_torch.launch import roofline
    pairs = B * roofline.live_pairs(S, window)
    nbytes, ops, dtype = roofline.kernel_cost(
        "flash_attention", B=B, S=S, H=H, KV=KV, D=D, window=window,
        elem=q.element_size())
    bms, by = roofline.bound_ms(nbytes, ops, dtype)
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
            "bound_f32_ms": ops / roofline.PEAK_FLOPS[torch.float32] * 1e3}


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
        out["bound_ms"], out["bound_by"] = kernel_bound(
            "topk_compact", rows=rows, n=n, kcap=kcap, iters=24)
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
           extra: tuple = (), steps: int = LM["steps"],
           down_stacks: int = 0):
    """The launcher on gemma3-1b at full size, R = 1: returns its record
    and the launches it made (counted from 0 at its start).  ``ckpt``: a
    directory for the launcher's ``--ckpt`` (the master at the end);
    ``extra``: more flags (a scenario, faults, a policy).  Every sync
    where a worker compresses launches the wire's kernel once a Top_k
    stack: the uplink's 7 and ``down_stacks`` of a compressed downlink;
    under faults a sync step that only lands payloads launches none."""
    import numpy as np
    import torch
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.launch import train as lt
    argv = ["--arch", LM["arch"], "--mesh", "1x1", "--policy", "preset:arch",
            "--batch", str(LM["batch"]), "--seq", str(LM["seq"]),
            "--steps", str(steps), "--H", str(LM["H"]),
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
    per_sync = LM["topk_stacks"] + down_stacks
    want = {kern: per_sync * sum(rec["computes"])}
    for k, v in launches.items():
        if v != want.get(k, 0):
            raise AssertionError(f"LM {wire}: {v} {k} launches in {n_syncs} "
                                 f"syncs, want {want.get(k, 0)}")
    for computes, counts in zip(rec["computes"], rec["launches_per_sync"]):
        got = {k: v for k, v in counts.items() if v}
        if got != ({kern: per_sync} if computes else {}):
            raise AssertionError(f"LM {wire}: a sync launched {got} "
                                 f"(computing: {computes})")
    faults = "--faults" in extra
    if rec["n_params"] != LM["n_params"]:
        raise AssertionError(f"gemma3-1b has {rec['n_params']} parameters")
    if not all(np.isfinite(rec["loss"])):
        raise AssertionError(f"LM {wire}: loss not finite: {rec['loss']}")
    if runtime == "round" and (rec["fused"] is not True or (
            not faults and rec["captures"] != lm_captures(kinds))):
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
        for i in range(0, steps, LM["H"])]
    late = round_ms[2:] or round_ms[-1:]
    # under faults rounds close at every event: the median step past the
    # first two H-step stretches
    median = (float(np.median(rec["ms"][2 * LM["H"]:] or rec["ms"]))
              if faults else float(np.median(late)) / LM["H"])
    row = {"wire": wire, "runtime": runtime, "loss": rec["loss"],
           "ms_per_step": rec["ms"], "ms_per_round": round_ms,
           "ms_per_step_median": median,
           "bits_up_per_sync": ups, "bits_down": rec["bits_down"][-1],
           "peak_device_bytes": rec["peak_device_bytes"],
           "ckpt_s": rec.get("ckpt_s"), "captures": rec.get("captures", 0),
           "round_shapes": rec.get("round_shapes"),
           "queue_bytes": rec.get("queue_bytes"), "kinds": kinds,
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


#: ``phase_lm``'s median ms a step by (wire, runtime)
LM_STEP_MS: dict = {}



def phase_lm(dev, ckpt: str = None):
    """gemma3-1b through the launcher on both wires, each under the round
    runtime (the default: each round a CUDA graph) and ``--runtime
    step`` (eager): the same record step by step (losses, kinds, both
    ledgers, launches per sync).  The uplink bits of each sync agree
    between the wires to the float rounding of the counted survivors
    (the same survivors, one ledger in another layout).  The dense-wire
    round run writes its master to ``ckpt`` (``--ckpt``) where one is
    given.  The graphed runs tune first (``--tune``), the eager ones run
    untuned: no geometry changes a record."""
    runs, totals = {}, {}
    from repro_torch.kernels.launch_stats import reset_tune_cache
    for wire, path in (("sparse_allgather", None), ("dense_psum", ckpt)):
        for runtime in ("round", "step"):
            # the graphed run tunes its launches first (--tune); the
            # eager one runs every launch at the kernel's own geometry
            tuned = runtime == "round"
            reset_tune_cache()
            with contextlib.nullcontext() if tuned else untuned():
                row, launches, rec = lm_run(
                    wire, dev, path if tuned else None, runtime,
                    ("--tune",) if tuned else ())
            if tuned:
                tuned_report(f"lm {wire}")
            runs[wire, runtime] = (row, rec)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
        a, b = runs[wire, "round"][1], runs[wire, "step"][1]
        for k in ("loss", "kind", "bits_up", "bits_down",
                  "launches_per_sync", "rounds"):
            if a[k] != b[k]:
                raise AssertionError(f"LM {wire}: {k} differs between the "
                                     f"runtimes: {a[k]} / {b[k]}")
        for runtime in ("round", "step"):
            LM_STEP_MS[wire, runtime] = runs[wire, runtime][0][
                "ms_per_step_median"]
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


#: the model-parallel runs' ledgers against their ``1x1`` twins',
#: relative: a sync's delta is the difference of two bf16 iterates,
#: whose rows tie at the k-th magnitude often, and a tie keeps every
#: tied survivor, so where the two runs' deltas part (bf16 partial sums
#: in another order) the counts do (gemma3-1b on an H100 at 700 W: 4.0e-4
#: at the first sync, at most 2.4e-3 a sync over three; the 1x1 run with
#: the batch rows swapped: 1.1e-4; PERF.md §6)
TP_BITS_RTOL = 0.01
#: the runs' losses against the twin's, relative, at each of the 2
#: steps (gemma3-1b on an H100 at 700 W: 1.07e-4 at the first, one
#: forward of the same weights; 8.1e-4 at the second, after the first
#: update; the 1x1 run with the batch rows swapped: 0 and 7.4e-5)
TP_LOSS_RTOL = 2.0 ** -9
#: each leaf's first-step gradient at 1x2, gathered, against the whole
#: model's on the same weights and batch: ||g - g_1x1|| / ||g_1x1||
#: (gemma3-1b on an H100 at 700 W: at most 0.0118, wk; the 1x1 run with
#: the batch rows swapped, the same sums in another order, 0.0122; a
#: collective missing from the backward leaves a leaf's gradient half or
#: wrong, O(1) off; PERF.md §6)
TP_GRAD_RTOL = 2.0 ** -5
#: the MoE family's first-step gradient of each expert, router and
#: attention leaf at 1x2, gathered, against the whole model's on the
#: same weights and batch (as the 1x1 run computes it, and with the
#: experts' backward hand-written as the ranks run it), relative L2.
#: Set from the readings (an H100 at 700 W, PERF.md §6): 0.0302 (the
#: router; experts 0.024, attention 0.004-0.010) against either; the
#: whole region on the same inputs 2.4e-7, the two 1x1 backwards 0.0036
#: apart: the gap is the residual stream's other sum order reaching the
#: router, whose top-8 picks and capacity drops are discontinuous
EP_GRAD_RTOL = 2.0 ** -4
#: the MoE family's leaves whose gradient is held (its embedding and
#: head are the dense family's, held by ``phase_tp``)
EP_GRAD_LEAVES = ("layers.attn.", "layers.moe.")
#: the MoE family's uplink check runs on its expert stacks (the rows
#: mode of ``ModelShards``; the card's memory)
EP_EXPERTS = ("w1", "w2", "w3")
#: each rank's EP region (its experts' float32 partials summed over the
#: group) against the whole region on the same bf16 inputs: within
#: 2^-7 of each row's largest output
EP_REGION_TOL = 2.0 ** -7
#: the model-parallel rank jobs (``phase_tp``, ``phase_ep``,
#: ``phase_tp_ssm``, each :func:`phase_ranks`): each arch through the
#: launcher at ``RANK_MESH``, two gloo ranks sharing the card, each
#: holding its model shards (the model's collectives staged through
#: host memory), ``steps`` steps (the last a sync) on each of ``wires``,
#: against its ``1x1`` eager twin of the same settings, held to
#: TP_BITS_RTOL, TP_LOSS_RTOL and ``grad_rtol``.  ``dry_wire``: the wire
#: of the dry run's cell each rank measures, with one sync step
#: profiled for its collectives where ``profile``.
#: tp: phase_lm's job (gemma3-1b full(), batch 2, H = 4, preset:arch,
#: seed 0) at 1024 tokens a row, half phase_lm's (the script's time:
#: every step sends the model's activations through gloo).
#: ep: qwen3-moe-30b-a3b at full width (d 2048; 128 experts of 768 at
#: top-8; vocab 151,936; 32 / 4 heads of 128), cut to 1 layer for
#: memory, 64 experts a rank, under preset:uniform_topk (Top_k on the
#: expert shards); its dry cell on the dense wire (the sparse wire's 1x2
#: sync takes ~10 s over gloo); its gradient held on EP_GRAD_LEAVES.
#: tp_ssm: rwkv6-3b and zamba2-7b full() at full width, cut to 1 layer
#: for time (zamba2's shared block runs before layer 0), preset:arch
#: (SignTop_k) on the dense wire
RANK_MESH = "1x2"
RANK_JOBS = {
    "tp": {"archs": (LM["arch"],), "layers": None, "batch": LM["batch"],
           "seq": 1024, "steps": 2, "H": LM["H"],
           "policy": "preset:arch",
           "wires": ("sparse_allgather", "dense_psum"),
           "dry_wire": "sparse_allgather", "profile": True,
           "grad_rtol": TP_GRAD_RTOL},
    "ep": {"archs": ("qwen3-moe-30b-a3b",), "layers": 1, "batch": 2,
           "seq": 1024, "steps": 2, "H": 2, "policy": "preset:uniform_topk",
           "wires": ("sparse_allgather", "dense_psum"),
           "dry_wire": "dense_psum", "profile": True,
           "grad_rtol": EP_GRAD_RTOL},
    "tp_ssm": {"archs": ("rwkv6-3b", "zamba2-7b"), "layers": 1, "batch": 2,
               "seq": 1024, "steps": 2, "H": 2, "policy": "preset:arch",
               "wires": ("dense_psum",), "dry_wire": "dense_psum",
               "profile": False, "grad_rtol": TP_GRAD_RTOL},
}


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float32 (0 where both are zero)."""
    import torch
    num = float(torch.linalg.vector_norm(a.float() - b.float()))
    den = float(torch.linalg.vector_norm(b.float()))
    return num / den if den else (0.0 if num == 0 else float("inf"))


def rank_config(job: dict, arch: str):
    """A rank job's model: the arch's full config at the job's depth."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return (dataclasses.replace(cfg, n_layers=job["layers"])
            if job["layers"] else cfg)


def rank_argv(job: dict, arch: str, wire: str, mesh: str) -> list:
    return ["--arch", arch, "--mesh", mesh, "--policy", job["policy"],
            "--batch", str(job["batch"]), "--seq", str(job["seq"]),
            "--steps", str(job["steps"]), "--H", str(job["H"]),
            "--wire", wire, "--dispatch", DISPATCH, "--runtime", "step"]


def _held(cfg, path: str) -> bool:
    """Is this leaf's first-step gradient held against the whole
    model's?  Every leaf; the MoE family's EP_GRAD_LEAVES."""
    return cfg.family != "moe" or path.startswith(EP_GRAD_LEAVES)


def first_batch(job: dict, cfg, dev) -> dict:
    """The launcher's first batch of the job (``--seed 0``)."""
    import torch
    from repro_torch.data import LMTokenStream
    tokens = next(LMTokenStream(vocab=cfg.vocab, R=1, order=64, seed=0)
                  .batches(job["batch"], job["seq"], job["steps"],
                           seed=1))["tokens"][0]
    return {"tokens": torch.from_numpy(tokens).to(dev)}


def uplink_tree(cfg, tree, specs) -> tuple:
    """(the leaves of ``tree`` the uplink check compresses, their specs):
    every leaf; the MoE family's expert stacks (EP_EXPERTS)."""
    if cfg.family != "moe":
        return tree, specs
    return ({"layers": {"moe": {k: tree["layers"]["moe"][k]
                                for k in EP_EXPERTS}}},
            {"layers": {"moe": {k: specs["layers"]["moe"][k]
                                for k in EP_EXPERTS}}})


def rank_plans(name: str) -> dict:
    """The launches a rank of a job makes a sync, by arch and wire:
    ``launch_plans(shards=)`` of the job's uplink on a rank's model
    shards (on meta), one (kernel, rows, row length, k, sign) a distinct
    shape."""
    from repro_torch.configs import get_policy_preset
    from repro_torch.core import policy as pol
    from repro_torch.core.distributed import ModelShards, ShardCompressor
    from repro_torch.launch.mesh import dry_mesh
    from repro_torch.models import get_model
    from repro_torch.sharding import specs as sp
    job, out = RANK_JOBS[name], {}
    for arch in job["archs"]:
        cfg = rank_config(job, arch)
        whole = get_model(cfg).init_params(None, cfg, "meta")
        comp = ShardCompressor.from_spec(pol.as_channel_spec(
            get_policy_preset(job["policy"][len("preset:"):], arch=arch)
        ).uplink, whole)
        specs = sp.param_specs(cfg)
        mesh = dry_mesh(RANK_MESH)
        layout = sp.shard_layout(specs, whole, mesh)
        mine = sp.shard_tree(whole, layout)
        out[arch] = {wire: sorted(
            (key.kernel, key.rows, key.row_len, key.k, key.sign)
            for key in comp.launch_plans(
                mine, specs, compact=wire == "sparse_allgather",
                shards=ModelShards(layout, mesh)))
            for wire in job["wires"]}
    return out


def rank_dry_records(name: str) -> dict:
    """The dry run's records of a job's cell at ``RANK_MESH``, by arch and
    wire (on meta)."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as dr
    job = RANK_JOBS[name]
    shape = InputShape(f"{name}_cell", job["seq"], job["batch"], "train")
    over = {"n_layers": job["layers"]} if job["layers"] else None
    return {arch: {wire: dr.run_one(arch, shape=shape, mesh=RANK_MESH,
                                    cfg_overrides=over, aggregate=wire,
                                    policy=job["policy"])
                   for wire in job["wires"]}
            for arch in job["archs"]}


@contextlib.contextmanager
def swapped_rows():
    """The launcher's batches with each worker's rows in reverse order:
    the same loss (a mean over the rows), every sum over tokens in
    another order."""
    from repro_torch.launch import train as lt
    stream = lt.LMTokenStream

    class Swapped(stream):
        def batches(self, *args, **kw):
            for b in super().batches(*args, **kw):
                yield {**b, "tokens": b["tokens"][:, ::-1].copy()}

    lt.LMTokenStream = Swapped
    try:
        yield
    finally:
        lt.LMTokenStream = stream


@contextlib.contextmanager
def first_routing():
    """Yields a list that receives the experts the first ``moe._route``
    call under it picks ([T, K] ``eids``): the first MoE layer's routing
    of a loss (none outside the MoE family)."""
    from repro_torch.models import moe
    plain, seen = moe._route, []

    def route(x2d, router, cfg):
        out = plain(x2d, router, cfg)
        if not seen:
            seen.append(out[0].detach().clone())
        return out

    moe._route = route
    try:
        yield seen
    finally:
        moe._route = plain


@contextlib.contextmanager
def hand_written_experts():
    """The whole model's expert region through ``_EPApply`` on a group of
    one rank (its hand-written float32 backward, no collective) where
    autograd records, in place of autograd of the bf16 region: the
    ``1x1`` twin of the 1x2 run's arithmetic.  ``_EPApply``'s forward
    runs with autograd off and takes the plain region."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import moe
    plain, one = moe._expert_compute_local, Mesh((1, 1), ("data", "model"))

    def region(x2d, eids, weights, w1, w3, w2, e_start, E_loc, C):
        if not torch.is_grad_enabled():
            return plain(x2d, eids, weights, w1, w3, w2, e_start, E_loc, C)
        return moe._EPApply.apply(x2d, eids, weights, w1, w3, w2, one,
                                  e_start, E_loc, C)

    moe._expert_compute_local = region
    try:
        yield
    finally:
        moe._expert_compute_local = plain


def rank_twins(dev, name: str, grad_path: str) -> dict:
    """A job's ``1x1`` twins by arch: the same job at ``--mesh 1x1``,
    eager, in this process, by wire, and "swapped" (the first wire's
    twin with the batch rows swapped, :func:`swapped_rows`); then the
    first step's gradient of the whole model (the launcher's weights and
    first batch, the leaves :func:`_held`), as the ``1x1`` run computes
    it ("autograd") and in the MoE family with the experts' backward
    hand-written too (:func:`hand_written_experts`, "hand"), written to
    ``grad_path`` (``{arch}`` in it) for the ranks with the MoE family's
    first routing; the witnesses against "autograd", relative L2 by
    leaf: the gradient with the batch rows swapped (and "hand"); the
    MoE family's dropped assignments of both orders."""
    import torch
    from repro_torch.launch import train as lt
    from repro_torch.models import get_model
    from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                                  value_and_grad)
    job, twins = RANK_JOBS[name], {}
    for arch in job["archs"]:
        out = twins[arch] = {}
        with untuned():
            for wire in job["wires"]:
                _free_graphs()
                out[wire] = lt.main(rank_argv(job, arch, wire, "1x1"),
                                    n_layers=job["layers"])
            with swapped_rows():
                out["swapped"] = lt.main(
                    rank_argv(job, arch, job["wires"][0], "1x1"),
                    n_layers=job["layers"])
        _free_graphs()
        cfg = rank_config(job, arch)
        model = get_model(cfg)
        moe = cfg.family == "moe"
        whole = model.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg, device=dev)
        batches = {"first": first_batch(job, cfg, dev)}
        batches["swapped"] = {"tokens": batches["first"]["tokens"].flip(0)}
        paths = [".".join(map(str, p)) for p, _ in
                 tree_flatten_with_path(whole)[0]]
        fn = value_and_grad(lambda p, b: model.loss_fn(p, b, cfg)[0])

        def first_grads(batch):
            loss, grads = fn(whole, batch)
            return float(loss), {p: g for p, g in
                                 zip(paths, tree_leaves(grads))
                                 if _held(cfg, p)}

        want, loss = {}, {}
        with first_routing() as routed:
            loss["autograd"], want["autograd"] = first_grads(
                batches["first"])
        if moe:
            with hand_written_experts():
                loss["hand"], want["hand"] = first_grads(batches["first"])
        loss["swapped"], swapped = first_grads(batches["swapped"])
        rel = {k: {p: rel_l2(g, want["autograd"][p]) for p, g in v.items()}
               for k, v in (("swapped", swapped), ("hand", want.get("hand")))
               if v is not None}
        del swapped
        out["grad"] = {"loss": loss, "rel_l2": rel}
        if moe:
            with torch.no_grad():
                out["grad"]["dropped"] = {
                    k: float(model.loss_fn(whole, b, cfg)[1]["dropped"])
                    for k, b in batches.items()}
        del whole, batches
        save = {"refs": {k: {p: g.cpu() for p, g in v.items()}
                         for k, v in want.items()},
                "eids": routed[0].cpu() if routed else None}
        del want
        torch.save(save, grad_path.format(arch=arch))
        del save
        _free_graphs()
    return twins


def rank_job(name: str, grad_path: str, gate: str = None) -> None:
    """One rank of a job (``RANK_JOBS[name]``), in a process of its own
    (:func:`rank_runs`).  For each arch: the launcher on each wire (the
    per-step composition; the launches' shapes through
    launch_stats.SINK); the MoE family's EP region on one x against the
    whole region; the first step's gradient per shard (the launcher's
    weights from --seed 0 and its first batch), gathered, against the
    whole model's from the file :func:`rank_twins` wrote (rank 0), every
    leaf whole on both ranks compared between them bit for bit; the dry
    run's cell on ``dry_wire`` (one eager local and sync step measured
    as the dry run measures; with ``profile`` one sync step profiled for
    its collectives); then the uplink per shard against whole leaves on
    a full-size delta of two bf16 iterates (ties in its rows), on this
    rank.  ``gate``: a file whose existence lets the job start, the rank
    made ready before it (the process group joined, the card's context
    and cuBLAS made, ``torch._dynamo``, which the launcher's first
    checkpointed layer imports, imported: seconds on a slow host).
    Records each part's seconds.  Prints its result as one line:
    "RANKS " and JSON."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_policy_preset
    from repro_torch.configs.base import InputShape
    from repro_torch.core import policy as pol
    from repro_torch.core.distributed import ModelShards, ShardCompressor
    from repro_torch.kernels import launch_stats
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import train as lt
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline_parse import (collective_bytes,
                                                  events_from_profile)
    from repro_torch.models import get_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.sharding import specs as sp
    from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                                  tree_map, value_and_grad)

    def settle():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    import torch._dynamo  # noqa: F401
    job = RANK_JOBS[name]
    mesh = make_mesh(RANK_MESH, device="cuda", backend="gloo")
    dev = mesh.device
    torch.ones((8, 8), device=dev) @ torch.ones((8, 8), device=dev)
    while gate and not os.path.exists(gate):
        time.sleep(0.2)
    out = {"rank": mesh.rank, "archs": {}}
    try:
        for arch in job["archs"]:
            row = out["archs"][arch] = {"runs": {}, "steps": {},
                                        "seconds": {}}
            t = time.perf_counter()

            def lap(part):
                nonlocal t
                now = time.perf_counter()
                row["seconds"][part] = now - t
                t = now

            cfg = rank_config(job, arch)
            model = get_model(cfg)
            moe = cfg.family == "moe"
            shapes = []
            launch_stats.SINK = lambda kernel, shape: shapes.append(
                [kernel, shape["rows"], shape["n"]])
            for wire in job["wires"]:
                del shapes[:]
                args = lt.parser().parse_args(
                    rank_argv(job, arch, wire, RANK_MESH)
                    + ["--backend", "gloo"])
                rec = lt._run(args, lt.resolve_policy_arg(args), mesh,
                              job["layers"])
                row["runs"][wire] = {"rec": rec, "launched": list(shapes)}
                lap(f"launcher {wire}")
            launch_stats.SINK = None
            whole = model.init_params(
                torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
            specs = sp.param_specs(cfg)
            layout = sp.shard_layout(specs, whole, mesh)
            policy = sp.activation_policy(cfg, mesh)
            paths = [".".join(map(str, p)) for p, _ in
                     tree_flatten_with_path(whole)[0]]
            if moe:
                # the EP region against the whole region on the same
                # inputs
                lay = whole["layers"]["moe"]
                own = {k: layout.own(lay[k], paths.index("layers.moe." + k))[0]
                       for k in EP_EXPERTS}
                g = torch.Generator(device=dev).manual_seed(3)
                T = job["batch"] * job["seq"]
                x = torch.randn((T, cfg.d_model), generator=g,
                                device=dev).to(cfg.adtype)
                eids, w, _ = moe_lib._route(x, lay["router"][0], cfg)
                C = moe_lib._capacity(T * cfg.moe_top_k, cfg.n_experts,
                                      cfg.capacity_factor)
                got, dropped = moe_lib.ep_apply(
                    x, eids, w, own["w1"], own["w3"], own["w2"], policy, C)
                want, want_dropped = moe_lib._expert_compute_local(
                    x, eids, w, lay["w1"][0], lay["w3"][0], lay["w2"][0], 0,
                    cfg.n_experts, C)
                big = want.abs().amax(dim=-1, keepdim=True)
                row["region"] = {
                    "row_gap": float(((got - want).abs()
                                      / big.clamp_min(1e-30)).max()),
                    "dropped": [int(dropped), int(want_dropped)], "C": C,
                    "T": T}
                del got, want, big, x, eids, w, own, lay
                lap("region")
            # the first step's gradient per shard, gathered, against the
            # whole model's: rank 0 reads it from the file the parent
            # wrote; the leaves whole on both ranks compared between them
            batch = first_batch(job, cfg, dev)
            mine = sp.shard_tree(whole, layout)
            del whole
            with first_routing() as seen:
                loss, grads = value_and_grad(lambda p, b: model.loss_fn(
                    p, b, cfg, policy=policy)[0])(mine, batch)
            grad = {"loss": float(loss)}
            if moe:
                with torch.no_grad():
                    grad["dropped"] = float(model.loss_fn(
                        mine, batch, cfg, policy=policy)[1]["dropped"])
            del mine, batch
            want = (torch.load(grad_path.format(arch=arch),
                               map_location="cpu")
                    if mesh.rank == 0 else None)
            refs = want["refs"] if want else {}
            rels, same = {k: {} for k in refs}, {}
            for path, gr, ax in zip(paths, tree_leaves(grads), layout.axes):
                if ax is None:
                    both = mesh.all_gather(gr, over="model")
                    same[path] = bool(torch.equal(both[0], both[1]))
                    del both
                if _held(cfg, path):
                    full = sp.gather_leaf(gr, ax, mesh)
                    for k, ref in refs.items():
                        rels[k][path] = rel_l2(full, ref[path].to(dev))
                    del full
            grad.update(rel_l2=rels, whole_equal=same,
                        split=[ax is not None for ax in layout.axes])
            if want is not None and want["eids"] is not None:
                # the first MoE layer's routing against the whole model's
                flip = seen[0].cpu() != want["eids"]
                grad["flipped"] = [int(flip.sum()), int(flip.any(-1).sum()),
                                   flip.numel()]
            row["grad"] = grad
            del grads, want, refs
            lap("gradient")
            # the dry run's cell on the card
            settle()
            base = torch.cuda.memory_allocated(dev)
            shape = InputShape(f"{name}_cell", job["seq"], job["batch"],
                               "train")
            built = dr.build_train(arch, cfg, mesh, shape, device=dev,
                                   aggregate=job["dry_wire"],
                                   policy=job["policy"])
            state = dr.steady_state(built.init_fn(built.params))
            del built.params
            for step in ("local_step", "sync_step"):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                live = torch.cuda.memory_allocated(dev) - base
                result, got = dr.measure(built.steps[step],
                                         (state, built.batch), mesh)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated(dev) - base
                del result
                row["steps"][step] = {"flops": got["flops"],
                                      "launches": got["launches"],
                                      "live_before_bytes": live,
                                      "peak_bytes": peak}
                lap(f"dry {step}")
            if job["profile"]:
                # a sync step profiled alone (under measure's dispatch
                # mode the trace's collective records carry no dtypes)
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU],
                        record_shapes=True) as prof:
                    result = built.steps["sync_step"](state, built.batch)
                    torch.cuda.synchronize()
                del result
                row["collectives"] = collective_bytes(
                    events_from_profile(prof))
                lap("profiled sync")
            del built, state
            settle()
            # the uplink per shard against whole leaves on one full-size
            # delta of two bf16 iterates
            gen = torch.Generator(device=dev).manual_seed(7)
            tree, tree_specs = uplink_tree(
                cfg, model.init_params(gen, cfg, device=dev), specs)
            delta = tree_map(lambda x: x.float() - (
                x.float() - 1e-3 * torch.randn(x.shape, generator=gen,
                                               device=dev)
            ).to(x.dtype).float(), tree)
            del tree
            comp = ShardCompressor.from_spec(pol.as_channel_spec(
                get_policy_preset(job["policy"][len("preset:"):], arch=arch)
            ).uplink, delta, dispatch=DISPATCH)
            layout = sp.shard_layout(tree_specs, delta, mesh)
            mine = sp.shard_tree(delta, layout)
            shards = ModelShards(layout, mesh)
            rng = lambda: torch.Generator(device=dev).manual_seed(5)  # noqa
            q_mine, bits_mine = comp(mine, tree_specs, rng=rng(),
                                     shards=shards)
            cbits_mine = comp.compact(mine, tree_specs, rng=rng(),
                                      shards=shards)[2]
            q_whole, bits_whole = comp(delta, tree_specs, rng=rng())
            cbits_whole = comp.compact(delta, tree_specs, rng=rng())[2]
            row["whole"] = {
                "bits": [float(bits_mine), float(bits_whole)],
                "compact_bits": [float(cbits_mine), float(cbits_whole)],
                "leaves_equal": [
                    bool(torch.equal(sp.gather_leaf(a, ax, mesh), b))
                    for a, b, ax in zip(tree_leaves(q_mine),
                                        tree_leaves(q_whole), layout.axes)],
                "split": [ax is not None for ax in layout.axes]}
            del delta, mine, q_mine, q_whole
            settle()
            lap("uplink")
    finally:
        mesh.close()
    print("RANKS " + json.dumps(out), flush=True)


def rank_runs(name: str, grad_path: str, gate: str = None) -> list:
    """A job's ranks, spawned from here (:func:`rank_job` in each, with
    ``gate``): each rank's result, in rank order."""
    from repro_torch.launch.mesh import run_local_ranks
    code = (f"import sys; sys.path[:0] = [{SRC!r}, {HERE!r}]; "
            f"import chip_smoke; chip_smoke.rank_job({name!r}, "
            f"{grad_path!r}, {gate!r})")
    procs = run_local_ranks([sys.executable, "-c", code], 2,
                            env=dict(os.environ, PYTHONPATH=SRC),
                            timeout=900)
    outs = []
    for r, (rc, text, err) in enumerate(procs):
        if rc != 0:
            raise AssertionError(f"{name} rank {r} exited {rc}:\n"
                                 f"{err[-3000:]}")
        line = next(l for l in text.splitlines() if l.startswith("RANKS "))
        outs.append(json.loads(line[len("RANKS "):]))
    return outs


def against_twin(rec: dict, twin: dict, what: str, faults: list) -> tuple:
    """A rank's launcher record at 1x2 against its ``1x1`` twin's: kinds
    and rounds equal, the ledgers (up and down) within TP_BITS_RTOL,
    every loss within TP_LOSS_RTOL and finite.  Returns (the ledgers'
    largest relative gap, each loss's)."""
    import numpy as np
    for k in ("kind", "rounds"):
        if rec[k] != twin[k]:
            faults.append(f"{what}: {k} {rec[k]} at 1x2, {twin[k]} at 1x1")
    bits_rel = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(
        rec["bits_up"] + rec["bits_down"],
        twin["bits_up"] + twin["bits_down"]))
    if bits_rel > TP_BITS_RTOL:
        faults.append(f"{what}: ledgers {bits_rel:.3g} apart "
                      f"(> {TP_BITS_RTOL})")
    loss_rel = [abs(a - b) / abs(b)
                for a, b in zip(rec["loss"], twin["loss"])]
    if max(loss_rel) > TP_LOSS_RTOL or not all(np.isfinite(rec["loss"])):
        faults.append(f"{what}: losses {rec['loss']} against "
                      f"{twin['loss']}")
    return bits_rel, loss_rel


def against_dry(steps: dict, dry_steps: dict, what: str,
                faults: list) -> None:
    """A rank's eager steps, measured as the dry run measures, against
    the dry run's record of each: FLOPs and launches equal, the peak,
    the bytes live at the step's start and the peak over them within
    DRY_PEAK_TOL of its argument + temp bytes, argument bytes and temp
    bytes.  Each step's entry gains its gaps and the prediction."""
    for name, got in steps.items():
        want = dry_steps[name]
        mem = want["memory"]
        if got["flops"] != want["flops"]:
            faults.append(f"{what} {name}: {got['flops']} FLOPs, "
                          f"{want['flops']} in the dry run")
        if got["launches"] != want["launches"]:
            faults.append(f"{what} {name}: launches {got['launches']}, "
                          f"{want['launches']} dry")
        got["rel_gap"] = _near(
            got["peak_bytes"], mem["argument_bytes"] + mem["temp_bytes"],
            f"{what} {name} peak", faults)
        got["rel_gap_arguments"] = _near(
            got["live_before_bytes"], mem["argument_bytes"],
            f"{what} {name} arguments", faults)
        got["rel_gap_temp"] = _near(
            got["peak_bytes"] - got["live_before_bytes"], mem["temp_bytes"],
            f"{what} {name} temporaries", faults)
        got["predicted"] = mem


def _kernel(wire: str) -> str:
    return "topk_compact" if wire == "sparse_allgather" else "topk_compress"


def phase_ranks(dev, name: str, dry: dict, twins: dict,
                ranks: list) -> tuple:
    """A model-parallel job on the card (``RANK_JOBS[name]`` at
    ``RANK_MESH``: two gloo ranks sharing the card, each its model
    shards, the model's collectives staged through host memory):
    ``ranks`` (:func:`rank_runs`) against ``twins`` (:func:`rank_twins`),
    by arch.  On each wire, each rank's record against its twin's
    (:func:`against_twin`); its bits up equal on both ranks, and where
    the twin's wires agree, the wires' at 1x2 too (the same survivors).
    The launches a sync: the dry record's count of the wire's kernel and
    no other, at the distinct shapes ``rank_plans`` gives; each shape
    then held against its plain version here.  The MoE family's EP
    region within EP_REGION_TOL of the whole region on the same inputs,
    ``dropped`` equal.  The backward: each held leaf's first-step
    gradient, gathered, within the job's ``grad_rtol`` of the whole
    model's (relative L2; in the MoE family also of the whole model's
    with the experts' backward hand-written), the witnesses (the ``1x1``
    run with the batch rows swapped: its gradients, losses and ledger)
    printed beside it; every leaf whole on both ranks with a gradient
    equal bit for bit between them.  The dry run's cell (``dry``: the
    job's records by arch and wire): each rank's eager local and sync
    step on ``dry_wire`` (:func:`against_dry`), and with ``profile`` the
    collective bytes of one profiled sync step, by kind, equal to the
    record's model-group bytes (at ``1x2`` every collective is the model
    group's: the data group is one rank).  The uplink per shard against
    whole leaves on a full-size delta: bits of both forms and the
    output, bit for bit.  ms a step printed, labelled as gloo through
    host memory.  Returns (the ``topk_compact`` and the
    ``topk_compress`` check rows at the job's shapes, each with its
    launches on the path, the launches by kernel)."""
    import numpy as np
    from repro_torch.kernels import dispatch as dsp
    t0 = time.perf_counter()
    job = RANK_JOBS[name]
    plans = rank_plans(name)
    faults, totals, at = [], {}, {}
    out = {"card": card(), "mesh": RANK_MESH, "layers": job["layers"],
           "policy": job["policy"], "archs": {}}
    for arch in job["archs"]:
        what = f"{name} {arch}"
        for wire in job["wires"]:
            _ok(dry[arch][wire], f"the {RANK_MESH} {arch} cell on {wire}")
        twin = twins[arch]
        row = {"wires": {}, "ranks": [], "plans": plans[arch]}
        first = [r["archs"][arch] for r in ranks]
        for wire in job["wires"]:
            kern = _kernel(wire)
            per_sync = dry[arch][wire]["steps"]["sync_step"]["launches"]
            want_shapes = sorted({(k, rows, n)
                                  for k, rows, n, _, _ in plans[arch][wire]})
            wrow = {"losses_1x1": twin[wire]["loss"],
                    "bits_up_1x1": twin[wire]["bits_up"],
                    "bits_down_1x1": twin[wire]["bits_down"],
                    "ms_per_step_1x1": float(np.median(twin[wire]["ms"])),
                    "launches_per_sync": per_sync, "ranks": []}
            for r, got in zip(ranks, first):
                run = got["runs"][wire]
                rec = run["rec"]
                who = f"{what} {wire} rank {r['rank']}"
                bits_rel, loss_rel = against_twin(rec, twin[wire], who,
                                                  faults)
                if rec["bits_up"] != first[0]["runs"][wire]["rec"]["bits_up"]:
                    faults.append(f"{who}: bits up {rec['bits_up']} differ "
                                  "between the ranks")
                n_syncs = rec["kind"].count("sync")
                for counts in rec["launches_per_sync"]:
                    seen = {k: v for k, v in counts.items() if v}
                    if seen != per_sync or set(seen) != {kern}:
                        faults.append(f"{who}: a sync launched {seen}, the "
                                      f"dry run {per_sync}")
                launched = [tuple(x) for x in run["launched"]]
                if (sorted(set(launched)) != want_shapes or len(launched)
                        != n_syncs * per_sync.get(kern, -1)):
                    faults.append(f"{who}: launched {launched}, planned "
                                  f"{plans[arch][wire]}")
                totals[kern] = totals.get(kern, 0) + len(launched)
                for key in launched:
                    at[key] = at.get(key, 0) + 1
                wrow["ranks"].append({
                    "rank": r["rank"], "loss": rec["loss"],
                    "loss_rel_diff": loss_rel, "bits_up": rec["bits_up"],
                    "bits_down": rec["bits_down"],
                    "ledger_rel_diff": bits_rel, "fused": rec["fused"],
                    "model_axis": rec["model_axis"],
                    "peak_device_bytes": rec.get("peak_device_bytes"),
                    "ms_per_step_median_gloo_host":
                        float(np.median(rec["ms"]))})
            row["wires"][wire] = wrow
            print(f"{what} {wire}: ms a step "
                  f"{[x['ms_per_step_median_gloo_host'] for x in wrow['ranks']]}"
                  f" at 1x2 over gloo through host memory, "
                  f"{wrow['ms_per_step_1x1']:.1f} at 1x1 eager alone",
                  flush=True)
        if len(job["wires"]) > 1:
            # the wires' uplinks: where they agree at 1x1, they do at 1x2
            # (the sparse wire emits at most kcap survivors a row, the
            # dense one every tied survivor)
            gap = {m: (runs["dense_psum"]["bits_up"][-1]
                       - runs["sparse_allgather"]["bits_up"][-1])
                   / runs["dense_psum"]["bits_up"][-1]
                   for m, runs in (("1x1", twin), ("1x2", {
                       w: first[0]["runs"][w]["rec"] for w in job["wires"]}))}
            row["wire_gap"] = gap
            if gap["1x1"] == 0 and gap["1x2"] != 0:
                faults.append(f"{what}: the wires' ledgers part at 1x2 "
                              f"({gap['1x2']:.3g}), not at 1x1")
        if "region" in first[0]:
            for r, got in zip(ranks, first):
                reg = got["region"]
                if (reg["row_gap"] > EP_REGION_TOL
                        or reg["dropped"][0] != reg["dropped"][1]):
                    faults.append(f"{what} rank {r['rank']}: the EP region "
                                  f"{reg} against the whole region")
            row["region"] = [got["region"] for got in first]
        # the backward: each leaf's gathered gradient against the whole
        # model's; the witnesses beside it, not held
        grad, wgrad = first[0]["grad"], twin["grad"]
        loss0 = twin[job["wires"][0]]["loss"][0]
        worst = {k: max(v, key=v.get) for k, v in grad["rel_l2"].items()}
        for k, leaf in worst.items():
            if grad["rel_l2"][k][leaf] > job["grad_rtol"] or set(
                    grad["rel_l2"][k]) != set(wgrad["rel_l2"]["swapped"]):
                faults.append(f"{what} gradient against {k}: {leaf} "
                              f"{grad['rel_l2'][k][leaf]:.3g} "
                              f"(> {job['grad_rtol']})")
        if not worst or abs(grad["loss"] - loss0) > TP_LOSS_RTOL * abs(loss0):
            faults.append(f"{what} gradient: loss {grad['loss']} against "
                          f"{loss0}")
        for r, got in zip(ranks, first):
            if not all(got["grad"]["whole_equal"].values()):
                faults.append(f"{what} rank {r['rank']}: whole leaves' "
                              f"gradients differ between the ranks: "
                              f"{got['grad']['whole_equal']}")
        swap = twin["swapped"]
        base = twin[job["wires"][0]]
        row["backward"] = {
            "rel_l2_1x2": grad["rel_l2"], "witness_rel_l2": wgrad["rel_l2"],
            "max_rel_l2": {
                **{f"1x2_vs_{k}": grad["rel_l2"][k][v]
                   for k, v in worst.items()},
                **{f"{k}_vs_autograd": max(v.values())
                   for k, v in wgrad["rel_l2"].items()}},
            "worst": worst,
            "loss": {"1x2": grad["loss"], **wgrad["loss"],
                     "launcher_1x1": loss0},
            "whole_leaves": len(grad["whole_equal"]),
            "split_leaves": sum(grad["split"])}
        if "dropped" in grad:
            row["backward"]["dropped"] = {**wgrad["dropped"],
                                          "1x2": grad["dropped"]}
            row["backward"]["flipped_assignments"] = grad["flipped"]
        row["witness_swapped_1x1"] = {
            "loss": swap["loss"],
            "loss_rel_diff": [abs(a - b) / abs(b)
                              for a, b in zip(swap["loss"], base["loss"])],
            "bits_up": swap["bits_up"],
            "ledger_rel_diff": max(abs(a - b) / max(abs(b), 1.0)
                                   for a, b in zip(swap["bits_up"],
                                                   base["bits_up"]))}
        mx = row["backward"]["max_rel_l2"]
        print(f"{what} backward: gathered gradients within "
              f"{ {k: round(v, 6) for k, v in mx.items() if k.startswith('1x2')} }"
              f" of the whole model's (worst {worst}); witnesses "
              f"{ {k: round(v, 6) for k, v in mx.items() if not k.startswith('1x2')} }"
              f", the swapped run's losses "
              f"{row['witness_swapped_1x1']['loss_rel_diff']}, ledger "
              f"{row['witness_swapped_1x1']['ledger_rel_diff']:.3g}"
              + (f"; the first layer's routing at 1x2: "
                 f"{grad['flipped'][0]} of {grad['flipped'][2]} assignments"
                 f" on other experts" if "flipped" in grad else ""),
              flush=True)
        dry_steps = dry[arch][job["dry_wire"]]["steps"]
        want_coll = dry_steps["sync_step"]["collectives_by_group"].get(
            "model", {"total": 0})
        for r, got in zip(ranks, first):
            who = f"{what} rank {r['rank']}"
            against_dry(got["steps"], dry_steps, who, faults)
            if job["profile"] and (got["collectives"] != want_coll
                                   or not want_coll["total"]):
                faults.append(f"{who}: collectives {got['collectives']} in "
                              f"the trace, {want_coll} in the dry run")
            whole = got["whole"]
            if (len(set(whole["bits"])) != 1
                    or len(set(whole["compact_bits"])) != 1
                    or not all(whole["leaves_equal"])):
                faults.append(f"{who}: per shard against whole leaves: "
                              f"{whole}")
            row["ranks"].append({"rank": r["rank"], "steps": got["steps"],
                                 "collectives": got.get("collectives"),
                                 "whole": whole, "seconds": got["seconds"]})
        row["dry_collectives_model"] = want_coll
        out["archs"][arch] = row
        print(f"{what} rank 0 seconds by part: "
              f"{ {k: round(v, 1) for k, v in first[0]['seconds'].items()} }",
              flush=True)
    print(name, json.dumps(out), flush=True)
    _raise(faults)
    compact, dense = [], []
    for arch in job["archs"]:
        for wire in job["wires"]:
            for kern, rows, n, k, sign in plans[arch][wire]:
                if kern == "topk_compact":
                    compact.append(check_compact(
                        dev, rows, n, k, dsp.capacity(k, n), sign, 10))
                    got = compact[-1]
                else:
                    dense.append(check_topk(dev, rows, n, k, sign, 10))
                    got = dense[-1]
                got["launches"] = at.get((kern, rows, n), 0)
                got["model"] = f"{arch} {RANK_MESH}"
                print(f"kernel check {name} {kern}", json.dumps(got),
                      flush=True)
    print(f"{name}: {time.perf_counter() - t0:.1f}s", flush=True)
    return compact, dense, totals


#: the mesh fault runtime on gemma3-1b (the wire's queue at depth 3: on
#: dense_psum 3 x 999,812,736 float32 payload values), and the
#: bidirectional policy with the ZeRO-1 master
LM_FAULTS = ("--faults", "preset:lossy", "--staleness-weight", "damped")
LM_BIDIR = ("--policy", "preset:lm_hetero_bidir", "--zero1")


def _same_records(a: dict, b: dict, what: str) -> None:
    for k in ("loss", "kind", "bits_up", "bits_down", "launches_per_sync",
              "rounds"):
        if a[k] != b[k]:
            raise AssertionError(f"{what}: {k} differs between the "
                                 f"runtimes: {a[k]} / {b[k]}")


def _same_up_bits(runs: dict, what: str) -> float:
    """The uplink bits of each sync on the two wires (round runs), within
    phase_lm's one float32 rounding of the ledger."""
    sparse, dense = (runs[w, "round"][0]["bits_up_per_sync"]
                     for w in ("sparse_allgather", "dense_psum"))
    if len(sparse) != len(dense):
        raise AssertionError(f"{what}: {len(sparse)} / {len(dense)} syncs")
    diff = 0.0
    for a, b in zip(sparse, dense):
        if abs(a - b) > 2.0 ** -23 * max(abs(a), abs(b)):
            raise AssertionError(f"{what}: uplink bits per sync: sparse {a} "
                                 f"vs dense {b}")
        diff = max(diff, abs(a - b))
    return diff


def phase_lm_faults(dev) -> dict:
    """gemma3-1b at full size through the launcher under ``--faults
    preset:lossy --staleness-weight damped`` (the mesh fault runtime) on
    both wires, the fault round (graphed where a round shape repeats)
    against ``--runtime step``: the same record (losses, kinds, both
    ledgers, launches, rounds); 7 launches a computing sync, none at a
    sync that only lands payloads; the uplink bits of each sync equal
    across the wires; the dense wire's queue is 3 x 3,999,250,944
    bytes."""
    runs, totals = {}, {}
    for wire in ("sparse_allgather", "dense_psum"):
        for runtime in ("round", "step"):
            row, launches, rec = lm_run(wire, dev, None, runtime, LM_FAULTS,
                                        steps=LM["steps"])
            runs[wire, runtime] = (row, rec)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
        a, b = runs[wire, "round"][1], runs[wire, "step"][1]
        _same_records(a, b, f"LM faults {wire}")
        if not a["computes"] or not any(a["computes"]):
            raise AssertionError(f"LM faults {wire}: no computing sync")
        print(f"lm faults {wire}: round runtime equals --runtime step; "
              f"kinds {a['kind']}, computing syncs {a['computes']}, "
              f"{a['captures']} captures of {a['round_shapes']} round "
              f"programs; ms a step "
              f"{runs[wire, 'round'][0]['ms_per_step_median']:.1f} fault "
              f"round, {runs[wire, 'step'][0]['ms_per_step_median']:.1f} "
              f"eager; queue {a['queue_bytes']} bytes, peak "
              f"{a['peak_device_bytes']} / {b['peak_device_bytes']} bytes",
              flush=True)
    want = 3 * LM["n_params"] * 4
    got = runs["dense_psum", "round"][1]["queue_bytes"]
    if got != want:
        raise AssertionError(f"LM faults: dense queue {got} bytes, want "
                             f"{want}")
    diff = _same_up_bits(runs, "LM faults")
    print(f"lm faults wires: uplink bits per sync differ by at most {diff}",
          flush=True)
    return totals


def downlink_stacks() -> int:
    """The Top_k stacks of lm_hetero_bidir's downlink on gemma3-1b (the
    plans are the same at the smoke size): one kernel launch each a
    sync, on top of the uplink's 7."""
    import torch
    from repro_torch.configs import get_config, get_policy_preset
    from repro_torch.core import policy as pol
    from repro_torch.core.distributed import ShardCompressor
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves
    cfg = get_config(LM["arch"], smoke=True)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
    spec = pol.as_channel_spec(get_policy_preset("lm_hetero_bidir",
                                                 arch=LM["arch"]))
    comp = ShardCompressor.from_spec(spec.downlink, params)
    leaves = tree_leaves(params)
    return sum(plan[0] == "axis" and not comp._skip(tuple(x.shape))
               for plan, x in zip(comp._plans(len(leaves)), leaves))


def phase_lm_bidir(dev) -> dict:
    """gemma3-1b at full size through the launcher under ``--policy
    preset:lm_hetero_bidir --zero1`` (a compressed downlink; the ZeRO-1
    master, whole at one rank) on both wires, graphed against
    ``--runtime step``: the same record; the uplink's 7 and the
    downlink's Top_k stacks launched a sync; ``bits_down`` follows the
    downlink's counted bits, below the dense broadcast's."""
    runs, totals = {}, {}
    down = downlink_stacks()
    for wire in ("sparse_allgather", "dense_psum"):
        for runtime in ("round", "step"):
            row, launches, rec = lm_run(wire, dev, None, runtime, LM_BIDIR,
                                        down_stacks=down)
            runs[wire, runtime] = (row, rec)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
        a = runs[wire, "round"][1]
        _same_records(a, runs[wire, "step"][1], f"LM bidir {wire}")
        dense = 32.0 * LM["n_params"] * a["kind"].count("sync")
        if not 0 < a["bits_down"][-1] < dense:
            raise AssertionError(f"LM bidir {wire}: bits_down "
                                 f"{a['bits_down'][-1]}, the dense "
                                 f"broadcast {dense}")
        print(f"lm bidir {wire}: round runtime equals --runtime step; "
              f"{LM['topk_stacks']} + {down} launches a sync; bits down "
              f"{a['bits_down'][-1]:.6g} (dense broadcast {dense:.6g}); ms "
              f"a step {runs[wire, 'round'][0]['ms_per_step_median']:.1f} "
              f"graphed, {runs[wire, 'step'][0]['ms_per_step_median']:.1f}"
              f" eager; peak {a['peak_device_bytes']} / "
              f"{runs[wire, 'step'][1]['peak_device_bytes']} bytes",
              flush=True)
    diff = _same_up_bits(runs, "LM bidir")
    print(f"lm bidir wires: uplink bits per sync differ by at most {diff}",
          flush=True)
    return totals


def _rank_run(tmp: str, tag: str, wire: str, dispatch: str,
              runtime: str = "round", backend: str = "gloo",
              ranks: int = LM_RANKS["ranks"], extra: tuple = (),
              mesh: str = None) -> dict:
    """The launcher on the gemma3-1b smoke model at ``ranks`` ranks (by
    default LM_RANKS' ranks sharing the card over gloo; under NCCL one
    rank a card), with ``extra`` flags (a scenario): rank 0's run record
    (--json) and the path of its master (--ckpt).  ``mesh``: a ``DxM``
    mesh in place of ``{ranks}x1`` (its D * M ranks)."""
    from repro_torch.launch.mesh import mesh_ranks, run_local_ranks
    if mesh is not None:
        ranks = mesh_ranks(mesh)
    mesh = mesh or f"{ranks}x1"
    workers = ranks // int(mesh.split("x")[-1])
    ckpt, record = os.path.join(tmp, tag), os.path.join(tmp, tag + ".json")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           LM["arch"], "--smoke", "--mesh", mesh,
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
    if len(rec["loss"]) != LM_RANKS["steps"] or rec["R"] != workers:
        raise AssertionError(f"{tag}: {len(rec['loss'])} steps, R={rec['R']}")
    rec["ckpt"] = ckpt
    return rec


def _rank_runs(tmp: str, specs) -> dict:
    """:func:`_rank_run` over (tag, wire, dispatch, runtime, extra) specs,
    all at once on the card (their ranks mostly start up: 12 smoke-model
    processes beside the tensor-parallel ranks): the records by tag."""
    with ThreadPoolExecutor(len(specs)) as pool:
        runs = {tag: pool.submit(_rank_run, tmp, tag, wire, dispatch,
                                 runtime, extra=ex)
                for tag, wire, dispatch, runtime, ex in specs}
        return {tag: run.result() for tag, run in runs.items()}


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
        runs = _rank_runs(tmp, (
            ("sparse_kernel", "sparse_allgather", "kernel", "round", ()),
            ("sparse_reference", "sparse_allgather", "reference", "round",
             ()),
            ("dense_kernel", "dense_psum", "kernel", "round", ()),
            ("sparse_step", "sparse_allgather", "kernel", "step", ()),
            ("sparse_scenario", "sparse_allgather", "kernel", "round",
             LM_SCENARIO),
            ("dense_scenario", "dense_psum", "kernel", "round",
             LM_SCENARIO)))
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



#: the multi-rank fault and downlink runs: worker 1 down for steps 2-4
RANK_FAULTS = ("--faults", "preset:chaos")
RANK_BIDIR = ("--policy", "preset:lm_hetero_bidir")


def phase_lm_ranks_mesh(dev):
    """The mesh fault runtime, ZeRO-1 and the compressed downlink at
    LM_RANKS' ranks sharing the card over gloo (the smoke model; the
    round runtime is the per-step composition there): under
    ``--faults preset:chaos`` the two wires give the same kinds and bits
    and masters within rtol 1e-5 / atol 1e-6, and the fault round equals
    ``--runtime step`` (record and master); ``--zero1`` equals the whole
    master's run (record and the gathered master, bit for bit); the
    downlink on the two wires gives the same kinds and bits and masters
    within the same tolerance."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint
    from repro_torch.tree import tree_leaves
    t0 = time.perf_counter()
    like = tf.init_params(torch.Generator().manual_seed(0),
                          get_config(LM["arch"], smoke=True), device="cpu")

    def master(run):
        return tree_leaves(checkpoint.restore(run["ckpt"], like))

    def same_wires(a, b, what):
        if a["kind"] != b["kind"] or a["bits_up"] != b["bits_up"] or \
                a["bits_down"] != b["bits_down"]:
            raise AssertionError(f"{what}: the wires differ: {a['kind']} / "
                                 f"{b['kind']}, {a['bits_up']} / "
                                 f"{b['bits_up']}")
        err = 0.0
        for x, y in zip(master(a), master(b)):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
            err = max(err, float((x - y).abs().max()))
        return err

    with tempfile.TemporaryDirectory(dir=os.path.join(
            SRC, "repro_torch", "kernels", "build")) as tmp:
        runs = _rank_runs(tmp, (
            ("sparse_faults", "sparse_allgather", "kernel", "round",
             RANK_FAULTS),
            ("dense_faults", "dense_psum", "kernel", "round", RANK_FAULTS),
            ("sparse_faults_step", "sparse_allgather", "kernel", "step",
             RANK_FAULTS),
            ("sparse_bidir", "sparse_allgather", "kernel", "round",
             RANK_BIDIR),
            ("sparse_bidir_z1", "sparse_allgather", "kernel", "round",
             RANK_BIDIR + ("--zero1",)),
            ("dense_bidir_z1", "dense_psum", "kernel", "round",
             RANK_BIDIR + ("--zero1",))))
        f_err = same_wires(runs["sparse_faults"], runs["dense_faults"],
                           "multi-rank faults")
        a, b = runs["sparse_faults"], runs["sparse_faults_step"]
        _same_records(a, b, "multi-rank faults")
        if not all(torch.equal(x, y) for x, y in zip(master(a), master(b))):
            raise AssertionError("multi-rank faults: the fault round's "
                                 "master differs from --runtime step")
        a, b = runs["sparse_bidir"], runs["sparse_bidir_z1"]
        _same_records(a, b, "multi-rank zero1")
        if not all(torch.equal(x, y) for x, y in zip(master(a), master(b))):
            raise AssertionError("multi-rank zero1: the gathered master "
                                 "differs from the whole master's run")
        d_err = same_wires(runs["sparse_bidir_z1"], runs["dense_bidir_z1"],
                           "multi-rank downlink")
    k = runs["sparse_faults"]
    print(f"lm ranks mesh: R={LM_RANKS['ranks']} over gloo; faults "
          f"{' '.join(RANK_FAULTS)}: kinds {k['kind']}, bits equal on both "
          f"wires ({k['bits_up'][-1]}), masters within {f_err:.3g}, fault "
          f"round = --runtime step; --zero1 = the whole master's run; "
          f"downlink wires: bits down "
          f"{runs['dense_bidir_z1']['bits_down'][-1]}, masters within "
          f"{d_err:.3g}; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)



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


#: the other model families at full width, served in-process (prefill,
#: then greedy ``decode_step``) in bf16 with random weights from a seed
#: under ``use_pallas``: batch, prompt tokens, new tokens, depth (None:
#: the config's)
FAMILY_SERVE = (
    {"arch": "rwkv6-3b", "batch": 4, "prompt": 1024, "new": 32,
     "layers": None},
    {"arch": "zamba2-7b", "batch": 4, "prompt": 2048, "new": 32,
     "layers": None},
    {"arch": "qwen3-moe-30b-a3b", "batch": 4, "prompt": 512, "new": 32,
     "layers": None},
)
#: the same shapes in float32 at full width and a cut depth: the kernel
#: path against the plain path within 2^-7 of each row's largest logit
FAMILY_F32_LAYERS = {"rwkv6-3b": 4, "zamba2-7b": 12, "qwen3-moe-30b-a3b": 4}
#: ... and trained through the launcher at full width, R = 1, the depth
#: cut so that a run's peak stays under FAMILY_PEAK_BYTES, and for the
#: script's time (rwkv6-3b and zamba2-7b at 6 layers: zamba2's shared
#: block then runs once, before layer 0)
FAMILY_TRAIN = {"batch": 2, "seq": 1024, "steps": 8, "H": 4,
                "layers": {"qwen3-moe-30b-a3b": 1, "rwkv6-3b": 6,
                           "zamba2-7b": 6}}
FAMILY_PEAK_BYTES = 70 * 2 ** 30
#: what each family's preset:arch resolves, by DSL rule (first match
#: wins): (pattern, the operator of the leaves it matches, the operator
#: of the rest)
FAMILY_RULES = {"budget_1pct": ("attn|mlp|ffn|expert|proj|mixer", "TopK",
                                "Identity"),
                "sign_hetero": ("ln|norm|bias|scale", "Identity",
                                "SignSparsifier")}


def family_config(arch: str, layers=None, **kw):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        kw["n_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def family_attention_launches(cfg) -> tuple:
    """(flash_attention launches a prefill, flash_decode launches a
    decode step) of a family under ``use_pallas``: Zamba2's shared block
    once each an application (its window is static), MoE's scanned
    periods none at prefill and one a layer at decode, RWKV-6 none."""
    from repro_torch.models import zamba2
    if cfg.family == "zamba2":
        apps = len(zamba2.shared_apps(cfg))
        return apps, apps
    if cfg.family == "moe":
        return 0, cfg.n_layers
    return 0, 0


def phase_family_kernels(dev):
    """The attention kernels at the other families' serving shapes:
    flash_attention at zamba2-7b's prefill (4 prompts of 2048, 32 heads
    of 112 on 32 kv heads, causal), flash_decode at zamba2-7b's decode
    (batch 4, 32 / 32 heads of 112, a 2080-slot ring, 2048-2080 valid)
    and qwen3-moe-30b-a3b's (32 / 4 heads of 128, a 544-slot ring,
    512-544 valid).  Returns the (flash_attention, flash_decode) rows."""
    fa = [check_flash_attention(dev, 4, 2048, 32, 32, 112, -1, 5)]
    fd = [check_flash_decode(dev, 10, B=4, H=32, KV=32, hd=112, C=2080,
                             lengths=(2048, 2081)),
          check_flash_decode(dev, 10, B=4, H=32, KV=4, hd=128, C=544,
                             lengths=(512, 545))]
    fa[0]["model"] = "zamba2-7b prefill"
    fd[0]["model"], fd[1]["model"] = "zamba2-7b decode", "qwen3-moe decode"
    for name, rows in (("flash_attention", fa), ("flash_decode", fd)):
        for row in rows:
            print(f"kernel check {name} ({row['model']})", json.dumps(row),
                  flush=True)
    return fa, fd


@contextlib.contextmanager
def held_to_plain(worst: dict):
    """While open, every call of the attention kernels' dispatch entries
    (``flash_attention``, ``flash_decode``) also runs the kernel's plain
    version on the same inputs, and the kernel's output is held to it
    within 2^-7 of each row's largest |output| (one bf16 rounding);
    ``worst`` keeps the largest such error of each kernel.  The plain
    versions launch nothing."""
    from repro_torch.kernels import dispatch as dsp
    from repro_torch.kernels import ref
    fa, fd = dsp.flash_attention, dsp.flash_decode

    def hold(name, out, want):
        err = close_per_row(out, want, 2 ** -7, f"{name} on the main path")
        worst[name] = max(worst.get(name, 0.0), err[1])
        return out

    def flash_attention(q, k, v, window=-1, cfg=None):
        return hold("flash_attention", fa(q, k, v, window, cfg),
                    ref.flash_attention_ref(q, k, v, window=window))

    def flash_decode(q, k, v, valid, cfg=None):
        return hold("flash_decode", fd(q, k, v, valid, cfg),
                    ref.flash_decode_ref(q, k, v, valid))

    dsp.flash_attention, dsp.flash_decode = flash_attention, flash_decode
    try:
        yield worst
    finally:
        dsp.flash_attention, dsp.flash_decode = fa, fd


def row_gap(out, want) -> float:
    """The largest |out - want| of a row over that row's largest
    |want|, over the rows (logits [B, V])."""
    o, w = (t.float().reshape(t.shape[0], -1) for t in (out, want))
    return float(((o - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp_min(1e-30)).max())


#: the draws of one bf16 rounding's error whose largest effect on the
#: logits is the noise floor of ``family_serve_run``
FLOOR_SEEDS = (2, 3, 4, 5)


def one_rounding(x, seed: int):
    """``x`` (bf16) moved by one rounding's error: each element one ulp
    up or down with probability 1/24 each, an error of variance ulp^2 /
    12, that of one rounding to bf16 (uniform within half an ulp), with
    no second rounding (x +- ulp is a bf16 value: a step of the bit
    pattern, +-1 times the sign; zeros stay)."""
    import torch
    g = torch.Generator(device=x.device).manual_seed(seed)
    u = torch.rand(x.shape, generator=g, device=x.device)
    step = (u < 1 / 24).to(torch.int16) - (u > 1 - 1 / 24).to(torch.int16)
    del u
    step *= torch.sign(x).to(torch.int16)
    return (x.view(torch.int16) + step).view(x.dtype)


def family_serve_run(dev, spec: dict) -> tuple:
    """One family at full width (bf16, random weights from a seed):

    1. the plain path (``use_pallas=False``): prefill, and a first decode
       step on its greedy token; again, FLOOR_SEEDS times, with the
       embedding table perturbed by one bf16 rounding's error
       (``one_rounding``): the largest gap to the first run is the
       logits' noise floor, what one rounding at the input moves them;
    2. the kernel path (``use_pallas=True``) on the same inputs under
       ``held_to_plain``: each kernel call held to its plain version on
       the main path's own inputs within 2^-7 of each row's largest; its
       prefill logits and first-step logits within max(2^-7, the noise
       floor) of the plain path's, each row to its largest (the
       kernels' rounding differences at 14-48 attention calls amplified
       through a deep random-weight stack as the floor's one rounding
       is; ``family_f32_run`` holds the same path in float32 to 2^-7);
    3. the kernel path timed: prefill, then ``spec["new"]`` greedy decode
       steps, asserting the attention kernels' launches a prefill and a
       step and no other launch.

    Returns (the printed row, the launches of 3)."""
    import dataclasses
    import hashlib
    import torch
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import get_model
    from repro_torch.tree import tree_leaves
    cfg = family_config(spec["arch"], spec["layers"], use_pallas=True)
    plain = dataclasses.replace(cfg, use_pallas=False)
    m = get_model(cfg)
    B, S, new = spec["batch"], spec["prompt"], spec["new"]
    max_len = S + new
    want_fa, want_fd = family_attention_launches(cfg)
    _free_graphs()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = m.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    # the prefill's arguments as the allocator holds them
    argument_bytes = torch.cuda.memory_allocated(dev) - before

    def first_logits(p, c):
        """(prefill logits [B, V], the first decode step's on tok0)."""
        logits, cache, _ = m.prefill(p, {"tokens": toks}, c,
                                     max_len=max_len)
        step, _ = m.decode_step(p, cache, tok0, S, c)
        return logits.reshape(B, -1), step

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    worst: dict = {}
    with torch.no_grad():
        (lp, cache, _), plain_prefill_ms = timed(lambda: m.prefill(
            params, {"tokens": toks}, plain, max_len=max_len))
        lp = lp.reshape(B, -1)
        tok0 = lp.argmax(-1)
        lp1, _ = m.decode_step(params, cache, tok0, S, plain)
        del cache
        e = params["embed"]
        floor = [0.0, 0.0]
        for seed in FLOOR_SEEDS:
            params["embed"] = one_rounding(e, seed)
            floor = [max(f, row_gap(x, y)) for f, x, y in zip(
                floor, first_logits(params, plain), (lp, lp1))]
        params["embed"] = e
        with held_to_plain(worst):
            gaps = [row_gap(x, y) for x, y in zip(first_logits(params, cfg),
                                                  (lp, lp1))]
        for what, gap, fl in zip(("prefill", "first step"), gaps, floor):
            if gap > max(2 ** -7, fl):
                raise AssertionError(
                    f"{cfg.name} {what} logits: kernel path {gap} of the "
                    f"row's largest from the plain path, over the noise "
                    f"floor {fl}")
        reset_launches()
        # the prefill's own peak, over what was live before it (the
        # dry run's prediction is held against it in phase_dryrun)
        run_peak = torch.cuda.max_memory_allocated(dev)
        live = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        (logits, cache, _), prefill_ms = timed(lambda: m.prefill(
            params, {"tokens": toks}, cfg, max_len=max_len))
        prefill_peak = torch.cuda.max_memory_allocated(dev) - live
        got = {k: v for k, v in LAUNCHES.items() if v}
        if got != ({"flash_attention": want_fa} if want_fa else {}):
            raise AssertionError(f"{cfg.name} prefill launched {got}, want "
                                 f"{want_fa} flash_attention")
        totals = dict(got)
        reset_launches()
        tok, steps = logits.reshape(B, -1).argmax(-1), []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(new):
            logits, cache = m.decode_step(params, cache, tok, S + i, cfg)
            tok = logits.argmax(-1)
            steps.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t) * 1e3 / new
        got = {k: v for k, v in LAUNCHES.items() if v}
        if got != ({"flash_decode": want_fd * new} if want_fd else {}):
            raise AssertionError(f"{cfg.name} decode launched {got} in {new} "
                                 f"steps, want {want_fd} flash_decode a step")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: non-finite logits")
    tokens = torch.stack(steps, dim=1).cpu().numpy()
    row = {"card": card(), "arch": cfg.name, "family": cfg.family,
           "layers": cfg.n_layers, "full_layers": family_config(
               spec["arch"]).n_layers, "n_params": n_params,
           "batch": B, "prompt": S, "new_tokens": new, "init_s": init_s,
           "prefill_ms": prefill_ms, "plain_prefill_ms": plain_prefill_ms,
           "decode_ms_per_step": decode_ms,
           "peak_device_bytes": max(run_peak,
                                    torch.cuda.max_memory_allocated(dev)),
           "prefill_peak_over_live_bytes": prefill_peak,
           "prefill_argument_bytes": argument_bytes,
           "max_len": max_len,
           "launches_per_prefill": {"flash_attention": want_fa},
           "launches_per_step": {"flash_decode": want_fd},
           "kernel_call_max_row_rel_err": worst,
           "logits_row_gap": {"prefill": gaps[0], "first_step": gaps[1]},
           "noise_floor": {"prefill": floor[0], "first_step": floor[1]},
           "tokens_digest": hashlib.sha1(tokens.tobytes()).hexdigest()[:16]}
    print("family serve", json.dumps(row), flush=True)
    del params, cache, logits, lp, lp1, e
    _free_graphs()
    return row, totals


def family_f32_run(dev, spec: dict) -> dict:
    """``spec``'s arch at full width and FAMILY_F32_LAYERS' depth in
    float32 (random weights from a seed), the same batch and prompt: the
    kernel path's (``use_pallas``) prefill logits and first decode
    step's logits within 2^-7 of each row's largest of the plain path's
    (``use_pallas=False``), its attention kernels launched as the depth
    gives.  Returns the printed row."""
    import dataclasses
    import torch
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import get_model
    cfg = family_config(spec["arch"], FAMILY_F32_LAYERS[spec["arch"]],
                        use_pallas=True, param_dtype="float32",
                        act_dtype="float32")
    plain = dataclasses.replace(cfg, use_pallas=False)
    m = get_model(cfg)
    B, S = spec["batch"], spec["prompt"]
    want_fa, want_fd = family_attention_launches(cfg)
    _free_graphs()
    params = m.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    out = {}
    with torch.no_grad():
        for c in (plain, cfg):
            reset_launches()
            logits, cache, _ = m.prefill(params, {"tokens": toks}, c,
                                         max_len=S + 1)
            logits = logits.reshape(B, -1)
            if c is plain:
                tok0 = logits.argmax(-1)
            step, _ = m.decode_step(params, cache, tok0, S, c)
            out[c.use_pallas] = (logits, step,
                                 {k: v for k, v in LAUNCHES.items() if v})
            del cache
    want = {k: v for k, v in (("flash_attention", want_fa),
                              ("flash_decode", want_fd)) if v}
    if out[True][2] != want or out[False][2]:
        raise AssertionError(f"{cfg.name} float32: launches {out[True][2]} "
                             f"/ {out[False][2]}, want {want}")
    gaps = [row_gap(x, y) for x, y in zip(out[True][:2], out[False][:2])]
    for what, gap in zip(("prefill", "first step"), gaps):
        if not gap <= 2 ** -7:
            raise AssertionError(f"{cfg.name} float32 {what} logits: kernel "
                                 f"path {gap} of the row's largest from the "
                                 f"plain path, over 2^-7")
    row = {"card": card(), "arch": cfg.name, "dtype": "float32",
           "layers": cfg.n_layers, "batch": B, "prompt": S,
           "launches": want,
           "logits_row_gap": {"prefill": gaps[0], "first_step": gaps[1]}}
    print("family float32", json.dumps(row), flush=True)
    del params, out
    _free_graphs()
    return row


def family_smoke_agreement(dev) -> None:
    """The three families' smoke configs in float32 under ``use_pallas``,
    prefill and 8 greedy decode steps with dispatch "kernel" (the
    float32 attention kernels where the family has them) against
    "reference": the same tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch as dsp
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.models import get_model
    for spec in FAMILY_SERVE:
        cfg = dataclasses.replace(get_config(spec["arch"], smoke=True),
                                  use_pallas=True)
        m = get_model(cfg)
        params = m.init_params(torch.Generator(device=dev).manual_seed(3),
                               cfg, device=dev)
        toks = torch.randint(0, cfg.vocab, (2, 24), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(4))
        out = {}
        with torch.no_grad():
            for mode in ("kernel", "reference"):
                d = dsp.DispatchConfig(mode=mode)
                reset_launches()
                logits, cache, S = m.prefill(params, {"tokens": toks}, cfg,
                                             d, max_len=40)
                tok = logits.reshape(2, -1).argmax(-1)
                seq = [tok]
                for i in range(8):
                    logits, cache = m.decode_step(params, cache, tok, S + i,
                                                  cfg, d)
                    tok = logits.argmax(-1)
                    seq.append(tok)
                out[mode] = (torch.stack(seq).cpu(),
                             {k: v for k, v in LAUNCHES.items() if v})
        fa, fd = family_attention_launches(cfg)
        want = {k: v for k, v in (("flash_attention", fa),
                                  ("flash_decode", fd * 8)) if v}
        if out["kernel"][1] != want or out["reference"][1]:
            raise AssertionError(f"{cfg.name}: launches {out['kernel'][1]} "
                                 f"/ {out['reference'][1]}, want {want}")
        if not torch.equal(out["kernel"][0], out["reference"][0]):
            raise AssertionError(f"{cfg.name}: kernel and reference "
                                 f"dispatch decode other tokens")
        print(f"family smoke {cfg.name}: float32 kernel = reference "
              f"dispatch, 9 greedy tokens x 2 rows equal, kernel "
              f"launches {want}", flush=True)


def phase_family_serve(dev):
    """rwkv6-3b, zamba2-7b and qwen3-moe-30b-a3b served at full width
    (``family_serve_run``), each followed by its float32 check at a cut
    depth (``family_f32_run``), then the smoke configs' kernel-vs-
    reference agreement.  Returns the launches of the bf16 runs; their
    rows are kept in ``FAMILY_ROWS`` (``phase_dryrun`` reads zamba2-7b's
    prefill)."""
    totals: dict = {}
    for spec in FAMILY_SERVE:
        row, launches = family_serve_run(dev, spec)
        FAMILY_ROWS[spec["arch"]] = row
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        family_f32_run(dev, spec)
    family_smoke_agreement(dev)
    return totals


#: the rows of ``phase_family_serve``'s bf16 runs, by arch
FAMILY_ROWS: dict = {}


def family_policy(arch: str, layers: int) -> int:
    """Prints the per-leaf table that ``preset:arch`` resolves to on the
    arch at full width and ``layers`` deep (a ``meta`` tree), checks it
    against the preset's DSL rule (FAMILY_RULES: under budget_1pct a
    leaf that matches none of its patterns, such as the expert stacks
    ``layers/moe/w1``, is Identity) and returns the ``topk_compact``
    launches a sync on the card, counted from the table: one for each
    TopK / SignSparsifier leaf on the sparse wire, less each leaf that
    the dispatch rule's limits send to the plain version (under "auto"
    a leaf below ``min_size`` elements; a row that is not a multiple of
    128 lanes or is longer than ``max_row``; a survivor capacity above
    ``max_cap``), printed with its reason."""
    import re
    from repro_torch.configs import get_policy_preset
    from repro_torch.configs.policies import ARCH_POLICIES
    from repro_torch.core import policy as pol
    from repro_torch.core.distributed import ShardCompressor, ops_for_leaves
    from repro_torch.core.operators import resolve_k
    from repro_torch.kernels import dispatch as dsp
    from repro_torch.models import get_model
    from repro_torch.sharding.specs import param_specs
    cfg = family_config(arch, layers)
    params = get_model(cfg).init_params(None, cfg, device="meta")
    spec = pol.as_channel_spec(get_policy_preset("arch", arch=arch))
    comp = ShardCompressor.from_spec(spec.uplink, params, dispatch=DISPATCH)
    paths, leaves, _ = pol.tree_paths(params)
    ops = ops_for_leaves(comp.ops, len(leaves))
    meta = comp.leaf_meta(params, param_specs(cfg))
    pattern, hit, miss = FAMILY_RULES[ARCH_POLICIES[arch]]
    d = dsp.DispatchConfig(mode=DISPATCH)
    table, plain, launches = [], [], 0
    for path, leaf, op, (kind, _ax, moved) in zip(paths, leaves, ops, meta):
        name = type(op).__name__
        want = hit if re.search(pattern, path) else miss
        if name != want:
            raise AssertionError(f"{arch}: {path} resolves to {name}, the "
                                 f"DSL rule gives {want}")
        row, route = None, "dense wire"
        if kind == "sparse":
            if name not in ("TopK", "SignSparsifier"):
                raise AssertionError(f"{arch}: {path} ({name}) on the "
                                     f"sparse wire")
            row = moved[-1]
            kcap = dsp.capacity(resolve_k(op.k, row), row)
            why = [what for what, bad in (
                (f"{leaf.numel()} elements < min_size {d.min_size}",
                 d.mode == "auto" and leaf.numel() < d.min_size),
                (f"row {row} not a multiple of {dsp.LANES}",
                 row % dsp.LANES != 0),
                (f"row {row} > max_row {d.max_row}", row > d.max_row),
                (f"kcap {kcap} > max_cap {d.max_cap}", kcap > d.max_cap))
                if bad]
            route = "plain: " + "; ".join(why) if why else "kernel"
            launches += not why
            if why:
                plain.append([path, list(leaf.shape), route])
        table.append([path, list(leaf.shape), name,
                      round(getattr(op, "k", 1.0), 6), kind, row, route])
    print(f"family policy {arch} ({ARCH_POLICIES[arch]}, {layers} layers): "
          f"{launches} topk_compact launches a sync",
          json.dumps(table), flush=True)
    print(f"family policy {arch}: {len(plain)} sparse leaves on the plain "
          f"version", json.dumps(plain), flush=True)
    return launches


def family_train_run(dev, arch: str, runtime: str, per_sync: int) -> tuple:
    """The launcher on ``arch`` at full width, FAMILY_TRAIN's depth, R =
    1 (NCCL), the sparse wire, ``preset:arch``.  Asserts finite losses,
    ``per_sync`` topk_compact launches a sync and nothing else, one
    capture a repeated round shape (round runtime), the peak under
    FAMILY_PEAK_BYTES.  Returns (row, record, launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.launch import train as lt
    F = FAMILY_TRAIN
    argv = ["--arch", arch, "--mesh", "1x1", "--policy", "preset:arch",
            "--batch", str(F["batch"]), "--seq", str(F["seq"]),
            "--steps", str(F["steps"]), "--H", str(F["H"]),
            "--wire", "sparse_allgather", "--dispatch", DISPATCH,
            "--runtime", runtime]
    _free_graphs()
    torch.cuda.synchronize()
    reset_launches()
    rec = lt.main(argv, n_layers=F["layers"][arch])
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    _free_graphs()
    kinds = rec["kind"]
    n_syncs = kinds.count("sync")
    if launches != {"topk_compact": per_sync * n_syncs}:
        raise AssertionError(f"{arch}: {launches} in {n_syncs} syncs, want "
                             f"{per_sync} topk_compact a sync")
    if not all(np.isfinite(rec["loss"])):
        raise AssertionError(f"{arch}: loss not finite: {rec['loss']}")
    if runtime == "round" and (rec["fused"] is not True
                               or rec["captures"] != lm_captures(kinds)):
        raise AssertionError(f"{arch}: fused {rec['fused']}, captures "
                             f"{rec['captures']}")
    if rec["peak_device_bytes"] > FAMILY_PEAK_BYTES:
        raise AssertionError(f"{arch}: peak {rec['peak_device_bytes']} "
                             f"bytes")
    round_ms = rec.get("round_ms") or [
        sum(rec["ms"][i:i + F["H"]]) for i in range(0, F["steps"], F["H"])]
    row = {"card": card(), "arch": arch, "runtime": runtime,
           "layers": F["layers"][arch], "n_params": rec["n_params"],
           "loss": rec["loss"], "kinds": kinds, "bits_up": rec["bits_up"],
           "ms_per_step": rec["ms"], "ms_per_round": round_ms,
           "ms_per_step_late": round_ms[-1] / F["H"],
           "peak_device_bytes": rec["peak_device_bytes"],
           "captures": rec.get("captures", 0),
           "launches_per_sync": {"topk_compact": per_sync}}
    print("family train", json.dumps(row), flush=True)
    return row, rec, launches


def phase_family_train(dev) -> dict:
    """qwen3-moe-30b-a3b, rwkv6-3b and zamba2-7b through the launcher at
    full width (FAMILY_TRAIN's depths), each under the round runtime
    (one CUDA graph a round) and ``--runtime step``: the same record
    step by step.  Returns the launches."""
    totals: dict = {}
    for arch in FAMILY_TRAIN["layers"]:
        per_sync = family_policy(arch, FAMILY_TRAIN["layers"][arch])
        recs = {}
        for runtime in ("round", "step"):
            _, recs[runtime], launches = family_train_run(dev, arch, runtime,
                                                          per_sync)
            for k, v in launches.items():
                totals[k] = totals.get(k, 0) + v
        _same_records(recs["round"], recs["step"], f"family train {arch}")
        print(f"family train {arch}: round runtime equals --runtime step",
              flush=True)
    return totals


#: the dry run's full-size records on ``dp256`` (phase_dryrun (a))
DRY_FULL = (("gemma3-1b", "train_4k"), ("yi-6b", "decode_32k"),
            ("zamba2-7b", "long_500k"))
#: how far a measured peak, its arguments or its temporaries may sit
#: from the dry run's prediction (the card's readings, PERF.md: 0.002-
#: 0.18 % a peak, at most 0.37 % a part)
DRY_PEAK_TOL = 0.01
#: the 2-rank collectives check: the gemma3-1b smoke model, 2 gloo ranks
#: sharing the card, one sync step a wire profiled in each rank
DRY_RANKS = {"ranks": 2, "seq": 64, "global_batch": 2}
DRY_RANK_CODE = r"""
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
mesh = make_mesh("{ranks}x1", device="cuda", backend="gloo")
try:
    ops = set()
    out = dryrun.profile_sync_collectives(
        "gemma3-1b", get_config("gemma3-1b", smoke=True), mesh,
        InputShape("ranks", {seq}, {global_batch}, "train"),
        ("dense_psum", "sparse_allgather"), mesh.device, seen=ops)
    if mesh.rank == 0:
        print("COLLECTIVES " + json.dumps({{"bytes": out,
                                             "ops": sorted(ops)}}))
finally:
    mesh.close()
"""


def _lm_cell():
    from repro_torch.configs.base import InputShape
    return (InputShape("lm_cell", LM["seq"], LM["batch"], "train"),
            dict(aggregate="sparse_allgather", policy="preset:arch"))


def _family_prefill():
    from repro_torch.configs.base import InputShape
    spec = next(s for s in FAMILY_SERVE if s["arch"] == "zamba2-7b")
    return spec, InputShape("family_prefill", spec["prompt"], spec["batch"],
                            "prefill")


def _ranks_shape():
    from repro_torch.configs.base import InputShape
    return InputShape("ranks", DRY_RANKS["seq"], DRY_RANKS["global_batch"],
                      "train")


def dry_records() -> dict:
    """Every dry-run record ``phase_dryrun`` holds against the card, on
    the ``meta`` device: host work only, run in a process of its own
    while the card runs the other phases (``main`` starts it)."""
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    from repro_torch.launch import dryrun as dr
    shape, kw = _lm_cell()
    spec, prefill = _family_prefill()
    t = time.perf_counter()
    out = {"full": [dr.run_one(a, s) for a, s in DRY_FULL],
           "lm": dr.run_one(LM["arch"], shape=shape, mesh="1x1", **kw),
           "prefill": dr.run_one(spec["arch"], shape=prefill, mesh="1x1",
                                 cfg_overrides={"use_pallas": True},
                                 max_len=spec["prompt"] + spec["new"]),
           "ranks": {wire: dr.run_one(
               LM["arch"], shape=_ranks_shape(), smoke=True,
               mesh=f"{DRY_RANKS['ranks']}x1", aggregate=wire)
               for wire in ("dense_psum", "sparse_allgather")},
           "jobs": {name: rank_dry_records(name) for name in RANK_JOBS}}
    out["seconds"] = time.perf_counter() - t
    return out


def _ok(rec: dict, what: str) -> dict:
    if rec["status"] != "ok":
        raise AssertionError(f"dry run of {what}: "
                             f"{rec.get('error', rec['status'])}")
    return rec


def _near(got: float, want: float, what: str, faults: list) -> float:
    """|got - want| / want; a fault noted past DRY_PEAK_TOL."""
    rel = abs(got - want) / want
    if rel > DRY_PEAK_TOL:
        faults.append(f"{what}: measured {got} bytes, the dry run predicts "
                      f"{want} ({rel:.3f} apart, more than {DRY_PEAK_TOL})")
    return rel


def _raise(faults: list) -> None:
    """The checks of a dry-run comparison fail after its row is printed."""
    if faults:
        raise AssertionError("; ".join(faults))


def dry_lm_cell(dev, dry: dict) -> dict:
    """(b) gemma3-1b as ``phase_lm`` trains it (``full()``, one worker,
    batch 2 of 2048, the sparse wire, ``preset:arch``): the dry run's
    record of the cell, then one eager ``local_step`` and one eager
    ``sync_step`` of the same job on the card, each measured as the dry
    run measures (FlopCounterMode, the kernels' costs through the
    launch sink), after ``reset_peak_memory_stats``: FLOPs equal
    exactly, launches equal, and each within DRY_PEAK_TOL of its
    prediction: the peak over what was live before the job (argument +
    temp bytes), the bytes live when the step starts (arguments) and
    the peak over them (temporaries).
    Then phase_lm's graphed ms a step as a share of the peak.  ``dry``:
    the cell's record (``dry_records``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import Mesh
    shape, kw = _lm_cell()
    _ok(dry, "the LM cell")
    _free_graphs()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    mesh = Mesh((1, 1), ("data", "model"), device=dev)
    job = dr.build_train(LM["arch"], get_config(LM["arch"]), mesh, shape,
                         device=dev, **kw)
    state = dr.steady_state(job.init_fn(job.params))
    del job.params
    out, faults = {"card": card(), "steps": {}}, []
    for name in ("local_step", "sync_step"):
        want = dry["steps"][name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        live = torch.cuda.memory_allocated(dev) - base
        result, got = dr.measure(job.steps[name], (state, job.batch), mesh)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        del result
        if got["flops"] != want["flops"]:
            faults.append(f"LM cell {name}: {got['flops']} FLOPs on the "
                          f"card, {want['flops']} in the dry run")
        if got["launches"] != want["launches"]:
            faults.append(f"LM cell {name}: launches {got['launches']} on "
                          f"the card, {want['launches']} dry")
        mem = want["memory"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        rel = _near(peak, predicted, f"LM cell {name} peak", faults)
        rel_arg = _near(live, mem["argument_bytes"],
                        f"LM cell {name} arguments", faults)
        rel_temp = _near(peak - live, mem["temp_bytes"],
                         f"LM cell {name} temporaries", faults)
        out["steps"][name] = {
            "flops": got["flops"], "dry_flops": want["flops"],
            "kernel_flops": got["kernel_flops"],
            "launches": got["launches"], "peak_bytes": peak,
            "live_before_bytes": live, "predicted_bytes": predicted,
            "predicted_argument_bytes": mem["argument_bytes"],
            "predicted_temp_bytes": mem["temp_bytes"],
            "card_meter_temp_bytes": got["memory"]["temp_bytes"],
            "rel_gap": rel, "rel_gap_arguments": rel_arg,
            "rel_gap_temp": rel_temp}
    del job, state
    _free_graphs()
    H = LM["H"]
    steps = out["steps"]
    round_flops = (H - 1) * steps["local_step"]["flops"] + steps[
        "sync_step"]["flops"]
    ms = LM_STEP_MS.get(("sparse_allgather", "round"))
    terms = roofline.analyze(dry)
    out.update(dtype=dry["dtype"], round_flops=round_flops, terms={
        k: terms[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                              "dominant", "useful_ratio")})
    if ms is not None:
        rate = round_flops / (H * ms / 1e3)
        out.update(graphed_ms_per_step=ms, achieved_flops_per_s=rate,
                   share_of_peak=rate / roofline.PEAK_FLOPS[
                       getattr(torch, dry["dtype"])])
    print("dryrun lm cell", json.dumps(out), flush=True)
    _raise(faults)
    return out


def dry_family_prefill(dry: dict) -> dict:
    """(c) zamba2-7b's prefill as ``phase_family_serve`` ran it (bf16,
    ``use_pallas``, [4, 2048]): the dry run's predicted argument + temp
    bytes (``dry``, from ``dry_records``, at the card's cache length)
    against the card's (the arguments as the allocator holds them, plus
    the prefill's peak over what was live before it), each part and the
    sum within DRY_PEAK_TOL; the flash_attention launches equal."""
    spec, _ = _family_prefill()
    row = FAMILY_ROWS[spec["arch"]]
    st = _ok(dry, "zamba2-7b's prefill")["steps"]["prefill"]
    predicted = st["memory"]["argument_bytes"] + st["memory"]["temp_bytes"]
    measured = row["prefill_argument_bytes"] + row[
        "prefill_peak_over_live_bytes"]
    faults = []
    rel = _near(measured, predicted, "zamba2-7b prefill peak", faults)
    rel_arg = _near(row["prefill_argument_bytes"],
                    st["memory"]["argument_bytes"],
                    "zamba2-7b prefill arguments", faults)
    rel_temp = _near(row["prefill_peak_over_live_bytes"],
                     st["memory"]["temp_bytes"],
                     "zamba2-7b prefill temporaries", faults)
    if dry["max_len"] != row["max_len"]:
        faults.append(f"zamba2-7b prefill: cache of {row['max_len']} on "
                      f"the card, {dry['max_len']} in the dry run")
    if st["launches"] != row["launches_per_prefill"]:
        faults.append(f"zamba2-7b prefill: launches "
                      f"{row['launches_per_prefill']} on the card, "
                      f"{st['launches']} in the dry run")
    out = {"card": card(), "predicted_bytes": predicted,
           "predicted_argument_bytes": st["memory"]["argument_bytes"],
           "predicted_temp_bytes": st["memory"]["temp_bytes"],
           "measured_bytes": measured,
           "argument_bytes": row["prefill_argument_bytes"],
           "peak_over_live_bytes": row["prefill_peak_over_live_bytes"],
           "rel_gap": rel, "rel_gap_arguments": rel_arg,
           "rel_gap_temp": rel_temp, "launches": st["launches"],
           "card_max_len": row["max_len"], "dry_max_len": dry["max_len"],
           "flops": st["flops"], "prefill_ms": row["prefill_ms"]}
    print("dryrun family prefill", json.dumps(out), flush=True)
    _raise(faults)
    return out


def rank_collectives() -> dict:
    """(d)'s card half: DRY_RANKS' gloo ranks of the gemma3-1b smoke model
    on the one card, each profiling one sync step a wire; rank 0's
    collective bytes by wire and the communication records its trace
    named.  ``main`` runs it beside the multi-rank phases (host work,
    smoke-sized on the card)."""
    from repro_torch.launch.mesh import run_local_ranks
    code = DRY_RANK_CODE.format(src=SRC, **DRY_RANKS)
    procs = run_local_ranks([sys.executable, "-c", code], DRY_RANKS["ranks"],
                            env=dict(os.environ, PYTHONPATH=SRC),
                            timeout=300)
    for r, (rc, _out, err) in enumerate(procs):
        if rc != 0:
            raise AssertionError(f"collectives rank {r} exited {rc}:\n"
                                 f"{err[-3000:]}")
    line = next(l for l in procs[0][1].splitlines()
                if l.startswith("COLLECTIVES "))
    return json.loads(line[len("COLLECTIVES "):])


def dry_collectives(dry: dict, got: dict) -> dict:
    """(d) the collectives ``rank_collectives`` read from rank 0's trace
    (``got``) equal the dry run's at ``2x1`` (``dry``: its records by
    wire), by kind and in total."""
    out, faults = {"ops": got["ops"], "wires": {}}, []
    for wire, measured in got["bytes"].items():
        want = _ok(dry[wire], f"the {wire} ranks")["steps"]["sync_step"][
            "collectives"]
        if measured != want or not want["total"]:
            faults.append(f"collectives {wire}: {measured} in the trace, "
                          f"{want} in the dry run")
        out["wires"][wire] = {"trace": measured, "dry": want}
    print("dryrun collectives", json.dumps(out), flush=True)
    _raise(faults)
    return out


def phase_dryrun(dev, records: dict, ranks: dict) -> dict:
    """The dry run (``launch/dryrun.py``) held against the card, its
    records from ``dry_records``: (a) full size on ``dp256`` on meta
    (``DRY_FULL``), each ``ok`` with FLOPs, its roofline terms printed;
    (b) the gemma3-1b LM cell (``dry_lm_cell``); (c) zamba2-7b's prefill
    (``dry_family_prefill``); (d) the 2-rank collectives
    (``dry_collectives`` on ``ranks``, ``rank_collectives``' result)."""
    from repro_torch.launch import roofline
    print(f"dryrun: records on meta in {records['seconds']:.1f}s beside "
          f"the card's phases", flush=True)
    full = []
    for (arch, shape), rec in zip(DRY_FULL, records["full"]):
        if rec["status"] != "ok" or not all(
                st["flops"] > 0 for st in rec["steps"].values()):
            raise AssertionError(f"dry run {arch} x {shape}: "
                                 f"{rec.get('error', rec['status'])}")
        a = roofline.analyze(rec)
        row = {"arch": arch, "shape": shape, "mesh": rec["mesh"],
               "params": rec["params"], "fits": rec["fits"],
               "peak_bytes": rec["peak_bytes"], "dtype": rec["dtype"],
               "steps": {n: {"flops": st["flops"],
                             "bytes_accessed": st["bytes_accessed"],
                             "memory": st["memory"],
                             "collectives": st["collectives"]["total"],
                             "launches": st["launches"]}
                         for n, st in rec["steps"].items()},
               **{k: a[k] for k in ("t_compute_s", "t_memory_s",
                                    "t_collective_s", "dominant",
                                    "useful_ratio")}}
        print("dryrun", json.dumps(row), flush=True)
        full.append(row)
    return {"full": full, "lm": dry_lm_cell(dev, records["lm"]),
            "prefill": dry_family_prefill(records["prefill"]),
            "collectives": dry_collectives(records["ranks"], ranks)}


def waited(future, what: str, timeout: float):
    """``future``'s result, printing the seconds this process waited for
    it (the run's budget: a background part the main path waits on)."""
    t = time.perf_counter()
    out = future.result(timeout=timeout)
    print(f"phase wait {what}: {time.perf_counter() - t:.1f}s", flush=True)
    return out


def timed_phase(fn, *args, name: str = None):
    """``fn(*args)``, printing the seconds it took (the run's budget by
    phase) under ``name`` (default ``fn``'s)."""
    t = time.perf_counter()
    out = fn(*args)
    print(f"phase {name or fn.__name__}: {time.perf_counter() - t:.1f}s",
          flush=True)
    return out


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

    # the dry run's records: meta work on the host, beside the card's
    # phases, in a process of its own (spawned: no CUDA state to fork)
    dry_pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(dry_pool.terminate)
    dry_pending = dry_pool.apply_async(dry_records)
    topk, qsgd = timed_phase(phase_kernels, dev)
    # the tuning table of every tuned run of the script
    table_dir = tempfile.mkdtemp(dir=os.path.join(SRC, "repro_torch",
                                                  "kernels", "build"))
    atexit.register(shutil.rmtree, table_dir, True)
    timed_phase(phase_autotune, dev, table_dir)
    serve_checks = timed_phase(phase_serve_kernels, dev)
    flash_checks, gemma_decode, gemma_gemm = timed_phase(
        phase_flash_kernels, dev)
    runs, totals, fault_free = timed_phase(phase_train, dev)
    timed_phase(phase_small_agreement, dev)
    wrapper_totals = timed_phase(phase_wrappers, dev)
    convex_totals, convex_checks = timed_phase(phase_convex, dev)
    scenario_totals = timed_phase(phase_scenarios_convex, dev)
    fault_totals = timed_phase(phase_faults, dev, fault_free)
    for more in (wrapper_totals, convex_totals, fault_totals,
                 scenario_totals):
        for k, v in more.items():
            totals[k] = totals.get(k, 0) + v
    serve_totals = timed_phase(phase_serve, dev)
    timed_phase(phase_serve_agreement, dev)
    tmp = tempfile.mkdtemp(dir=os.path.join(SRC, "repro_torch", "kernels",
                                            "build"))
    try:
        flash_totals, saved = timed_phase(phase_serve_flash, dev, tmp)
        for arch in ("gemma3-1b", "yi-6b"):
            timed_phase(phase_serve_agreement, dev, arch, True)
        compact, lm_topk = timed_phase(phase_lm_kernels, dev)
        dense_ckpt = os.path.join(tmp, "dense")
        lm_totals = timed_phase(phase_lm, dev, dense_ckpt)
        for more in (timed_phase(phase_lm_scenario, dev),
                     timed_phase(phase_lm_faults, dev),
                     timed_phase(phase_lm_bidir, dev)):
            for k, v in more.items():
                lm_totals[k] = lm_totals.get(k, 0) + v
        ckpt_totals = timed_phase(phase_checkpoint_serve, dev, saved,
                                  dense_ckpt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for more in (flash_totals, ckpt_totals):
        for k, v in more.items():
            serve_totals[k] = serve_totals.get(k, 0) + v
    # the model-parallel ranks (gloo through host memory) run beside the
    # smoke model's multi-rank phases, which time nothing on the card;
    # the 1x1 twins before them, alone, and the phases' kernel checks
    # after them.  The tensor-parallel ranks (beside the fault phase the
    # card ran out of memory) and then the expert-parallel ones (2 x ~17
    # GB) in one worker thread, the card not holding both at once; the
    # RWKV-6 / Zamba2 ranks (2 x ~8 GB) in a thread of their own, started
    # when the tensor-parallel ranks are done and let run when the smoke
    # model's rank phases are too (beside both the card ran out of
    # memory)
    jobs_tmp = tempfile.mkdtemp(dir=os.path.join(SRC, "repro_torch",
                                                 "kernels", "build"))
    atexit.register(shutil.rmtree, jobs_tmp, True)
    grads = {name: os.path.join(jobs_tmp, name + "_{arch}.pt")
             for name in RANK_JOBS}
    twins = {name: timed_phase(rank_twins, dev, name, grads[name],
                               name=f"{name}_twins")
             for name in RANK_JOBS}
    tp_pool, ssm_pool = ThreadPoolExecutor(1), ThreadPoolExecutor(1)
    pending = {name: tp_pool.submit(rank_runs, name, grads[name])
               for name in ("tp", "ep")}
    smoke_done = os.path.join(jobs_tmp, "smoke_done")
    pending["tp_ssm"] = ssm_pool.submit(
        lambda: (pending["tp"].exception(),
                 rank_runs("tp_ssm", grads["tp_ssm"], smoke_done))[1])
    ranks_pool = ThreadPoolExecutor(1)
    ranks_pending = ranks_pool.submit(rank_collectives)
    try:
        timed_phase(phase_lm_ranks, dev)
        timed_phase(phase_lm_ranks_mesh, dev)
    finally:
        open(smoke_done, "w").close()
    ranks = ranks_pending.result(timeout=600)
    ranks_pool.shutdown()
    dry = dry_pending.get(timeout=600)
    for name in RANK_JOBS:
        job_compact, job_dense, job_totals = timed_phase(
            phase_ranks, dev, name, dry["jobs"][name], twins[name],
            waited(pending[name], f"{name}_ranks", 900),
            name=f"phase_{name}")
        compact, lm_topk = compact + job_compact, lm_topk + job_dense
        for k, v in job_totals.items():
            lm_totals[k] = lm_totals.get(k, 0) + v
    tp_pool.shutdown()
    ssm_pool.shutdown()
    shutil.rmtree(jobs_tmp, ignore_errors=True)
    family_fa, family_fd = timed_phase(phase_family_kernels, dev)
    for more, into in ((timed_phase(phase_family_serve, dev), serve_totals),
                       (timed_phase(phase_family_train, dev), lm_totals)):
        for k, v in more.items():
            into[k] = into.get(k, 0) + v
    timed_phase(phase_dryrun, dev, dry, ranks)
    dry_pool.close()
    dry_pool.join()

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
                               "library_ms", "launches", "model") if k in r}}
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
    kernels[-1]["rows"] = [
        {"cache": r["cache"], "model": r.get("model", "gemma3-1b decode"),
         **{k: r[k] for k in timed}} for r in gemma_decode + family_fd]
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
                 for r in flash_checks[1:] + family_fa]})
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
                              "bound_ms", "bound_by", "library_ms",
                              "launches") if k in r}}
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
