#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. the card's name and power limit; TF32 off for matmuls and cuDNN (the
   CPU tests run in full float32);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with device times (torch.profiler):
   the kernel, the plain version, one PyTorch library call for the same
   function where there is one (a yardstick only, never called by the
   port), and the bound (the larger of the bytes it must move over
   3.35 TB/s and its float32 operations over 67 TFLOP/s, the H100 SXM's
   published peaks);
4. the training path: ``train`` on ResNet-50 at full width (25,541,672
   parameters), R=8 workers, per-worker batch 8, 224x224 images, T=8,
   H=4, under RowSignTopK, TopK and QSGD, with the launch counts per
   sync; then a small ResNet on the card with dispatch "kernel" against
   dispatch "reference" (same losses, same wire bits);
5. the serving path: the four serving kernels against their plain
   versions at Yi-6B's shapes (step 3's checks and times), then Yi-6B at
   full width and depth (random weights from a seed) compressed at load
   under its ``lm_hetero`` policy and served by ``ServeEngine`` three
   times -- paged with a bf16 pool, paged with int8 pages, contiguous --
   all through the decode-attention kernels, 16 requests of 64-128
   prompt tokens and 64 new tokens each, with the launch counts per
   step and the serving metrics; then the yi-6b smoke model in float32
   served with dispatch "kernel" against "reference" (same tokens).

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
#: the serving run: Yi-6B served from compressed weights
SERVE = {"max_batch": 8, "max_len": 512, "prompt_pad": 128, "page_size": 16,
         "requests": 16, "prompt_min": 64, "new_tokens": 64, "seed": 0}
#: launches per decode step / per prefill on Yi-6B under lm_hetero: 7
#: Top_k matmuls in each of 32 layers, the QSGD head once, one decode
#: attention per layer
YI_LAYERS = 32
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
    """Mean device time of ``fn`` per call: the kernels (and copies) its
    ``reps`` calls ran on the card, summed from a torch.profiler (CUPTI)
    trace after a warm-up call.  CUDA events around back-to-back calls
    would also count the gaps that the host's launch overhead leaves
    between kernels of a few microseconds."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == cuda)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / reps


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


def check_qdq_gemm(dev, M: int, reps: int):
    """qdq_gemm on the Yi-6B head (64000 x 4096 int8 levels) against its
    plain version (dequantize, float32 matmul): within 1e-5 of the
    largest output.  Library call: torch.matmul against the dequantized
    float32 weight."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_gemm import qdq_gemm
    R, n = 64000, 4096
    g = torch.Generator(device=dev).manual_seed(M)
    lv = torch.randint(-15, 16, (R, n), generator=g, device=dev,
                       dtype=torch.int8)
    scale = torch.rand((R, 1), generator=g, device=dev) * 0.01
    x = torch.randn((M, n), generator=g, device=dev).to(torch.bfloat16)
    err = close_to_scale(qdq_gemm(x, lv, scale),
                         ref.qdq_gemm_ref(x, lv, scale), 1e-5, 1e-5,
                         f"qdq_gemm M={M}")
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
    within one bf16 rounding (2^-7) of the largest output; the free
    slot's row exactly zero."""
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
    err = close_to_scale(out, ref.paged_decode_ref(*args), 2 ** -7, 2 ** -7,
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
            "quant": quant, "tokens": tokens, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "scaled_dot_product_attention over gathered KV",
            "bound_ms": bms, "bound_by": by}


def check_flash_decode(dev, reps: int):
    """flash_decode at Yi-6B's decode shapes (batch 8, a 512-slot ring
    cache, 4 kv heads, a validity mask per row) against its plain version:
    within one bf16 rounding of the largest output."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_decode
    B, H, KV, hd, C = 8, 32, 4, 128, 512
    g = torch.Generator(device=dev).manual_seed(20)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, C, KV, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, C, KV, hd), generator=g, device=dev).to(torch.bfloat16)
    lengths = decode_lengths(g, B, dev)
    lengths[0] = C                   # every row needs a valid slot
    valid = torch.arange(C, device=dev)[None, :] < lengths[:, None]
    err = close_to_scale(flash_decode(q, k, v, valid),
                         ref.flash_decode_ref(q, k, v, valid), 2 ** -7,
                         2 ** -7, "flash_decode")
    ms = time_ms(lambda: flash_decode(q, k, v, valid), reps)
    plain_ms = time_ms(lambda: ref.flash_decode_ref(q, k, v, valid), reps)
    library_ms = sdpa_ms(q, k, v, valid, reps)
    tokens = int(valid.sum())
    nbytes = 2.0 * tokens * KV * hd * 2 + B * C + 2 * 2.0 * B * H * hd
    bms, by = bound_ms(nbytes, 4.0 * H * hd * tokens)
    return {"shape": [B, H, KV, hd], "cache": C, "tokens": tokens,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "library": "scaled_dot_product_attention over the same KV",
            "bound_ms": bms, "bound_by": by}


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
        "qdq_gemm": [check_qdq_gemm(dev, 8, 10), check_qdq_gemm(dev, 1, 10)],
        "paged_decode": [check_paged_decode(dev, False, 20),
                         check_paged_decode(dev, True, 20)],
        "flash_decode": [check_flash_decode(dev, 20)],
    }
    for name, checks in rows.items():
        for row in checks:
            print("kernel check", name, json.dumps(row), flush=True)
    return rows


def serve_requests(eng, vocab: int) -> None:
    import numpy as np
    rng = np.random.RandomState(SERVE["seed"])
    for _ in range(SERVE["requests"]):
        plen = int(rng.randint(SERVE["prompt_min"], SERVE["prompt_pad"] + 1))
        eng.submit(rng.randint(0, vocab, plen).tolist(),
                   max_new_tokens=SERVE["new_tokens"])


def serve_run(params, cfg, name: str, layout: dict, dev):
    """One ServeEngine run over the compressed weights: every step timed
    on the host clock (a step ends in a device-to-host copy of the next
    tokens, so it is synchronous); steps that admitted a request also ran
    its prefill."""
    import numpy as np
    import torch
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.kernels.launch_stats import LAUNCHES, reset_launches
    from repro_torch.serve import compressed as sc
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(params, cfg, max_batch=SERVE["max_batch"],
                      max_len=SERVE["max_len"],
                      prompt_pad=SERVE["prompt_pad"],
                      dispatch=DispatchConfig(mode=DISPATCH), **layout)
    serve_requests(eng, cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.reset_stats()
    reset_launches()
    decode_ms, admit_ms = [], []
    t0 = time.perf_counter()
    while eng.pending:
        before = eng.admissions
        t = time.perf_counter()
        eng.step()
        (admit_ms if eng.admissions > before else decode_ms).append(
            (time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    res = eng.run()                  # nothing pending: collects the results
    outs, mets = res["outputs"], list(res["metrics"].values())
    attn = "paged_decode" if layout.get("paged") else "flash_decode"
    calls = eng.steps + eng.admissions
    want = {"sparse_gemm": 7 * YI_LAYERS * calls, "qdq_gemm": calls,
            attn: YI_LAYERS * eng.steps}
    for k, v in launches.items():
        if v != want.get(k, 0):
            raise AssertionError(f"{name}: {v} {k} launches, want "
                                 f"{want.get(k, 0)} ({eng.steps} decode "
                                 f"steps, {eng.admissions} prefills)")
    if sc.STATS["densify"]:
        raise AssertionError(f"{name}: densified {sc.STATS['densify']}")
    if sorted(outs) != list(range(SERVE["requests"])) or any(
            len(t) != SERVE["new_tokens"] or min(t) < 0 or max(t) >= cfg.vocab
            for t in outs.values()):
        raise AssertionError(f"{name}: bad outputs")
    ttft = [m.ttft_s * 1e3 for m in mets]
    row = {"run": name, "steps": eng.steps, "prefills": eng.admissions,
           "decode_ms_per_step": float(np.median(decode_ms)),
           "decode_ms_mean": float(np.mean(decode_ms)),
           "admit_step_ms_mean": float(np.mean(admit_ms)),
           "ttft_ms_min": min(ttft), "ttft_ms_p50": float(np.median(ttft)),
           "ttft_ms_max": max(ttft),
           "tokens_per_s": sum(len(t) for t in outs.values()) / wall,
           "wall_s": wall, "peak_device_bytes": torch.cuda.max_memory_allocated(),
           # per decode step or prefill (GEMMs), per decode step (attention)
           "launches_per_call": {k: v / (calls if k != attn else eng.steps)
                                 for k, v in launches.items() if v},
           "launches": {k: v for k, v in launches.items() if v}}
    if layout.get("paged"):
        pool = res["pool"]
        row.update(peak_pool_pages=pool["peak_pages_used"],
                   n_pages=pool["n_pages"], preemptions=pool["preemptions"],
                   admission_stalls=pool["admission_stalls"])
    print("serve", json.dumps(row), flush=True)
    return launches


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
        for k, v in serve_run(params, cfg, name, layout, dev).items():
            totals[k] = totals.get(k, 0) + v
    del params
    torch.cuda.empty_cache()
    return totals


def phase_serve_agreement(dev):
    """The yi-6b smoke model in float32 on the card, compressed under
    lm_hetero, with dispatch "kernel" (the CUDA kernels) against
    "reference" (their plain versions): prefill and decode logits within
    rtol 1e-4 / atol 1e-4 (float32 sums in another order), the same
    greedy tokens from paged, paged-int8 and contiguous engines."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_policy_preset
    from repro_torch.kernels.dispatch import DispatchConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serve import compressed as sc
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              use_pallas=True)
    params = sc.compress_tree(
        tf.init_params(torch.Generator(device=dev).manual_seed(1), cfg,
                       device=dev), get_policy_preset("arch", "yi-6b"))
    modes = {m: DispatchConfig(mode=m) for m in ("kernel", "reference")}
    toks = torch.randint(0, cfg.vocab, (3, 21), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    logits = {}
    for m, dcfg in modes.items():
        lg, cache, _ = tf.prefill(params, {"tokens": toks}, cfg, dcfg,
                                  max_len=32)
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
    for layout in ({"paged": True, "page_size": 4},
                   {"paged": True, "page_size": 4, "kv_quant": True}, {}):
        outs = {}
        for m, dcfg in modes.items():
            eng = ServeEngine(params, cfg, max_batch=3, max_len=24,
                              prompt_pad=6, dispatch=dcfg, **layout)
            for p, n in reqs:
                eng.submit(p, n)
            outs[m] = eng.run()["outputs"]
        if outs["kernel"] != outs["reference"]:
            raise AssertionError(f"serve agreement {layout}: tokens differ")
    print(f"serve agreement: logits within {err:.3g}, tokens equal on "
          f"paged / paged-int8 / contiguous", flush=True)



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
    runs, totals = phase_train(dev)
    phase_small_agreement(dev)
    serve_totals = phase_serve(dev)
    phase_serve_agreement(dev)

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
