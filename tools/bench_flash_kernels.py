#!/usr/bin/env python3
"""Time the port's redesigned kernels at the main paths' shapes, on one
GPU, for the checkout this file sits in or for another one.

    python3 tools/bench_flash_kernels.py [--tree DIR]
        [--kernels attention|topk_paged|gemm|compress]
        [--serve [gemma3-1b|yi-6b] [--plain-gemm] [--shapes]] [--lm]
        [--compress-at-load]

Imports ``chip_smoke.py`` and ``src/`` from DIR (default: this
checkout), builds that tree's kernels into its own build directory, and
runs that tree's checks, each kernel against its plain version with the
kernel's, the plain version's and the library call's device times and
the bound.  ``--kernels attention`` (the default): ``check_flash_attention``
at gemma3-1b's prefill shapes (2048 tokens under the 1024 window and
global, a ragged 1100) and Yi-6B's heads, and ``check_flash_decode`` at
Yi-6B's decode shape and gemma3-1b's two rings.  ``--kernels
topk_paged``: ``check_topk`` at the ResNet-50 shapes (RowSignTopK's
[49312, 4096], the global TopK's [16, 524288], [8, 524288], [56, 65536]
and [8, 65536]) and gemma3-1b's dense-wire rows ([179712, 1152] with and
without sign, wq / wo's [26624, 1152], wk / wv's [6656, 1152]), and
``check_paged_decode`` at Yi-6B's decode shape over bf16 and int8 pages,
with ``torch.topk`` and SDPA as the library calls.  ``--kernels gemm``:
``check_sparse_gemm`` at gemma3-1b's w1 / w2 at a 2048-token prefill,
Yi-6B's w1 at a 128-token prefill, and every Top_k matrix of a decode
step (``DECODE_STEP``: Yi-6B at batch 8, gemma3-1b at batch 4), with a
``step`` line per model summing launches a step times ms, and
``check_qdq_gemm`` on Yi-6B's head (M = 1, 8) and gemma3-1b's tied head
(M = 4, 1), with ``torch.matmul`` against the dense weight as the
library call; these checks are this checkout's, run against DIR's
kernels (an older tree's checks took other arguments).  Where DIR's
wrapper has ``sparse_gemm_route``, each ``sparse_gemm`` kernel is also
timed at M = 1 .. 256 on the w1 / w2 shapes (``route`` lines: the
crossover; the decode kernel up to M = 8 where DIR has it).  ``--kernels
compress``: DIR's ``check_compact`` at gemma3-1b's sparse-wire rows
([179712, 1152] and [26624, 1152] with and without sign, [6656, 1152])
and on the heavy-tie block, both signs; ``check_qsgd`` at ResNet-50's
four bucket shapes ([16, 524288], [56, 65536], [1, 524288], [7,
65536]); ``check_topk`` at [179712, 1152] and [49312, 4096], with and
without sign (the short-row prologue it shares with ``topk_compact``);
``check_topk`` and ``check_qsgd`` at the convex rows (15 workers' leaves
of 7,840 and 10 floats padded to [15, 7936] and [15, 128], k = 40 and
1, s = 15), with ``torch.topk`` as Top_k's library call;
where DIR has ``qsgd_geometry``, every cluster size's time at each
QSGD shape beside the blocks the card holds at once (``geometry``
lines).  Prints the card's name and power limit, then one JSON line per
row tagged with DIR.  ``--lm`` runs the tree's LM phase instead
(gemma3-1b through the launcher on both wires; its ``lm`` lines have the
wire bits).  ``--compress-at-load`` times DIR's
``serve.compressed.compress_tree`` instead, on the random bf16 inits the
serving phases compress at load (gemma3-1b unscanned, Yi-6B stacked,
each under its arch preset), three calls each on the host clock with
the card synchronized around each call (``compress`` lines); no kernel
is built or called.

``--serve`` runs that tree's serve phase instead: ``gemma3-1b`` (the
default) the unscanned gemma3-1b run (``chip_smoke.phase_serve_flash``),
``yi-6b`` the Yi-6B runs over paged bf16, paged int8 and contiguous KV
(``chip_smoke.phase_serve``); their ``serve`` lines have the decode
ms/step, TTFT and tok/s, and a ``tokens`` line per run gives a digest of
every request's greedy tokens (``--tokens-out FILE`` keeps them, a JSON
line a run; ``--shapes`` prints each ``sparse_gemm`` shape the run called,
with its call count); ``--plain-gemm`` runs the two GEMM
wrappers through their plain versions on the card (launches still
counted), for the tokens of the plain path.  To compare two commits,
unpack the parent (``git archive``) into a git-ignored directory and run
parent, change, change, parent in one call on one card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record_tokens(path=None) -> None:
    """Print a digest of each ServeEngine run's greedy tokens (request
    id, tokens), so that two trees' runs can be compared token for
    token; with ``path``, append each run's tokens there as a JSON
    line."""
    import hashlib
    from repro_torch.serve.engine import ServeEngine
    run = ServeEngine.run

    def wrapped(self, *args, **kwargs):
        res = run(self, *args, **kwargs)
        outs = sorted((rid, list(map(int, toks)))
                      for rid, toks in res["outputs"].items())
        digest = hashlib.sha256(json.dumps(outs).encode()).hexdigest()
        print("tokens", json.dumps({"requests": len(outs),
                                    "sha256": digest[:16]}), flush=True)
        if path:
            with open(path, "a") as f:
                f.write(json.dumps(outs) + "\n")
        return res

    ServeEngine.run = wrapped


def plain_gemms() -> None:
    """Route ``sparse_gemm`` / ``qdq_gemm`` through their plain versions
    (dispatch looks the wrappers up at each call), counting launches as
    the kernels do."""
    from repro_torch.kernels import ref, sparse_gemm as sg
    from repro_torch.kernels.launch_stats import LAUNCHES

    def sparse(x, idx, val, row_len):
        LAUNCHES["sparse_gemm"] += 1
        return ref.sparse_gemm_ref(x, idx, val, row_len)

    def qdq(x, levels, scale):
        LAUNCHES["qdq_gemm"] += 1
        return ref.qdq_gemm_ref(x, levels, scale)

    sg.sparse_gemm, sg.qdq_gemm = sparse, qdq


#: (M, R, n, k, launches a decode step): every Top_k matrix of a decode
#: step at the shapes ServeEngine gives it (``--serve ... --shapes`` logs
#: them): Yi-6B's 32 layers at batch 8 (w1 / w3, w2, wq / wo, wk / wv),
#: gemma3-1b's 26 at batch 4 (w1 / w3, w2, wq, wo, wk / wv)
DECODE_STEP = {
    "yi-6b": ((8, 11008, 4096, 41, 64), (8, 4096, 11008, 110, 32),
              (8, 4096, 4096, 41, 64), (8, 512, 4096, 41, 64)),
    "gemma3-1b": ((4, 6912, 1152, 12, 52), (4, 1152, 6912, 69, 26),
                  (4, 1024, 1152, 12, 26), (4, 1152, 1024, 10, 26),
                  (4, 256, 1152, 12, 52)),
}


def gemm_rows(dev) -> list:
    """The GEMM rows, timed by this checkout's checks, and each decode
    step's sparse_gemm device time summed over its matrices."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_gemm_checks", os.path.join(HERE, "chip_smoke.py"))
    ck = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ck)
    rows = [("sparse_gemm", ck.check_sparse_gemm(dev, *shape))
            for shape in ((2048, 6912, 1152, 12, 5),
                          (2048, 1152, 6912, 69, 5),
                          (128, 11008, 4096, 41, 5))]
    for model, shapes in DECODE_STEP.items():
        step = {"model": model, "ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "launches": 0}
        for M, R, n, k, per_step in shapes:
            row = ck.check_sparse_gemm(dev, M, R, n, k, 20)
            rows.append(("sparse_gemm", row))
            for key in ("ms", "bound_ms", "library_ms"):
                step[key] += per_step * row[key]
            step["launches"] += per_step
        print("step", json.dumps(step), flush=True)
    rows += [("qdq_gemm", ck.check_qdq_gemm(dev, *shape))
             for shape in ((1, 64000, 4096, 10), (8, 64000, 4096, 10),
                           (4, 262144, 1152, 10), (1, 262144, 1152, 10))]
    from repro_torch.kernels import sparse_gemm as sg
    if hasattr(sg, "sparse_gemm_route"):
        import torch
        for R, n, k in ((6912, 1152, 12), (1152, 6912, 69),
                        (11008, 4096, 41), (4096, 11008, 110)):
            g = torch.Generator(device=dev).manual_seed(R + n)
            idx, val = ck.compact_buffers(g, R, n, k, 128, dev)
            for M in (1, 2, 4, 8, 16, 32, 40, 48, 56, 64, 96, 128, 256):
                x = torch.randn((M, n), generator=g, device=dev).to(
                    torch.bfloat16)
                routes = [r for r in ("rows", "tiled", "decode", "auto")
                          if r in sg.ROUTES and (r != "decode" or M <= 8)]
                ms = {route: ck.time_ms(
                    lambda route=route: sg.sparse_gemm_route(
                        x, idx, val, n, route), 20)
                    for route in routes}
                print("route", json.dumps({"shape": [M, n, R], "k_row": k,
                                           **ms}), flush=True)
    print("gemm", ck.TIMING, flush=True)
    return rows


def qsgd_geometry_rows(ck, dev) -> None:
    """Each cluster size's time at ResNet-50's QSGD shapes, beside the
    blocks the card holds at once and the size the wrapper picks."""
    import torch
    from repro_torch.kernels import qsgd as qs
    from repro_torch.kernels.topk_compress import _chunk
    slots = qs.resident_blocks(torch.cuda.current_device())
    for rows, n in ((16, 524288), (56, 65536), (1, 524288), (7, 65536)):
        g = torch.Generator(device=dev).manual_seed(rows + n)
        x = torch.randn((rows, n), generator=g, device=dev)
        u = torch.rand((rows, n), generator=g, device=dev)
        picked = qs.qsgd_geometry(rows, n, slots)
        for c in qs.QSGD_CLUSTERS:
            geo = qs.QsgdGeometry(c, max(4, _chunk(n, c)))
            if c > 1 and (c - 1) * geo.chunk >= n:
                continue
            ms = ck.time_ms(lambda geo=geo: qs._launch(x, u, 15, geo), 20)
            print("geometry", json.dumps({
                "shape": [rows, n], "cs": c, "chunk": geo.chunk,
                "resident_blocks": slots, "picked": geo == picked,
                "ms": ms}), flush=True)


def record_shapes() -> dict:
    """Count ``sparse_gemm`` calls by shape (M, row length, output rows,
    kcap, the most live slots of a row, x dtype) for the serve run; the
    caller prints the tally."""
    from repro_torch.kernels import sparse_gemm as sg
    tally, live = {}, {}
    call = sg.sparse_gemm

    def counted(x, idx, val, row_len):
        key = (x.shape[0], row_len, idx.shape[0], idx.shape[1],
               str(x.dtype).removeprefix("torch."))
        if key not in live:
            live[key] = int((idx < row_len).sum(dim=1).max())
        tally[key] = tally.get(key, 0) + 1
        return call(x, idx, val, row_len)

    sg.sparse_gemm = counted
    return {"tally": tally, "live": live}


def compress_rows(dev) -> None:
    """Seconds of ``compress_tree`` per call on the serving phases'
    random inits, three calls a model; one ``compress`` line each."""
    import dataclasses
    import time
    import torch
    from repro_torch.configs import get_config, get_policy_preset
    from repro_torch.models import transformer as tf
    from repro_torch.serve import compressed as sc
    for arch, scan in (("gemma3-1b", False), ("yi-6b", True)):
        cfg = dataclasses.replace(get_config(arch), scan_layers=scan)
        params = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
        policy = get_policy_preset("arch", arch)
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            comp = sc.compress_tree(params, policy)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            sizes = sc.tree_bytes(comp)
            del comp
        print("compress", json.dumps({
            "arch": arch, "layers": "scanned" if scan else "unscanned",
            "compress_s": secs, "resident_bytes": sizes["compressed"],
            "peak_device_bytes": torch.cuda.max_memory_allocated()}),
            flush=True)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--kernels", choices=("attention", "topk_paged", "gemm",
                                          "compress"),
                    default="attention")
    ap.add_argument("--serve", nargs="?", const="gemma3-1b",
                    choices=("gemma3-1b", "yi-6b"))
    ap.add_argument("--plain-gemm", action="store_true")
    ap.add_argument("--shapes", action="store_true",
                    help="with --serve: log sparse_gemm's calls by shape")
    ap.add_argument("--lm", action="store_true",
                    help="run the tree's gemma3-1b LM phase (both wires) "
                    "and print its ledgers")
    ap.add_argument("--tokens-out", help="append each serve run's tokens "
                    "to this file (one JSON line a run)")
    ap.add_argument("--compress-at-load", action="store_true",
                    help="time the tree's compress_tree on the serving "
                    "phases' random inits")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not cs.__file__.startswith(tree) or not _build.__file__.startswith(
            tree):
        raise AssertionError(f"imported {cs.__file__}, {_build.__file__}, "
                             f"not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    dev = torch.device("cuda")
    if args.compress_at_load:
        print("bench compress", tree, flush=True)
        compress_rows(dev)
        return 0
    _build.build()
    if args.serve:
        print("bench serve", tree, args.serve,
              "plain GEMMs" if args.plain_gemm else "kernels", flush=True)
        record_tokens(args.tokens_out)
        if args.plain_gemm:
            plain_gemms()
        log = record_shapes() if args.shapes else None
        if args.serve == "yi-6b":
            cs.phase_serve(dev)
        elif "tmp" in inspect.signature(cs.phase_serve_flash).parameters:
            # a tree whose serve phase also saves its tree as compact-v1
            with tempfile.TemporaryDirectory(dir=os.path.join(
                    tree, "src", "repro_torch", "kernels", "build")) as tmp:
                cs.phase_serve_flash(dev, tmp)
        else:
            cs.phase_serve_flash(dev)
        if log:
            for key, calls in sorted(log["tally"].items()):
                M, n, R, kcap, dtype = key
                print("shape", json.dumps({
                    "M": M, "n": n, "R": R, "kcap": kcap, "dtype": dtype,
                    "live_max": log["live"][key], "calls": calls}),
                    flush=True)
        return 0
    if args.lm:
        print("bench lm", tree, flush=True)
        cs.phase_lm(dev)
        return 0
    if args.kernels == "gemm":
        rows = gemm_rows(dev)
    elif args.kernels == "compress":
        rows = [("topk_compact", cs.check_compact(dev, *shape))
                for shape in ((179712, 1152, 12, 128, False, 10),
                              (179712, 1152, 12, 128, True, 10),
                              (26624, 1152, 12, 128, False, 10),
                              (26624, 1152, 12, 128, True, 10),
                              (6656, 1152, 12, 128, False, 10),
                              (4096, 1152, 12, 128, False, 10, True),
                              (4096, 1152, 12, 128, True, 10, True))]
        rows += [("qsgd_quantize", cs.check_qsgd(dev, *shape, 15, 10))
                 for shape in ((16, 524288), (56, 65536), (1, 524288),
                               (7, 65536))]
        rows += [("topk_compress", cs.check_topk(dev, *shape, 10))
                 for shape in ((179712, 1152, 12, False),
                               (179712, 1152, 12, True),
                               (49312, 4096, 41, False),
                               (49312, 4096, 41, True))]
        # the convex rows: 15 workers' leaves of 7,840 and 10 floats,
        # zero-padded to 7936 and 128 columns (k = 40 and 1, s = 15)
        for n, live, k in ((7936, 7840, 40), (128, 10, 1)):
            rows += [("topk_compress", cs.check_topk(dev, 15, n, k, False,
                                                     20, live=live)),
                     ("qsgd_quantize", cs.check_qsgd(dev, 15, n, 15, 20,
                                                     live=live))]
        from repro_torch.kernels import qsgd as qs
        if hasattr(qs, "qsgd_geometry"):
            qsgd_geometry_rows(cs, dev)
    elif args.kernels == "topk_paged":
        from repro_torch.kernels import topk_compress as tk
        if hasattr(tk, "cluster_capacity"):
            idx = torch.cuda.current_device()
            # clusters of cs blocks owning a chunk each, held at once
            print("bench cluster_capacity", json.dumps({
                f"{cs}x{chunk}": tk.cluster_capacity(idx, cs, chunk)
                for cs, chunk in ((16, 32768), (8, 65536), (8, 8192),
                                  (16, 4096))}), flush=True)
        rows = [("topk_compress", cs.check_topk(dev, *shape, reps))
                for *shape, reps in ((49312, 4096, 41, False, 10),
                                     (49312, 4096, 41, True, 10),
                                     (16, 524288, 5243, False, 5),
                                     (8, 524288, 5243, False, 5),
                                     (56, 65536, 655, False, 10),
                                     (8, 65536, 655, False, 10),
                                     (179712, 1152, 12, False, 10),
                                     (179712, 1152, 12, True, 10),
                                     (26624, 1152, 12, False, 10),
                                     (6656, 1152, 12, False, 10))]
        rows += [("paged_decode", cs.check_paged_decode(dev, quant, 20))
                 for quant in (False, True)]
    else:
        rows = [("flash_attention", cs.check_flash_attention(dev, *shape,
                                                             10))
                for shape in ((1, 2048, 4, 1, 256, 1024),
                              (1, 2048, 4, 1, 256, -1),
                              (1, 1100, 4, 1, 256, 1024),
                              (1, 2048, 32, 4, 128, -1))]
        rows.append(("flash_decode", cs.check_flash_decode(dev, 20)))
        for C, lengths in ((1024, (1024, 1025)), (2304, (1100, 2081))):
            rows.append(("flash_decode", cs.check_flash_decode(
                dev, 20, B=4, H=4, KV=1, hd=256, C=C, lengths=lengths)))
    for name, row in rows:
        keep = {k: row[k] for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")}
        for extra in ("window", "cache", "route", "split_tiles", "k", "sign",
                      "quant", "max_row_rel_err", "bound_f32_ms", "k_row",
                      "kcap", "ties", "geometry", "mismatched_levels",
                      "live"):
            if extra in row:
                keep[extra] = row[extra]
        print("bench", json.dumps({"tree": tree, "kernel": name, **keep}),
              flush=True)
    print(cs.TIMING, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
