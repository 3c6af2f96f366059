#!/usr/bin/env python3
"""Time the port's redesigned kernels at the main paths' shapes, on one
GPU, for the checkout this file sits in or for another one.

    python3 tools/bench_flash_kernels.py [--tree DIR]
        [--kernels attention|topk_paged] [--serve [gemma3-1b|yi-6b]]

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
and [8, 65536]) and gemma3-1b's [179712, 1152], and
``check_paged_decode`` at Yi-6B's decode shape over bf16 and int8 pages,
with ``torch.topk`` and SDPA as the library calls.  Prints the card's
name and power limit, then one JSON line per row tagged with DIR.

``--serve`` runs that tree's serve phase instead: ``gemma3-1b`` (the
default) the unscanned gemma3-1b run (``chip_smoke.phase_serve_flash``),
``yi-6b`` the Yi-6B runs over paged bf16, paged int8 and contiguous KV
(``chip_smoke.phase_serve``); their ``serve`` lines have the decode
ms/step, TTFT and tok/s, and a ``tokens`` line per run gives a digest of
every request's greedy tokens.  To compare two commits, unpack the
parent (``git archive``) into a git-ignored directory and run parent,
change, change, parent in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def record_tokens() -> None:
    """Print a digest of each ServeEngine run's greedy tokens (request
    id, tokens), so that two trees' runs can be compared token for
    token."""
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
        return res

    ServeEngine.run = wrapped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--kernels", choices=("attention", "topk_paged"),
                    default="attention")
    ap.add_argument("--serve", nargs="?", const="gemma3-1b",
                    choices=("gemma3-1b", "yi-6b"))
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
    _build.build()
    dev = torch.device("cuda")
    if args.serve:
        print("bench serve", tree, args.serve, flush=True)
        record_tokens()
        if args.serve == "yi-6b":
            cs.phase_serve(dev)
        else:
            cs.phase_serve_flash(dev)
        return 0
    if args.kernels == "topk_paged":
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
                                     (179712, 1152, 12, False, 10))]
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
                      "quant", "max_row_rel_err", "bound_f32_ms"):
            if extra in row:
                keep[extra] = row[extra]
        print("bench", json.dumps({"tree": tree, "kernel": name, **keep}),
              flush=True)
    print(cs.TIMING, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
