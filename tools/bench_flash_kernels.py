#!/usr/bin/env python3
"""Time the port's two attention kernels at the main paths' shapes, on
one GPU, for the checkout this file sits in or for another one.

    python3 tools/bench_flash_kernels.py [--tree DIR] [--serve]

Imports ``chip_smoke.py`` and ``src/`` from DIR (default: this
checkout), builds that tree's kernels into its own build directory, and
runs its ``check_flash_attention`` at gemma3-1b's prefill shapes (2048
tokens under the 1024 window and global, a ragged 1100) and Yi-6B's
heads, and its ``check_flash_decode`` at Yi-6B's decode shape and
gemma3-1b's two rings: each kernel against its plain version, with the
kernel's, the plain version's and SDPA's device times and the bound.
Prints the card's name and power limit, then one JSON line per row
tagged with DIR.  With ``--serve`` it runs that tree's unscanned
gemma3-1b serve phase instead (``chip_smoke.phase_serve_flash``: full
width and depth, 8 requests, batch 4), whose ``serve`` line has the
decode ms/step, TTFT and tok/s.  To compare two commits, unpack the
parent (``git archive``) into a git-ignored directory and run parent,
change, change, parent in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--serve", action="store_true")
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
        print("bench serve", tree, flush=True)
        cs.phase_serve_flash(dev)
        return 0
    rows = [("flash_attention", cs.check_flash_attention(dev, *shape, 10))
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
        for extra in ("window", "cache", "route", "split_tiles",
                      "max_row_rel_err", "bound_f32_ms"):
            if extra in row:
                keep[extra] = row[extra]
        print("bench", json.dumps({"tree": tree, "kernel": name, **keep}),
              flush=True)
    print(cs.TIMING, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
