#!/usr/bin/env python3
"""PyTorch's CPU heap fault under the non-bottleneck ResNet, without the port.

    python3 tools/check_cpu_groupnorm.py [--runs 4] [--iters 300]

Runs the small non-bottleneck ResNet's forward and gradient (a stem conv,
a block of 8 channels, a strided block of 16 with a projection; HWIO
weights permuted to OIHW and NHWC images permuted to NCHW, as
``repro_torch.models.resnet`` has them, so every convolution's output
and every ``F.group_norm`` input is channels-last) in plain PyTorch,
``--iters`` batches of 2 images of 16x16 a process, ``--runs`` fresh
processes a setting, under ``MALLOC_CHECK_=3``: with the group norm's
input as it comes (channels-last) and made contiguous, on all the CPU's
threads and on one (``OMP_NUM_THREADS=1``).  Prints each setting's runs
that died (glibc's "corrupted size vs. prev_size", "double free or
corruption", a segmentation fault) and the first line each left.
Imports nothing of the port.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r'''
import sys
import torch
import torch.nn.functional as F
iters, contig = int(sys.argv[1]), sys.argv[2] == "contiguous"
g = torch.Generator().manual_seed(0)
def w(k, cin, cout):
    return (torch.randn(k, k, cin, cout, generator=g) * 0.3).requires_grad_()
W = {"stem": w(3, 3, 8), "a1": w(3, 8, 8), "a2": w(3, 8, 8),
     "b1": w(3, 8, 16), "b2": w(3, 16, 16), "bp": w(1, 8, 16)}
GN = {k: (torch.ones(c, requires_grad=True), torch.zeros(c, requires_grad=True))
      for k, c in (("stem", 8), ("a1", 8), ("a2", 8), ("b1", 16), ("b2", 16))}
head = (torch.randn(16, 10, generator=g) * 0.1).requires_grad_()
def conv(x, wt, stride=1):
    if wt.shape[0] == 3:
        x = F.pad(x, (1, 1, 1, 1) if stride == 1 else (0, 1, 0, 1))
    return F.conv2d(x, wt.permute(3, 2, 0, 1), stride=stride)
def gn(x, name):
    return F.group_norm(x.contiguous() if contig else x, 4, *GN[name], eps=1e-5)
leaves = list(W.values()) + [t for p in GN.values() for t in p] + [head]
for _ in range(iters):
    x = torch.randn(2, 16, 16, 3, generator=g).permute(0, 3, 1, 2)
    lab = torch.randint(0, 10, (2,), generator=g)
    x = F.relu(gn(conv(x, W["stem"]), "stem"))
    y = F.relu(gn(conv(x, W["a1"]), "a1"))
    x = F.relu(gn(conv(y, W["a2"]), "a2") + x)
    y = F.relu(gn(conv(x, W["b1"], 2), "b1"))
    x = F.relu(gn(conv(y, W["b2"]), "b2") + conv(x, W["bp"], 2))
    logits = x.mean(dim=(2, 3)) @ head
    loss = (torch.logsumexp(logits, -1)
            - logits.gather(1, lab[:, None])[:, 0]).mean()
    torch.autograd.grad(loss, leaves)
print("ok")
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--iters", type=int, default=300)
    args = ap.parse_args()
    import torch
    print(f"torch {torch.__version__}, {os.cpu_count()} CPUs", flush=True)
    for layout in ("channels_last", "contiguous"):
        for threads in (None, 1):
            env = {**os.environ, "MALLOC_CHECK_": "3"}
            if threads:
                env["OMP_NUM_THREADS"] = str(threads)
            died, first = 0, []
            for _ in range(args.runs):
                p = subprocess.run(
                    [sys.executable, "-c", CHILD, str(args.iters), layout],
                    env=env, capture_output=True, text=True, timeout=600)
                if p.returncode != 0:
                    died += 1
                    lines = (p.stderr or p.stdout).strip().splitlines()
                    first.append(lines[0] if lines else f"rc {p.returncode}")
            print(f"{layout}, threads {threads or 'all'}: {died} of "
                  f"{args.runs} runs died {first}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
