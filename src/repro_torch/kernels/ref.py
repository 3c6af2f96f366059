"""Plain PyTorch versions of the hand-written kernels.

Each function here is the exact semantics its CUDA kernel must
reproduce (ported from ``repro.kernels.ref``).  The kernel wrappers run
them for tensors on the CPU, the CPU tests hold them against ``repro``,
and ``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import torch


def topk_compress_ref(acc: torch.Tensor, k: int, *, iters: int = 24,
                      sign: bool = False):
    """acc: [rows, n] error-compensated accumulator (m + x - x̂).

    Per row: bisect (``iters`` rounds) for the magnitude threshold of
    the k-th largest entry of |acc|; select the survivors (full
    precision, or sign * ||sel||_2 / count when ``sign``); the fused
    error update is m' = acc - selected.

    The bisection keeps cnt(a >= lo) > k >= cnt(a >= hi); the hi
    threshold is taken when it keeps at least k, else lo (>= k
    survivors under ties).  Exact zeros never survive.  This survivor
    rule (not ``torch.topk``'s) decides the wire-bit ledger.

    Returns (selected, new_memory, count_per_row int32).
    """
    accf = acc.to(torch.float32)
    a = accf.abs()
    hi = a.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    half = torch.tensor(0.5, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        mid = half * (lo + hi)
        cnt = (a >= mid).sum(dim=1, keepdim=True)
        more = cnt > k
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    c_hi = (a >= hi).sum(dim=1, keepdim=True)
    thr = torch.where(c_hi >= k, hi, lo)
    mask = (a >= thr) & (a > 0.0)
    cnt = mask.sum(dim=1).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    sel = torch.where(mask, accf, zero)
    if sign:
        norm = torch.sqrt((sel * sel).sum(dim=1, keepdim=True))
        denom = torch.clamp(cnt[:, None].to(torch.float32), min=1.0)
        sel = torch.where(mask, torch.sign(accf) * norm / denom, zero)
    return sel, accf - sel, cnt


def qsgd_bucketed_ref(x: torch.Tensor, u: torch.Tensor, s: int):
    """x: [buckets, n]; u: uniforms [buckets, n] in [0, 1).  Per-bucket
    l2 norm; levels stochastically rounded against ``u``.  Returns the
    dequantized [buckets, n] float32 (zero buckets give 0)."""
    xf = x.to(torch.float32)
    norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True))
    one = torch.ones((), dtype=torch.float32, device=xf.device)
    safe = torch.where(norm > 0, norm, one)
    sf = torch.tensor(float(s), dtype=torch.float32, device=xf.device)
    level = xf.abs() / safe * sf
    low = torch.floor(level)
    xi = low + (u.to(torch.float32) < (level - low)).to(torch.float32)
    q = norm * torch.sign(xf) * xi / sf
    return torch.where(norm > 0, q, torch.zeros_like(xf))
