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


# ---------------------------------------------------------------------------
# compressed-weight serving GEMMs (kernels/sparse_gemm.py)
# ---------------------------------------------------------------------------


def sparse_gemm_ref(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                    row_len: int) -> torch.Tensor:
    """Densify-then-matmul version of ``sparse_gemm``.

    x: [M, row_len]; idx/val: [R, kcap] compact survivor buffers
    (row-local indices, out-of-row sentinel idx = row_len, val = 0).
    Decodes the [R, row_len] weight by scatter-add (the sentinel lands in
    a spare column that is cut off) and contracts: ``x @ W.T`` in f32.
    """
    R = idx.shape[0]
    w = torch.zeros((R, row_len + 1), dtype=torch.float32, device=x.device)
    w.scatter_add_(1, idx.to(torch.int64).clamp(0, row_len),
                   val.to(torch.float32))
    return x.to(torch.float32) @ w[:, :row_len].T


def qdq_gemm_ref(x: torch.Tensor, levels: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Dequantize-then-matmul version of ``qdq_gemm``: per-row integer
    levels times the [R, 1] f32 scale, contracted in f32."""
    w = levels.to(torch.float32) * scale.to(torch.float32).reshape(-1, 1)
    return x.to(torch.float32) @ w.T


# ---------------------------------------------------------------------------
# single-token decode attention (kernels/flash_attention.py,
# kernels/paged_attention.py)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def flash_decode_ref(q, k, v, valid):
    """Single-token GQA attention over ring-cache contents under a
    slot-validity mask, with a plain masked softmax.

    q: [B, 1, H, D]; k, v: [B, C, KV, D]; valid: [C] (shared by every
    row, as in ``repro``) or [B, C] (one mask per row) bool.  A row with
    no valid slot gets the uniform average, as ``repro``'s does."""
    B, _, H, D = q.shape
    C, KV = k.shape[1], k.shape[2]
    G = H // KV
    live = valid.to(torch.bool).reshape(-1, C).expand(B, C)
    qf = q.to(torch.float32).reshape(B, KV, G, D) * (D ** -0.5)
    s = torch.einsum("bkgh,bckh->bkgc", qf, k.to(torch.float32))
    s = torch.where(live[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgc,bckh->bkgh", p, v.to(torch.float32))
    return o.reshape(B, 1, H, D).to(q.dtype)


def paged_decode_ref(q, kp, vp, kscale, vscale, tables, lengths):
    """Gather-then-attend version of ``paged_decode``.

    q: [B, 1, H, D]; kp/vp: [n_pages, page_size, KV, D] pool arenas (fp,
    or int8 levels with the [n_pages, page_size] f32 per-token-slot
    scales); tables: [B, P] int32 block tables (-1 = unallocated, clamped
    to page 0); lengths: [B] int32.  Materializes each request's logical
    KV view through its table, dequantizes and attends with explicitly
    masked normalization, so a length-0 row gives exact zeros."""
    B, _, H, D = q.shape
    n_pages, ps, KV, _ = kp.shape
    P = tables.shape[1]
    G = H // KV
    tbl = tables.to(torch.int64).clamp(0, n_pages - 1)
    k = kp[tbl].to(torch.float32)                    # [B, P, ps, KV, D]
    v = vp[tbl].to(torch.float32)
    if kp.dtype == torch.int8:
        k = k * kscale[tbl].to(torch.float32)[..., None, None]
        v = v * vscale[tbl].to(torch.float32)[..., None, None]
    k = k.reshape(B, P * ps, KV, D)
    v = v.reshape(B, P * ps, KV, D)
    live = (torch.arange(P * ps, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])             # [B, C]
    qf = q.to(torch.float32).reshape(B, KV, G, D) * (D ** -0.5)
    s = torch.einsum("bkgh,bckh->bkgc", qf, k)
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live[:, None, None, :], torch.exp(s - m),
                    torch.zeros_like(s))
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgc,bckh->bkgh", p, v) / denom.clamp(min=1e-30)
    return o.reshape(B, 1, H, D).to(q.dtype)
