"""Plain PyTorch versions of the hand-written kernels.

Each function here is the exact semantics its CUDA kernel must
reproduce (ported from ``repro.kernels.ref``).  The kernel wrappers run
them for tensors on the CPU, the CPU tests hold them against ``repro``,
and ``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def sign_norm(sel: torch.Tensor) -> torch.Tensor:
    """SignTop_k's norm, [rows, 1]: ||sel||_2 of each row of survivors.
    A row of one float's norm is that float's magnitude, exactly, as in
    ``repro`` compiled (XLA folds the one-term sum of squares to |x|);
    summing the square would overflow past |x| = 1.8e19."""
    if sel.shape[1] == 1:
        return sel.abs()
    return torch.sqrt((sel * sel).sum(dim=1, keepdim=True))


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
    half = torch.full((), 0.5, dtype=torch.float32, device=a.device)
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
        norm = sign_norm(sel)
        denom = torch.clamp(cnt[:, None].to(torch.float32), min=1.0)
        sel = torch.where(mask, torch.sign(accf) * norm / denom, zero)
    return sel, accf - sel, cnt


#: FLT_MAX / 2: while hi is at most this, lo + hi cannot overflow
_NO_OVERFLOW = float.fromhex("0x1.fffffep+126")


def topk_threshold_levels_ref(acc: torch.Tensor, k: int, *, iters: int = 24,
                              sign: bool = False, levels: int = 4,
                              clusters: int = 8):
    """The arithmetic of ``topk_compress``'s long-row (cluster) kernel, in
    plain PyTorch, for the tests only (nothing on a training path calls
    it).  Same arguments and results as :func:`topk_compress_ref`, plus
    the threshold per row.

    Each row is cut into ``clusters`` chunks of ceil(n / clusters)
    elements rounded up to a multiple of 4.  Pass 0 takes each chunk's
    max |acc| and how many elements equal it; the row's max is hi and
    count(|acc| >= hi) the counts of the chunks that reach it.  Each
    later pass builds the tree of the next ``levels`` bisection mids
    from (lo, hi), every mid ``0.5 * (lo + hi)`` of its own (lo, hi);
    counts per chunk, for every mid, the elements in [lo, hi) at or
    above it (every element where hi > FLT_MAX / 2: then lo + hi may
    overflow); sums the chunks' integer counts; and walks the levels,
    adding count(|acc| >= hi) to each count.  The SignTop_k sum of
    squares of the survivors is :func:`cluster_sq_ref`'s at the kernel's
    geometry (blocks of 256 threads for chunks of up to 8192 floats, else
    512), the one order of :func:`tree_sq_ref`.

    Returns (selected, new_memory, count_per_row int32, threshold)."""
    accf = acc.to(torch.float32)
    a = accf.abs()
    rows, n = a.shape
    dev = a.device
    per = -(-n // clusters)
    chunk = -(-per // 4) * 4
    parts = [a[:, c0:c0 + chunk] for c0 in range(0, clusters * chunk, chunk)]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    half = torch.full((), 0.5, dtype=torch.float32, device=dev)
    # pass 0: every chunk's max (0 for an empty one) and its count
    pm = torch.stack([p.amax(dim=1) if p.shape[1] else
                      torch.zeros(rows, device=dev) for p in parts])
    pc = torch.stack([(p == m[:, None]).sum(dim=1)
                      for p, m in zip(parts, pm)])
    hi = pm.amax(dim=0)
    lo = torch.zeros_like(hi)
    cnt_hi = torch.where(pm == hi, pc, torch.zeros_like(pc)).sum(dim=0)
    full = ~(hi <= _NO_OVERFLOW)
    n_mids = (1 << levels) - 1
    for done in range(0, iters, levels):
        nlo, nhi, mids = [lo] + [None] * (n_mids - 1), \
            [hi] + [None] * (n_mids - 1), []
        for j in range(n_mids):
            mids.append(half * (nlo[j] + nhi[j]))
            if 2 * j + 2 < n_mids:
                nlo[2 * j + 1], nhi[2 * j + 1] = nlo[j], mids[j]
                nlo[2 * j + 2], nhi[2 * j + 2] = mids[j], nhi[j]
        mid = torch.stack(mids, dim=1)                       # [rows, mids]
        tot = torch.zeros((rows, n_mids), dtype=torch.int64, device=dev)
        for p in parts:
            band = full[:, None] | ((p >= lo[:, None]) & (p < hi[:, None]))
            tot += ((p[:, :, None] >= mid[:, None, :])
                    & band[:, :, None]).sum(dim=1)
        base = torch.where(full, torch.zeros_like(cnt_hi), cnt_hi)
        node = torch.zeros(rows, dtype=torch.int64, device=dev)
        for _ in range(min(levels, iters - done)):
            md = half * (lo + hi)
            c = base + tot.gather(1, node[:, None])[:, 0]
            more = c > k
            lo = torch.where(more, md, lo)
            hi = torch.where(more, hi, md)
            cnt_hi = torch.where(more, cnt_hi, c)
            node = torch.where(more, 2 * node + 2, 2 * node + 1)
    thr = torch.where(cnt_hi >= k, hi, lo)
    mask = (a >= thr[:, None]) & (a > 0.0)
    cnt = mask.sum(dim=1).to(torch.int32)
    sel = torch.where(mask, accf, zero)
    if sign:
        sq = cluster_sq_ref(sel, clusters, 256 if chunk <= 8192 else 512)
        scale = torch.sqrt(sq) / torch.clamp(cnt.to(torch.float32), min=1.0)
        sel = torch.where(mask, torch.sign(accf) * scale[:, None], zero)
    return sel, accf - sel, cnt, thr


#: the key of a NaN: left out of every count and order statistic
_ABSENT = -1


def abs_keys(acc: torch.Tensor) -> torch.Tensor:
    """The bits of |acc| as int64 keys (for |x| >= 0 the order of the bits
    is the order of the floats); NaN -> ``_ABSENT``."""
    bits = acc.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0x7FFFFFFF
    return torch.where(bits > 0x7F800000, torch.full_like(bits, _ABSENT),
                       bits)


def radix_select(keys: torch.Tensor, k: int) -> tuple:
    """The k-th largest present key of one row as the short-row kernel
    selects it (``csrc/common.cuh`` select_threshold): 8 bits a pass from
    the top, a histogram of the next digit over the keys that match the
    digits chosen so far, the digit where the count from the top reaches
    the rank still needed; after a digit, where that rank is 1 (or the
    bin's count) the bin's largest (smallest) key is the answer.
    Returns (key or ``_ABSENT`` where fewer than k keys, passes taken)."""
    live = keys[keys != _ABSENT]
    prefix, mask, need = 0, 0, k
    for p, shift in enumerate((24, 16, 8, 0)):
        cand = live[(live & mask) == prefix]
        hist = torch.bincount((cand >> shift) & 255, minlength=256)
        above = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
        reach = (above >= need).nonzero()
        if not len(reach):
            return _ABSENT, p + 1
        digit = int(reach[-1])
        need -= int(above[digit] - hist[digit])
        prefix |= digit << shift
        mask |= 255 << shift
        if shift == 0:
            return prefix, p + 1
        if need == 1 or need == int(hist[digit]):
            inbin = live[(live & mask) == prefix]
            return int(inbin.max() if need == 1 else inbin.min()), p + 1
    raise AssertionError("unreachable")


def topk_threshold_select_ref(acc: torch.Tensor, k: int, *, iters: int = 24,
                              sign: bool = False):
    """The arithmetic of ``topk_compress``'s short-row kernel, in plain
    PyTorch, for the tests only (nothing on a training path calls it).
    Same arguments and results as :func:`topk_compress_ref`, plus the
    threshold per row.

    Per row, with a(j) the j-th largest |acc| counted with multiplicity,
    NaN left out (the CUDA loop's fmaxf skips it and no count sees it):
    a(1) by a max, a(k) by :func:`radix_select`, a(k+1) = a(k) where at
    least k + 1 elements reach it, else the largest below it.  Then the
    serial bisection is replayed in float32: hi = max(0, a(1)), lo = 0;
    ``iters`` rounds of mid = 0.5 * (lo + hi), lo = mid where a(k+1) >=
    mid (count(|acc| >= mid) > k), else hi = mid; thr = hi where a(k) >=
    hi (count(|acc| >= hi) >= k), else lo.  The SignTop_k norm is summed
    in PyTorch's order (the kernel's is another fixed order).

    Returns (selected, new_memory, count_per_row int32, threshold)."""
    accf = acc.to(torch.float32)
    a = accf.abs()
    keys = abs_keys(accf).cpu()
    half = np.float32(0.5)
    thr = np.zeros(accf.shape[0], np.float32)

    def as_float(key: int) -> np.float32:
        return np.array([key], np.uint32).view(np.float32)[0]

    for r in range(accf.shape[0]):
        row = keys[r]
        live = row[row != _ABSENT]
        a1 = int(live.max()) if len(live) else 0
        ak, _ = radix_select(row, k)
        ak1 = _ABSENT
        if ak != _ABSENT:
            below = live[live < ak]
            ak1 = (ak if int((live >= ak).sum()) >= k + 1 else
                   int(below.max()) if len(below) else _ABSENT)
        hi, lo = as_float(a1), np.float32(0.0)
        with np.errstate(over="ignore"):
            for _ in range(iters):
                mid = half * (lo + hi)
                if ak1 != _ABSENT and as_float(ak1) >= mid:
                    lo = mid
                else:
                    hi = mid
        thr[r] = hi if ak != _ABSENT and as_float(ak) >= hi else lo
    t = torch.from_numpy(thr).to(a.device)[:, None]
    mask = (a >= t) & (a > 0.0)
    cnt = mask.sum(dim=1).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    sel = torch.where(mask, accf, zero)
    if sign:
        norm = sign_norm(sel)
        denom = torch.clamp(cnt[:, None].to(torch.float32), min=1.0)
        sel = torch.where(mask, torch.sign(accf) * norm / denom, zero)
    return sel, accf - sel, cnt, t[:, 0]


def topk_compact_ref(acc: torch.Tensor, k: int, kcap: int, *,
                     iters: int = 24, sign: bool = False):
    """Compact form of :func:`topk_compress_ref`: the same threshold and
    survivors, written into ``(idx, val)`` buffers of ``kcap`` slots per
    row in ascending index order.  Slot ``pos`` of a survivor is the
    count of survivors before it; survivors with ``pos >= kcap`` (heavy
    ties only) are not emitted and stay in the memory.  The SignTop_k
    norm and count are taken over the emitted survivors.  Empty slots
    hold the out-of-row sentinel ``(idx = n, val = 0)``.

    ``repro`` scatters the slots with a one-hot contraction because TPUs
    have no scatter; here a cumsum gives the slots and a scatter writes
    them (every element not emitted goes to a spare slot that is cut
    off), with no data-dependent shape, so a CUDA graph can hold it.

    Returns (idx [rows, kcap] int32, val [rows, kcap] float32,
    new_memory [rows, n] float32, count_per_row int32).
    """
    accf = acc.to(torch.float32)
    rows, n = accf.shape
    a = accf.abs()
    hi = a.amax(dim=1, keepdim=True)
    lo = torch.zeros_like(hi)
    half = torch.full((), 0.5, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        mid = half * (lo + hi)
        more = (a >= mid).sum(dim=1, keepdim=True) > k
        lo = torch.where(more, mid, lo)
        hi = torch.where(more, hi, mid)
    c_hi = (a >= hi).sum(dim=1, keepdim=True)
    thr = torch.where(c_hi >= k, hi, lo)
    mask = (a >= thr) & (a > 0.0)
    pos = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    emit = mask & (pos < kcap)
    cnt = emit.sum(dim=1).to(torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    sel = torch.where(emit, accf, zero)
    if sign:
        norm = sign_norm(sel)
        denom = torch.clamp(cnt[:, None].to(torch.float32), min=1.0)
        sel = torch.where(emit, torch.sign(accf) * norm / denom, zero)
    slot = torch.where(emit, pos, kcap).to(torch.int64)
    cols = torch.arange(n, dtype=torch.int32, device=a.device)
    idx = torch.full((rows, kcap + 1), n, dtype=torch.int32, device=a.device)
    val = torch.zeros((rows, kcap + 1), dtype=torch.float32,
                      device=a.device)
    idx.scatter_(1, slot, cols.expand(rows, n))
    val.scatter_(1, slot, sel)
    return idx[:, :kcap], val[:, :kcap], accf - sel, cnt


def compact_warps(n: int) -> int:
    """Warps a row of ``topk_compact``'s (and ``topk_compress``'s)
    short-row kernel: one up to 2048 floats, then 4, 8 or 12."""
    return 1 if n <= 2048 else 4 if n <= 4096 else 8 if n <= 8192 else 12


def topk_compact_rows_ref(acc: torch.Tensor, k: int, kcap: int, *,
                          iters: int = 24, sign: bool = False,
                          warps: int = 0):
    """The arithmetic of ``topk_compact``'s short-row kernel, in plain
    PyTorch, for the tests only (nothing on a training path calls it).
    Same arguments and results as :func:`topk_compact_ref`; ``warps``
    (0: the kernel's choice, :func:`compact_warps`) warps a row.

    The threshold is :func:`topk_threshold_select_ref`'s (the kernel's
    ``row_threshold``; NaN left out).  With T = 32 ``warps`` threads a
    row and V4 float4s a thread, element (j, t, q) is index 4 (j T + t) +
    q (slots past n hold NaN).  For each j, lane l of warp w takes four
    ballots of the survivor mask (one per q): the survivors of the
    lower lanes, over all four; the warps' totals give the survivors of
    the lower warps; a carry counts the j's before; its own lower q
    complete its slot.  A survivor is emitted where its slot is below
    ``kcap``.  The SignTop_k norm is the kernel's float sum: each
    thread's emitted squares in index order (each product rounded, then
    added), a butterfly over the warp's lanes (xor 16, 8, 4, 2, 1), the
    warps' sums from 0 in order; a row of one float's is its magnitude
    (:func:`sign_norm`).

    Returns (idx [rows, kcap] int32, val [rows, kcap] float32,
    new_memory [rows, n] float32, count_per_row int32)."""
    accf = acc.to(torch.float32)
    rows, n = accf.shape
    dev = accf.device
    rw = warps or compact_warps(n)
    T = 32 * rw
    v4 = max(1, -(-n // (4 * T)))
    thr = topk_threshold_select_ref(accf, k, iters=iters)[3]
    x = torch.full((rows, 4 * T * v4), float("nan"), dtype=torch.float32,
                   device=dev)
    x[:, :n] = accf
    a = x.abs()
    kept = (a >= thr[:, None]) & (a > 0.0)
    k4 = kept.view(rows, v4, rw, 32, 4).to(torch.int64)
    lane_n = k4.sum(dim=4)                                 # a lane's, all q
    below = torch.cumsum(lane_n, dim=3) - lane_n           # lower lanes
    mine = lane_n.sum(dim=3, keepdim=True)                 # the warp's
    before = torch.cumsum(mine, dim=2) - mine              # lower warps
    total = mine.sum(dim=2, keepdim=True)                  # the j's
    carry = torch.cumsum(total, dim=1) - total             # the j's before
    own = torch.cumsum(k4, dim=4) - k4                     # lower q
    pos = (carry[..., None] + before[..., None] + below[..., None]
           + own).view(rows, -1)
    emit = kept & (pos < kcap)
    cnt = torch.clamp(total.view(rows, v4).sum(dim=1), max=kcap).to(
        torch.int32)
    # the norm: a thread's squares in (j, q) order, lanes, warps
    xe = torch.where(emit, x, torch.zeros((), device=dev)).view(
        rows, v4, T, 4)
    sq = torch.zeros((rows, T), dtype=torch.float32, device=dev)
    for j in range(v4):
        for q in range(4):
            e = xe[:, j, :, q]
            sq = sq + e * e
    sq = sq.view(rows, rw, 32)
    lanes = torch.arange(32, device=dev)
    for off in (16, 8, 4, 2, 1):
        sq = sq + sq[:, :, lanes ^ off]
    norm_sq = sq[:, 0, 0]
    if rw > 1:
        norm_sq = torch.zeros(rows, dtype=torch.float32, device=dev)
        for w in range(rw):
            norm_sq = norm_sq + sq[:, w, 0]
    norm = (xe[:, 0, 0, 0].abs() if n == 1 else    # as sign_norm
            torch.sqrt(norm_sq))
    scale = norm / torch.clamp(cnt.to(torch.float32), min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sel = torch.where(emit, torch.sign(x) * scale[:, None] if sign else x,
                      zero)
    mem = (x - sel)[:, :n]
    r, c = emit.nonzero(as_tuple=True)
    idx = torch.full((rows, kcap), n, dtype=torch.int32, device=dev)
    val = torch.zeros((rows, kcap), dtype=torch.float32, device=dev)
    idx[r, pos[r, c]] = c.to(torch.int32)
    val[r, pos[r, c]] = sel[r, c]
    return idx, val, mem, cnt


def _qsgd_levels(xf: torch.Tensor, u: torch.Tensor, s: int,
                 norm: torch.Tensor) -> torch.Tensor:
    """QSGD's levels against the uniforms ``u``, dequantized, given each
    bucket's norm [buckets, 1]."""
    one = torch.ones((), dtype=torch.float32, device=xf.device)
    safe = torch.where(norm > 0, norm, one)
    sf = torch.full((), float(s), dtype=torch.float32, device=xf.device)
    level = xf.abs() / safe * sf
    low = torch.floor(level)
    xi = low + (u.to(torch.float32) < (level - low)).to(torch.float32)
    q = norm * torch.sign(xf) * xi / sf
    return torch.where(norm > 0, q, torch.zeros_like(xf))


def qsgd_bucketed_ref(x: torch.Tensor, u: torch.Tensor, s: int):
    """x: [buckets, n]; u: uniforms [buckets, n] in [0, 1).  Per-bucket
    l2 norm; levels stochastically rounded against ``u``.  Returns the
    dequantized [buckets, n] float32 (zero buckets give 0)."""
    xf = x.to(torch.float32)
    norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True))
    return _qsgd_levels(xf, u, s, norm)


def qsgd_cluster_ref(x: torch.Tensor, u: torch.Tensor, s: int, cs: int):
    """The arithmetic of ``qsgd_quantize``'s cluster kernel, in plain
    PyTorch, for the tests only: the norm summed as a cluster of ``cs``
    blocks of 512 threads sums it (:func:`cluster_sq_ref`), then
    the levels as :func:`qsgd_bucketed_ref` takes them.  Only the order
    of the sum differs from that plain version, and no ``cs`` changes it
    (it is :func:`tree_sq_ref`'s)."""
    xf = x.to(torch.float32)
    norm = torch.sqrt(cluster_sq_ref(xf, cs, 512))[:, None]
    return _qsgd_levels(xf, u, s, norm)


#: floats of a unit of the sum-of-squares tree (``csrc/common.cuh``
#: kTreeUnit): 512 groups of four
TREE_UNIT = 2048


def _pair_tree(t: torch.Tensor) -> torch.Tensor:
    """[rows, m] -> [rows]: the adjacent-pair tree over the columns, their
    count padded with zeros to a power of two."""
    m = max(1, t.shape[1])
    p = 1
    while p < m:
        p *= 2
    t = torch.nn.functional.pad(t, (0, p - t.shape[1]))
    while t.shape[1] > 1:
        t = t[:, 0::2] + t[:, 1::2]
    return t[:, 0]


def _group_sq(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[rows, n] -> [rows, groups]: each group of four floats as
    ((a^2 + b^2) + c^2) + d^2, zeros past n (each operation rounded to
    float32, no fused multiply-add)."""
    x = torch.nn.functional.pad(x, (0, 4 * groups - x.shape[1]))
    sq = (x * x).reshape(x.shape[0], groups, 4)
    return ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]


def tree_sq_ref(x: torch.Tensor) -> torch.Tensor:
    """[rows, n] -> [rows] float32: each row's sum of squares in the one
    order the cluster kernels take at every geometry (``qsgd_quantize``'s
    norm, the long-row SignTop_k scale over the survivors): groups of four
    summed as ((a^2 + b^2) + c^2) + d^2, then the adjacent-pair tree over
    the groups, their count padded with zeros to a power of two."""
    xf = x.to(torch.float32)
    return _pair_tree(_group_sq(xf, max(1, -(-xf.shape[1] // 4))))


def cluster_sq_ref(x: torch.Tensor, cs: int, threads: int) -> torch.Tensor:
    """:func:`tree_sq_ref` computed as a cluster of ``cs`` blocks of
    ``threads`` threads computes it (``csrc/common.cuh`` unit_sums /
    units_tree): the row's units of ``TREE_UNIT`` floats split over the
    blocks, ceil(units / cs) each; a unit's 512 groups in segments of
    ``threads``, each the tree over its warps' 32-lane trees; then every
    block adds all the units, lane l of a warp taking max(1, P / 32)
    adjacent ones (P: the unit count rounded up to a power of two) and
    the lanes their sums.  For the tests: it equals tree_sq_ref bit for
    bit at every ``cs`` and ``threads``."""
    xf = x.to(torch.float32)
    rows, n = xf.shape
    units = max(1, -(-n // TREE_UNIT))
    q = _group_sq(xf, units * 512)
    ub = -(-units // cs)
    sums = []
    for r in range(cs):
        for j in range(r * ub, min(units, (r + 1) * ub)):
            segs = []
            for g0 in range(j * 512, (j + 1) * 512, threads):
                warps = [_pair_tree(q[:, w:w + 32])
                         for w in range(g0, g0 + threads, 32)]
                segs.append(_pair_tree(torch.stack(warps, dim=1)))
            sums.append(segs[0] if len(segs) == 1 else segs[0] + segs[1])
    p = 1
    while p < units:
        p *= 2
    per = max(1, p // 32)
    tot = torch.stack(sums, dim=1)
    lanes = [_pair_tree(tot[:, l * per:(l + 1) * per]) if l * per < units
             else torch.zeros(rows, dtype=torch.float32, device=xf.device)
             for l in range(32)]
    return _pair_tree(torch.stack(lanes, dim=1))


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


def sparse_gemm_tiled_ref(x: torch.Tensor, idx: torch.Tensor,
                          val: torch.Tensor, row_len: int, tile_m: int,
                          tile_r: int, chunk: int):
    """A plain model of the tiled ``sparse_gemm`` kernel's walk.

    x is padded with zero rows to whole tiles of ``tile_m`` activation
    rows and the buffers with empty rows to whole slabs of ``tile_r``
    output rows.  The columns are walked in chunks of ``chunk``; every
    row keeps a cursor (its next slot) and a batch of the 32 slots from
    ``cursor & ~31`` (slots past kcap, and indices outside [0, row_len),
    read as the sentinel).  In a chunk [c0, c1) a row adds the slots from
    its cursor to the batch's count of indices below c1, and loads the
    next batch while that count is 32.  Each output is summed over its
    slots in ascending order, in float32.

    Returns (y [M, R] float32, visits [R, kcap] int64: how often the walk
    added each slot).
    """
    M, n = x.shape
    R, kcap = idx.shape
    Mp = -(-M // tile_m) * tile_m
    Rp = -(-R // tile_r) * tile_r
    xf = torch.zeros((Mp, n), dtype=torch.float32)
    xf[:M] = x.to(torch.float32).cpu()
    width = -(-kcap // 32) * 32 + 32          # room for one sentinel batch
    bidx = torch.full((Rp, width), n, dtype=torch.int64)
    bval = torch.zeros((Rp, width), dtype=torch.float32)
    i64 = idx.to(torch.int64).cpu()
    bidx[:R, :kcap] = torch.where((i64 >= 0) & (i64 <= n), i64, n)
    bval[:R, :kcap] = val.to(torch.float32).cpu()
    cur = torch.zeros(Rp, dtype=torch.int64)
    acc = torch.zeros((Mp, Rp), dtype=torch.float32)
    visits = torch.zeros((Rp, width), dtype=torch.int64)
    rows = torch.arange(Rp)
    lanes = torch.arange(32)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        walking = torch.ones(Rp, dtype=torch.bool)
        while bool(walking.any()):
            b = cur & ~31
            batch = bidx.gather(1, b[:, None] + lanes)
            below = (batch < c1).sum(dim=1)
            end = torch.where(walking, b + below, cur)
            for t in range(int((end - cur).max())):
                s = cur + t
                on = s < end
                c = bidx[rows, s]
                if bool((on & ((c < c0) | (c >= c1))).any()):
                    raise AssertionError("a run left its chunk: indices "
                                         "must ascend")
                r_on, c_on = rows[on], c[on]
                acc[:, r_on] += xf[:, c_on] * bval[r_on, s[on]]
                visits[r_on, s[on]] += 1
            cur = end
            walking &= below == 32
    return (acc[:M, :R].to(x.device),
            visits[:R, :kcap].to(x.device))


def sparse_gemm_rows_ref(x: torch.Tensor, idx: torch.Tensor,
                         val: torch.Tensor, row_len: int, blocks: int,
                         rows: int, warps: int = 16):
    """A plain model of the decode ``sparse_gemm`` kernel's walk (M <= 8).

    x's M rows are padded with zero rows to ``rec`` = 1, 2, 4 or 8 (a
    staged record).  Block b owns output rows [b * rows, (b + 1) * rows)
    (``kernels.sparse_gemm.decode_grid``), cut into batches of ``batch``
    rows (16 / rec from rec 4 up, else 4); batch q is walked by warp q %
    ``warps``.  Each row walks 32 slots a round, lane l holding slot
    32 j + l (slots past kcap, and indices outside [0, row_len), read as
    the sentinel): in the round that holds its first sentinel the lanes
    before it add their slot and the row stops; otherwise every lane adds
    and the row goes on while slots are left.  A lane sums its slots in
    order, one rounding each (``fmaf``, modelled in float64); the 32
    lanes' sums are added in the butterfly order of the kernel's
    reduce-scatter (lane l with l + 16, then + 8, ..).

    Returns (y [M, R] float32, visits [R, kcap] int64: how often the walk
    added each slot, walks [R] int64: how many warps walked each row).
    """
    M, n = x.shape
    R, kcap = idx.shape
    rec = 1 if M <= 1 else 2 if M <= 2 else 4 if M <= 4 else 8
    batch = 16 // rec if rec >= 4 else 4
    xf = torch.zeros((rec, n + 1), dtype=torch.float64)
    xf[:M, :n] = x.to(torch.float32).cpu().to(torch.float64)
    i64 = idx.to(torch.int64).cpu()
    vf = val.to(torch.float32).cpu()
    y = torch.zeros((rec, R), dtype=torch.float32)
    visits = torch.zeros((R, kcap), dtype=torch.int64)
    walks = torch.zeros(R, dtype=torch.int64)
    lanes = torch.arange(32)
    for b in range(blocks):
        r_beg = b * rows
        nrows = max(0, min(R, r_beg + rows) - r_beg)
        for w in range(warps):
            for q in range(w, -(-nrows // batch), warps):
                for r in range(r_beg + q * batch,
                               r_beg + min(nrows, (q + 1) * batch)):
                    walks[r] += 1
                    acc = torch.zeros((32, rec), dtype=torch.float32)
                    for s0 in range(0, kcap, 32):
                        s = s0 + lanes
                        inside = s < kcap
                        c = torch.full((32,), n, dtype=torch.int64)
                        c[inside] = i64[r, s[inside]]
                        live = (c >= 0) & (c < n)
                        first = int((~live).nonzero()[0]) if not bool(
                            live.all()) else 32
                        on = lanes < first
                        v = torch.zeros(32, dtype=torch.float64)
                        v[inside] = vf[r, s[inside]].to(torch.float64)
                        prod = v[on, None] * xf[:, c[on]].T  # exact in f64
                        acc[on] = (acc[on].to(torch.float64) + prod).to(
                            torch.float32)
                        visits[r, s[on]] += 1
                        if first < 32:
                            break
                    while acc.shape[0] > 1:
                        h = acc.shape[0] // 2
                        acc = acc[:h] + acc[h:]
                    y[:, r] = acc[0]
    return y[:M].to(x.device), visits.to(x.device), walks.to(x.device)


def qdq_gemm_ref(x: torch.Tensor, levels: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Dequantize-then-matmul version of ``qdq_gemm``: per-row integer
    levels times the [R, 1] f32 scale, contracted in f32."""
    w = levels.to(torch.float32) * scale.to(torch.float32).reshape(-1, 1)
    return x.to(torch.float32) @ w.T


def qdq_gemm_factored_ref(x: torch.Tensor, levels: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``qdq_gemm`` with the scale folded out of the row's sum, as the
    kernel computes it: ``scale[r] * sum_c x[m, c] * levels[r, c]`` in
    float32 (the levels are exact integers)."""
    dot = x.to(torch.float32) @ levels.to(torch.float32).T
    return dot * scale.to(torch.float32).reshape(1, -1)


# ---------------------------------------------------------------------------
# single-token decode attention (kernels/flash_attention.py,
# kernels/paged_attention.py)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, window: int = -1):
    """Causal GQA attention over a whole sequence, with a plain masked
    softmax: query i sees keys j <= i, and only j > i - window when
    ``window`` > 0.

    q: [B, S, H, D]; k, v: [B, S, KV, D].  Scores and sums in float32 (q
    scaled by D ** -0.5 before the product); returns [B, S, H, D] in q's
    dtype."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.to(torch.float32).reshape(B, S, KV, G, D) * (D ** -0.5)
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(torch.float32))
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(torch.float32))
    return o.reshape(B, S, H, D).to(q.dtype)


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


def flash_decode_split_ref(q, k, v, valid, splits: int, chunk: int):
    """The arithmetic of the split ``flash_decode`` kernel, in plain
    PyTorch, for the tests only (nothing on a serving path calls it):
    the C slots in ``splits`` chunks of ``chunk`` (the last one ragged);
    per chunk a partial (m, l, o) of the masked scores (masked slots at
    the finite -1e30, so an all-masked chunk has m = -1e30 and l = its
    slot count); then the log-sum-exp merge M = max m, w = exp(m - M),
    out = sum(w o) / max(sum(w l), 1e-30).  Same arguments and result as
    ``flash_decode_ref``."""
    B, _, H, D = q.shape
    C, KV = k.shape[1], k.shape[2]
    G = H // KV
    live = valid.to(torch.bool).reshape(-1, C).expand(B, C)
    qf = q.to(torch.float32).reshape(B, KV, G, D) * (D ** -0.5)
    ms, ls, os_ = [], [], []
    for c0 in range(0, splits * chunk, chunk):
        kc = k[:, c0:c0 + chunk].to(torch.float32)
        vc = v[:, c0:c0 + chunk].to(torch.float32)
        s = torch.einsum("bkgh,bckh->bkgc", qf, kc)
        s = torch.where(live[:, None, None, c0:c0 + chunk], s,
                        torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bkgc,bckh->bkgh", p, vc))
    m = torch.stack(ms)                            # [splits, B, KV, G]
    w = torch.exp(m - m.amax(dim=0))
    lsum = (w * torch.stack(ls)).sum(dim=0)
    o = (w[..., None] * torch.stack(os_)).sum(dim=0)
    o = o / lsum.clamp(min=1e-30)[..., None]
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


def paged_decode_split_ref(q, kp, vp, kscale, vscale, tables, lengths,
                           pages_per_block: int):
    """The arithmetic of the split ``paged_decode`` kernel, in plain
    PyTorch, for the tests only (nothing on a serving path calls it).
    Same arguments and result as :func:`paged_decode_ref`, plus the
    kernel's geometry.

    Each row's table is cut into splits of ``pages_per_block`` logical
    pages (``pb * page_size`` positions); only the row's live splits,
    the first max(1, ceil(length / (pb * page_size))), take part.  Per
    split a partial (m, l, o) with dead positions masked on the score
    (-1e30) and on p itself (exactly 0), so a split with no live position
    has l = 0 and o = 0; then the log-sum-exp merge M = max m, w =
    exp(m - M), out = sum(w o) / max(sum(w l), 1e-30).  A length-0 row
    gives exact zeros."""
    B, _, H, D = q.shape
    n_pages, ps, KV, _ = kp.shape
    P = tables.shape[1]
    G = H // KV
    pb = max(1, min(int(pages_per_block), P))
    span = pb * ps
    splits = -(-P // pb)
    tbl = tables.to(torch.int64).clamp(0, n_pages - 1)
    k = kp[tbl].to(torch.float32)
    v = vp[tbl].to(torch.float32)
    if kp.dtype == torch.int8:
        k = k * kscale[tbl].to(torch.float32)[..., None, None]
        v = v * vscale[tbl].to(torch.float32)[..., None, None]
    k = k.reshape(B, P * ps, KV, D)
    v = v.reshape(B, P * ps, KV, D)
    lens = lengths.to(device=q.device, dtype=torch.int64)
    n_live = (-(-lens // span)).clamp(1, splits)
    qf = q.to(torch.float32).reshape(B, KV, G, D) * (D ** -0.5)
    ms, ls, os_ = [], [], []
    for s in range(splits):
        c0 = s * span
        kc, vc = k[:, c0:c0 + span], v[:, c0:c0 + span]
        pos = torch.arange(c0, c0 + kc.shape[1], device=q.device)
        live = (pos[None, :] < lens[:, None])[:, None, None, :]
        sc = torch.einsum("bkgh,bckh->bkgc", qf, kc)
        sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(dim=-1)
        p = torch.where(live, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        takes = (s < n_live)[:, None, None]
        ms.append(torch.where(takes, m, torch.full_like(m, NEG_INF)))
        ls.append(torch.where(takes, p.sum(dim=-1), torch.zeros_like(m)))
        o = torch.einsum("bkgc,bckh->bkgh", p, vc)
        os_.append(torch.where(takes[..., None], o, torch.zeros_like(o)))
    m = torch.stack(ms)                            # [splits, B, KV, G]
    w = torch.exp(m - m.amax(dim=0))
    lsum = (w * torch.stack(ls)).sum(dim=0)
    o = (w[..., None] * torch.stack(os_)).sum(dim=0)
    o = o / lsum.clamp(min=1e-30)[..., None]
    return o.reshape(B, 1, H, D).to(q.dtype)
