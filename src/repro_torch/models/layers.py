"""Shared transformer building blocks (a port of the parts of
``repro.models.layers`` that the ported models use).

Everything is a function over explicit parameter trees (nested dicts of
tensors, per-layer leaves stacked on a leading [L] axis).  Numerics
follow ``repro`` cast for cast: norms, rope and attention compute in
float32 and cast back to the activation dtype at the same points, and a
compressed weight's matmul computes in float32 and casts to the weight's
dtype.

KV state is updated in place (``cache_write``, ``cache_prefill``,
``paged_write``, ``paged_prefill_insert`` return the object they were
given), where ``repro``'s functional updates return new arrays: the
serving engine keeps one cache and one page pool for its whole life.

``dispatch`` arguments are a ``kernels.dispatch.DispatchConfig`` (None
= the module default): they decide whether compressed matmuls and
decode attention run the hand-written kernels or their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch as dsp
from repro_torch.kernels import ref

NEG_INF = ref.NEG_INF


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """N(0, 1) * scale (default fan_in ** -0.5), drawn from ``gen`` on
    the generator's device and moved to ``device``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32) * s
    return w.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# norms / embeddings / rope
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] (int)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[..., None, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table) -> torch.Tensor:
    if isinstance(table, torch.Tensor):
        return table[tokens.to(torch.int64)]
    return table.take_rows(tokens)        # compressed serving table


def matmul(x: torch.Tensor, w, dispatch=None) -> torch.Tensor:
    """``x @ w``, or a compressed weight's own contraction
    (``serve.compressed.CompressedTensor.matmul``: the sparse / quantized
    GEMM kernels), so models never import the serving layer."""
    if isinstance(w, torch.Tensor):
        return x @ w
    return w.matmul(x, dispatch)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def attn_params(gen, cfg: ModelConfig, stacked: Optional[int], device=None):
    """Per-layer (or [L]-stacked) GQA projection weights."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pre = (stacked,) if stacked else ()
    return {
        "wq": dense_init(gen, pre + (d, H * hd), cfg.pdtype, device=device),
        "wk": dense_init(gen, pre + (d, KV * hd), cfg.pdtype, device=device),
        "wv": dense_init(gen, pre + (d, KV * hd), cfg.pdtype, device=device),
        "wo": dense_init(gen, pre + (H * hd, d), cfg.pdtype, device=device),
    }


def mlp_params(gen, cfg: ModelConfig, stacked: Optional[int], d_ff=None,
               device=None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    pre = (stacked,) if stacked else ()
    return {
        "w1": dense_init(gen, pre + (d, ff), cfg.pdtype, device=device),
        "w3": dense_init(gen, pre + (d, ff), cfg.pdtype, device=device),
        "w2": dense_init(gen, pre + (ff, d), cfg.pdtype, device=device),
    }


def norm_params(cfg: ModelConfig, stacked: Optional[int], device=None):
    pre = (stacked,) if stacked else ()
    return torch.zeros(pre + (cfg.d_model,), dtype=cfg.pdtype, device=device)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B, Sq, KV, G, hd], k: [B, Sk, KV, hd] -> [B, KV, G, Sq, Sk]."""
    return torch.einsum("bqkgh,bskh->bkgqs", q, k)


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: [B, KV, G, Sq, Sk], v: [B, Sk, KV, hd] -> [B, Sq, KV, G, hd]."""
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.to(p.dtype))


def _window_mask(kpos, qpos, window: Optional[int]):
    """Causal mask [Sq, Sk] (or [..., C] for decode), cut to the last
    ``window`` positions when window > 0."""
    mask = kpos <= qpos
    if window is not None and window > 0:
        mask &= kpos > qpos - window
    return mask


def chunked_attention(q, k, v, *, window: Optional[int], q_chunk: int):
    """Causal (optionally sliding-window) attention over query chunks,
    so peak score memory is O(q_chunk * S).  q: [B, S, H, hd] (rope'd);
    k, v: [B, S, KV, hd]."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qc = min(q_chunk, S)
    kf = k.to(torch.float32)
    kpos = torch.arange(S, device=q.device)
    outs = []
    for c0 in range(0, S, qc):
        qchunk = q[:, c0:c0 + qc].reshape(B, -1, KV, G, hd)
        qpos = torch.arange(c0, c0 + qchunk.shape[1], device=q.device)
        s = _gqa_scores(qchunk.to(torch.float32) * scale, kf)
        mask = _window_mask(kpos[None, :], qpos[:, None], window)
        s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        outs.append(_gqa_out(torch.softmax(s, dim=-1), v))
    out = torch.cat(outs, dim=1).reshape(B, S, H, hd)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache (ring buffer with a slot -> position map per row)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """One layer's ring cache ([L, ...]-stacked when every layer has the
    same length).  ``pos`` is [B, C]: the global position each row's slot
    holds, -1 = empty.  ``repro`` keeps one [C] map for the batch because
    its engine decodes the slots one at a time; the port decodes the slot
    batch at once, each row at its own position."""

    k: torch.Tensor      # [B, C, KV, hd]
    v: torch.Tensor      # [B, C, KV, hd]
    pos: torch.Tensor    # [B, C] int32


def init_kv_cache(cfg: ModelConfig, batch: int, window: int, max_len: int,
                  stacked: Optional[int] = None, dtype=None,
                  device=None) -> KVCache:
    C = max_len if window is None or window <= 0 else min(window, max_len)
    pre = (stacked,) if stacked else ()
    dt = dtype or cfg.adtype
    shape = pre + (batch, C, cfg.n_kv_heads, cfg.hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        pos=torch.full(pre + (batch, C), -1, dtype=torch.int32,
                       device=device),
    )


def layer_cache(cache, i: int) -> KVCache:
    """Layer ``i`` of a stacked cache (views) or of a per-layer list."""
    if isinstance(cache, KVCache):
        return KVCache(cache.k[i], cache.v[i], cache.pos[i])
    return cache[i]


def _row_positions(pos, B: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).reshape(-1).expand(B)
    return torch.full((B,), int(pos), dtype=torch.int64, device=device)


def cache_write(cache: KVCache, k_new, v_new, pos) -> KVCache:
    """Write one token per row (k_new / v_new: [B, 1, KV, hd]) at global
    position ``pos`` (an int, or [B] per row), in place."""
    B, C = cache.k.shape[0], cache.k.shape[1]
    p = _row_positions(pos, B, cache.k.device)
    rows = torch.arange(B, device=cache.k.device)
    slot = torch.remainder(p, C)
    cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[rows, slot] = p.to(torch.int32)
    return cache


def cache_prefill(cache: KVCache, k_all, v_all, S: int) -> KVCache:
    """Bulk-write positions [0, S) in place.  A ring shorter than S keeps
    the last C positions, ring-aligned so slot = pos % C stays true."""
    C = cache.k.shape[1]
    dev = cache.k.device
    if S <= C:
        cache.k[:, :S] = k_all.to(cache.k.dtype)
        cache.v[:, :S] = v_all.to(cache.v.dtype)
        cache.pos[:, :S] = torch.arange(S, dtype=torch.int32, device=dev)
        return cache
    start = S - C
    roll = start % C
    cache.k.copy_(torch.roll(k_all[:, start:], roll, dims=1))
    cache.v.copy_(torch.roll(v_all[:, start:], roll, dims=1))
    cache.pos.copy_(torch.roll(
        torch.arange(start, S, dtype=torch.int32, device=dev), roll, dims=0))
    return cache


def decode_attention(q, cache: KVCache, cur_pos, window: Optional[int],
                     use_pallas: bool = False, dispatch=None):
    """q: [B, 1, H, hd] (rope'd at each row's ``cur_pos``, an int or
    [B]).  ``use_pallas`` routes through the flash-decode kernel."""
    B, _, H, hd = q.shape
    KV = cache.k.shape[2]
    G = H // KV
    cur = _row_positions(cur_pos, B, q.device)[:, None]
    valid = (cache.pos >= 0) & _window_mask(cache.pos, cur, window)
    if use_pallas:
        return dsp.flash_decode(q, cache.k, cache.v, valid, dispatch)
    qr = q.reshape(B, 1, KV, G, hd).to(torch.float32) * hd ** -0.5
    s = _gqa_scores(qr, cache.k.to(torch.float32))      # [B, KV, G, 1, C]
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    out = _gqa_out(torch.softmax(s, dim=-1), cache.v)
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# paged KV cache (shared page pool + per-request block tables)
# ---------------------------------------------------------------------------


class PagedKVCache(NamedTuple):
    """Shared KV page pool for one layer ([L, ...]-stacked outside).

    ``k`` / ``v``: [n_pages + 1, page_size, KV, hd] in the activation
    dtype, or int8 levels when the pool is quantized; ``kscale`` /
    ``vscale``: [n_pages + 1, page_size] float32 per-slot scales (zeros
    and unread for fp pools).  The last page is a write sink: the writes
    that ``repro`` scatters with ``mode="drop"`` (free slots, unallocated
    tail pages) land there, and no block table points at it, so no
    attention ever reads it.  :func:`pool_pages` gives the ``n_pages``
    pages proper.  Block tables and lengths live outside (one table per
    request, shared by every layer): see ``serve/engine.py``.
    """

    k: torch.Tensor
    v: torch.Tensor
    kscale: torch.Tensor
    vscale: torch.Tensor


def init_paged_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                    stacked: Optional[int] = None, quant: bool = False,
                    dtype=None, device=None) -> PagedKVCache:
    pre = (stacked,) if stacked else ()
    dt = torch.int8 if quant else (dtype or cfg.adtype)
    shape = pre + (n_pages + 1, page_size, cfg.n_kv_heads, cfg.hd)
    sshape = pre + (n_pages + 1, page_size)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        kscale=torch.zeros(sshape, dtype=torch.float32, device=device),
        vscale=torch.zeros(sshape, dtype=torch.float32, device=device),
    )


def layer_pool(pool: PagedKVCache, i: int) -> PagedKVCache:
    """Layer ``i`` of a stacked pool (views into the stacked arena)."""
    return PagedKVCache(pool.k[i], pool.v[i], pool.kscale[i],
                        pool.vscale[i])


def pool_pages(pool: PagedKVCache) -> PagedKVCache:
    """One layer's pool without its write-sink page: [n_pages, ...]."""
    n = pool.k.shape[0] - 1
    return PagedKVCache(pool.k[:n], pool.v[:n], pool.kscale[:n],
                        pool.vscale[:n])


def quantize_kv(x: torch.Tensor):
    """Deterministic symmetric int8 over the trailing [KV, hd] axes:
    scale = amax / 127 per token slot, round half to even, clip +-127 —
    so a requantized identical token is bit-identical."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=(-2, -1))
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    levels = torch.clamp(torch.round(xf / safe[..., None, None]), -127, 127)
    return levels.to(torch.int8), scale


def paged_write(pool: PagedKVCache, k_new, v_new, tables, positions,
                active) -> PagedKVCache:
    """Write one token per row (k_new / v_new: [B, 1, KV, hd]) into its
    table-mapped page at ``positions`` ([B]), in place.  Inactive rows
    and unallocated (-1) table entries write to the sink page."""
    sink, ps = pool.k.shape[0] - 1, pool.k.shape[1]
    P = tables.shape[1]
    pos = positions.to(torch.int64)
    pidx = torch.clamp(torch.div(pos, ps, rounding_mode="floor"), 0, P - 1)
    pids = tables.to(torch.int64).gather(1, pidx[:, None])[:, 0]
    pids = torch.where(active & (pids >= 0), pids, torch.full_like(pids, sink))
    offs = torch.remainder(pos, ps)
    kv_k, kv_v = k_new[:, 0], v_new[:, 0]             # [B, KV, hd]
    if pool.k.dtype == torch.int8:
        lk, sk = quantize_kv(kv_k)
        lv, sv = quantize_kv(kv_v)
        pool.k[pids, offs] = lk
        pool.v[pids, offs] = lv
        pool.kscale[pids, offs] = sk
        pool.vscale[pids, offs] = sv
    else:
        pool.k[pids, offs] = kv_k.to(pool.k.dtype)
        pool.v[pids, offs] = kv_v.to(pool.v.dtype)
    return pool


def paged_prefill_insert(pool: PagedKVCache, k_all, v_all,
                         page_ids) -> PagedKVCache:
    """Scatter one request's prefilled KV into the [L, ...]-stacked pool,
    in place.  k_all / v_all: [L, Cp, KV, hd] (Cp a page multiple);
    page_ids: [Cp / page_size] destinations in logical page order, the
    ``n_pages`` sentinel (the sink page) for unallocated tail pages."""
    L, Cp, KV, hd = k_all.shape
    ps = pool.k.shape[2]
    ids = page_ids.to(device=pool.k.device, dtype=torch.int64)
    kp = k_all.reshape(L, Cp // ps, ps, KV, hd)
    vp = v_all.reshape(L, Cp // ps, ps, KV, hd)
    if pool.k.dtype == torch.int8:
        lk, sk = quantize_kv(kp)
        lv, sv = quantize_kv(vp)
        pool.k[:, ids] = lk
        pool.v[:, ids] = lv
        pool.kscale[:, ids] = sk
        pool.vscale[:, ids] = sv
    else:
        pool.k[:, ids] = kp.to(pool.k.dtype)
        pool.v[:, ids] = vp.to(pool.v.dtype)
    return pool


def paged_decode_attention(q, pool: PagedKVCache, tables, lengths,
                           use_pallas: bool = False, dispatch=None):
    """Single-token attention against one layer's page pool (full causal:
    the engine gates paged serving to uniform full-window configs).  The
    paged-decode kernel (``use_pallas``) or the gather version; a
    length-0 row gives zeros either way."""
    p = pool_pages(pool)
    if use_pallas:
        return dsp.paged_decode(q, p.k, p.v, p.kscale, p.vscale, tables,
                                lengths, dispatch)
    return ref.paged_decode_ref(q, p.k, p.v, p.kscale, p.vscale, tables,
                                lengths)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def swiglu(x, p, dispatch=None):
    h = F.silu(matmul(x, p["w1"], dispatch)) * matmul(x, p["w3"], dispatch)
    return matmul(h, p["w2"], dispatch)


def gqa_project(x, p, cfg: ModelConfig, dispatch=None):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = matmul(x, p["wq"], dispatch).reshape(B, S, H, hd)
    k = matmul(x, p["wk"], dispatch).reshape(B, S, KV, hd)
    v = matmul(x, p["wv"], dispatch).reshape(B, S, KV, hd)
    return q, k, v


def attn_block_train(x, p, cfg: ModelConfig, window: int, positions,
                     dispatch=None):
    """Full-sequence attention block (prefill).  Returns (out, (k, v)).
    ``repro`` runs scanned stacks (every config) through
    ``chunked_attention`` whatever ``use_pallas`` says, so the port does
    too; its prefill flash kernel is not ported (ROADMAP queue 2)."""
    q, k, v = gqa_project(x, p, cfg, dispatch)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = chunked_attention(q, k, v, window=window, q_chunk=cfg.q_chunk)
    B, S = x.shape[:2]
    out = matmul(o.reshape(B, S, cfg.n_heads * cfg.hd), p["wo"], dispatch)
    return out, (k, v)


def attn_block_decode(x, p, cfg: ModelConfig, cache: KVCache, pos,
                      window: int, dispatch=None):
    """One decode token per row against a ring cache; ``pos`` is an int
    or [B] (each row at its own position)."""
    B = x.shape[0]
    q, k, v = gqa_project(x, p, cfg, dispatch)
    posv = _row_positions(pos, B, x.device)[:, None]
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    cache = cache_write(cache, k, v, posv[:, 0])
    o = decode_attention(q, cache, posv[:, 0], window,
                         use_pallas=cfg.use_pallas, dispatch=dispatch)
    out = matmul(o.reshape(B, 1, cfg.n_heads * cfg.hd), p["wo"], dispatch)
    return out, cache


def attn_block_decode_paged(x, p, cfg: ModelConfig, pool: PagedKVCache,
                            tables, positions, active, dispatch=None):
    """Decode attention block over the shared page pool, the whole slot
    batch at once: ``positions`` [B] (per-row rope phase) and ``active``
    [B] (pool writes of free slots go to the sink)."""
    q, k, v = gqa_project(x, p, cfg, dispatch)
    q = rope(q, positions[:, None], cfg.rope_theta)
    k = rope(k, positions[:, None], cfg.rope_theta)
    pool = paged_write(pool, k, v, tables, positions, active)
    lengths = torch.where(active, positions + 1,
                          torch.zeros_like(positions)).to(torch.int32)
    o = paged_decode_attention(q, pool, tables, lengths,
                               use_pallas=cfg.use_pallas, dispatch=dispatch)
    out = matmul(o.reshape(x.shape[0], 1, cfg.n_heads * cfg.hd), p["wo"],
                 dispatch)
    return out, pool
