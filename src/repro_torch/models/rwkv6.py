"""RWKV-6 "Finch" (arXiv:2404.05892): a port of ``repro.models.rwkv6``.

Attention-free: per head (head size N), with receptance r_t, key k_t,
value v_t, data-dependent decay w_t in (0, 1)^N and bonus u in R^N,

    out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

Training and prefill run ``repro``'s chunked form (``wkv6_chunked``):
within a chunk of 32 positions the recurrence is a masked quadratic form
with per-channel decays accumulated in log space, and the [N, N] state
is carried from chunk to chunk.  ``repro`` scans the chunks one at a
time; here the intra-chunk products of a group of chunks run as one
batch (the same formulas, element for element) and only the state carry
walks the chunks in order.  ``wkv6_ref`` is the sequential oracle.
Decode is the O(1) recurrence.

Every function takes and returns tensors on the parameters' device;
there are no kernels on this path (``repro`` has no Pallas kernel here
either).

``loss_fn(..., policy=)`` trains on the policy's model group, as
``repro`` places the leaves (``sharding.specs._rwkv_specs``): ``params``
are this rank's shards (``sharding.specs.shard_tree``); a leaf the group
does not divide stays whole.  The embedding and head are
vocab-parallel.  The time mix: ``wr`` / ``wk`` / ``wv`` / ``wg``
column-parallel after ``copy_in`` of the token-shift mixes, the decay
computed whole on every rank from its whole LoRA; where the group
divides the heads each rank runs the WKV and the group norm on its own
heads (``bonus``'s slice, the decay's and ``ln_x``'s through
``split_features``), else it gathers r / k / v whole, runs every head
and keeps its features after the norm; ``wo`` row-parallel, then
``reduce_out``.  The channel mix: ``ck`` column-, ``cv`` row-parallel
(``kk @ cv`` reduced), ``cr`` column-parallel with the gate gathered
whole (``gather_whole``), so the product is formed whole with no
collective in its backward.  The serving functions take no policy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import NO_SHARDING, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (dense_init, embed, remat, rmsnorm,
                                       unstack_layers)
from repro_torch.models.transformer import lm_loss
from repro_torch.sharding.collectives import (copy_in, copy_in_all,
                                              gather_whole, reduce_out,
                                              split_features)

#: elements of the largest per-group intra-chunk tensor (one float32
#: [chunks, B, H, c, c, N] decay table): bounds the chunks batched at once
GROUP_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random weights from ``gen`` on ``device`` (default cuda), in
    ``repro``'s tree: every layer leaf stacked on a leading [L] axis."""
    dev = resolve_device(device)
    d, L, ff = cfg.d_model, cfg.n_layers, cfg.d_ff
    N = cfg.ssm_head_dim
    H = d // N
    lora = max(32, N)
    pd = cfg.pdtype

    def full(shape, value, dtype=pd):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def w(shape, scale=None):
        return dense_init(gen, shape, pd, scale=scale, device=dev)

    layers = {
        "ln1": full((L, d), 0.0),
        "ln2": full((L, d), 0.0),
        # time-mix
        "mix_r": full((L, d), 0.5),
        "mix_k": full((L, d), 0.5),
        "mix_v": full((L, d), 0.5),
        "mix_w": full((L, d), 0.5),
        "mix_g": full((L, d), 0.5),
        "wr": w((L, d, d)),
        "wk": w((L, d, d)),
        "wv": w((L, d, d)),
        "wg": w((L, d, d)),
        "wo": w((L, d, d)),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": full((L, d), -2.0, torch.float32),
        "wA": w((L, d, lora)),
        "wB": w((L, lora, d), scale=0.01),
        "bonus": full((L, H, N), 0.0, torch.float32),
        "ln_x": full((L, d), 0.0),        # per-head groupnorm gain
        # channel-mix
        "cmix_k": full((L, d), 0.5),
        "cmix_r": full((L, d), 0.5),
        "ck": w((L, d, ff)),
        "cv": w((L, ff, d)),
        "cr": w((L, d, d)),
    }
    return {
        "embed": dense_init(gen, (cfg.vocab, d), pd, scale=1.0, device=dev),
        "layers": layers,
        "final_norm": full((d,), 0.0),
        "head": dense_init(gen, (d, cfg.vocab), pd, device=dev),
    }


# ---------------------------------------------------------------------------
# wkv6 core
# ---------------------------------------------------------------------------


def wkv6_ref(r, k, v, w, u):
    """Sequential oracle.  r, k, v, w: [B, S, H, N]; u: [H, N].  Returns
    out [B, S, H, N] float32."""
    B, S, H, N = r.shape
    state = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    uf = u.to(torch.float32)
    outs = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (x[:, t].to(torch.float32)
                              for x in (r, k, v, w))
        state, out = wkv6_decode(state, r_t, k_t, v_t, w_t, uf)
        outs.append(out)
    return torch.stack(outs, dim=1)


def _chunk_group(rc, kc, vc, lac, logwc, u):
    """Intra-chunk terms of a group of chunks, batched over its leading
    [n] axis: (r_t ⊙ A_{t-1} for the inter-chunk product, the intra-chunk
    output, each chunk's state decay exp(A_c) and its state increment).
    All [n, B, H, c, N] float32 but the last two ([n, B, H, N, 1] and
    [n, B, H, N, N])."""
    c = rc.shape[-2]
    la_prev = lac - logwc                             # logA_{t-1}
    r_dec = rc * torch.exp(la_prev)
    # decay[t, j, :] = exp(la_prev[t] - la[j]); strict lower triangle
    dec = torch.exp(torch.clamp(
        la_prev[..., :, None, :] - lac[..., None, :, :], -60.0, 0.0))
    scores = (rc[..., :, None, :] * dec * kc[..., None, :, :]).sum(-1)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=rc.device), diagonal=-1)
    scores = torch.where(tri, scores, torch.zeros_like(scores))
    intra = scores @ vc
    diag = (rc * u[:, None, :] * kc).sum(-1)
    intra = intra + diag[..., None] * vc
    # state update: S' = diag(A_c) S + sum_j (A_c / A_j) ⊙ k_j v_j^T
    a_c = lac[..., -1, :]                             # [n, B, H, N]
    k_dec = kc * torch.exp(torch.clamp(a_c[..., None, :] - lac, -60.0, 0.0))
    upd = k_dec.transpose(-1, -2) @ vc
    return r_dec, intra, torch.exp(a_c)[..., None], upd


def wkv6_chunked(r, k, v, w, u, chunk: int = 32,
                 return_state: bool = False):
    """Chunked parallel form of ``wkv6_ref`` (``repro``'s): decays
    clipped at 1e-38 before the log, log-decay differences clipped to
    [-60, 0], the sequence padded to whole chunks with decay 1 (the
    state passes the padding unchanged).  Returns out [B, S, H, N]
    float32, and the final state [B, H, N, N] with ``return_state``."""
    B, S, H, N = r.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nch = (S + pad) // c

    def chunks(t):                                    # [nch, B, H, c, N]
        return t.to(torch.float32).reshape(B, nch, c, H, N).permute(
            1, 0, 3, 2, 4)

    rr, kk, vv, ww = map(chunks, (r, k, v, w))
    logw = torch.log(torch.clamp(ww, min=1e-38))      # <= 0
    la = torch.cumsum(logw, dim=-2)                   # logA_t (inclusive)
    uf = u.to(torch.float32)
    group = max(1, GROUP_ELEMS // (B * H * c * c * N))
    state = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
    outs = []
    for g0 in range(0, nch, group):
        sl = slice(g0, g0 + group)
        r_dec, intra, decay, upd = _chunk_group(
            rr[sl], kk[sl], vv[sl], la[sl], logw[sl], uf)
        for i in range(r_dec.shape[0]):
            # inter-chunk: r_t ⊙ A_{t-1} @ S, then the carry
            outs.append(r_dec[i] @ state + intra[i])
            state = decay[i] * state + upd[i]
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        B, nch * c, H, N)[:, :S]
    return (out, state) if return_state else out


def wkv6_decode(state, r_t, k_t, v_t, w_t, u):
    """One step.  state: [B, H, N, N]; r / k / v / w: [B, H, N]."""
    kv = k_t[..., :, None] * v_t[..., None, :]
    out = (r_t[..., None, :] @ (state + u[..., None] * kv))[..., 0, :]
    return w_t[..., None] * state + kv, out


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _shift(x, x_prev):
    """x: [B, S, d] -> the previous-token tensor, x_prev at t = -1."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _group_norm(out, ln_x, d: int):
    """Per-head groupnorm of out [..., H, N] (float32), flattened to d
    and scaled by 1 + ln_x."""
    mean = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 1e-5)
    return out.reshape(*out.shape[:-2], d) * (1.0 + ln_x.to(torch.float32))


def _decay(xw, lp):
    """The data-dependent decay exp(-exp(w0 + tanh(x A) B)), float32."""
    dd = torch.tanh(xw.to(torch.float32) @ lp["wA"].to(torch.float32)) \
        @ lp["wB"].to(torch.float32)
    return torch.exp(-torch.exp(lp["w0"] + dd))


def _time_mix(h, lp, cfg: ModelConfig, x_prev, policy=None):
    """Returns (out, the last position's input, the final wkv state: of
    every head, or under a policy that splits the heads this rank's).
    ``policy``: on this rank's shards (the module's docstring); every
    collective is the identity where the group does not split
    ``d_model``."""
    B, S, d = h.shape
    N = cfg.ssm_head_dim
    H = d // N
    sh = _shift(h, x_prev)
    policy = policy or NO_SHARDING
    tp = policy if policy.splits(d) else NO_SHARDING
    straddle = tp.active and not tp.splits(H)

    def mx(m):
        return h + (sh - h) * lp[m].to(h.dtype)

    xr, xk, xv, xg = copy_in_all(
        [mx("mix_r"), mx("mix_k"), mx("mix_v"), mx("mix_g")], tp)
    r, k, v = xr @ lp["wr"], xk @ lp["wk"], xv @ lp["wv"]
    g = F.silu(xg @ lp["wg"])
    w = _decay(mx("mix_w"), lp)                       # whole, alike
    ln_x = lp["ln_x"]
    if straddle:
        # heads straddle ranks: every head on every rank, alike
        r, k, v = gather_whole(torch.stack([r, k, v]), tp).unbind(0)
    else:
        # whole heads a rank: its slice of the decay, bonus and gain
        w, ln_x = split_features(w, tp), split_features(ln_x, tp)
    Hl = r.shape[-1] // N
    r, k, v, w = (t.reshape(B, S, Hl, N) for t in (r, k, v, w))
    out, state = wkv6_chunked(r, k, v, w, lp["bonus"], return_state=True)
    out = _group_norm(out, ln_x, Hl * N)
    if straddle:
        out = split_features(out, tp)
    out = out.to(h.dtype) * g
    return reduce_out(out @ lp["wo"], tp), h[:, -1], state


def _channel_mix(h, lp, cfg: ModelConfig, x_prev, policy=None):
    """Under a policy: ``ck`` / ``cv`` split where the group divides
    ``d_ff``, ``cr`` where it divides ``d_model``."""
    sh = _shift(h, x_prev)
    xk = h + (sh - h) * lp["cmix_k"].to(h.dtype)
    xr = h + (sh - h) * lp["cmix_r"].to(h.dtype)
    policy = policy or NO_SHARDING
    ff = policy if policy.splits(cfg.d_ff) else NO_SHARDING
    col = policy if policy.splits(cfg.d_model) else NO_SHARDING
    if ff.active and col.active:
        xk, xr = copy_in_all([xk, xr], policy)
    else:
        xk, xr = copy_in(xk, ff), copy_in(xr, col)
    kv = reduce_out(torch.square(F.relu(xk @ lp["ck"])) @ lp["cv"], ff)
    r = gather_whole(torch.sigmoid(xr @ lp["cr"]), col)
    return r * kv, h[:, -1]


def _layer(h, lp, cfg: ModelConfig, policy=None):
    """One layer from zero shift states: (h, time-mix shift, channel-mix
    shift, wkv state)."""
    z = torch.zeros((h.shape[0], h.shape[2]), dtype=h.dtype, device=h.device)
    a, tm, state = _time_mix(rmsnorm(h, lp["ln1"]), lp, cfg, z, policy)
    h = h + a
    b, cm = _channel_mix(rmsnorm(h, lp["ln2"]), lp, cfg, z, policy)
    return h + b, tm, cm, state


def _layer_out(h, lp, cfg, policy=None):
    return _layer(h, lp, cfg, policy)[0]


def apply_stack(params, h, cfg: ModelConfig, policy=None):
    """All layers; under ``cfg.remat`` a forward that autograd records
    checkpoints each layer (its recompute replays the layer's
    collectives, on every rank of the group alike)."""
    checkpointed = cfg.remat and h.requires_grad
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        h = (remat(functools.partial(_layer_out, lp=lp, cfg=cfg,
                                     policy=policy), h)
             if checkpointed else _layer_out(h, lp, cfg, policy))
    return h


def loss_fn(params, batch: dict, cfg: ModelConfig, dispatch=None,
            loss_chunk: int = 1024, policy=None):
    """Next-token cross-entropy; returns (loss, {}) as ``repro``'s.
    ``dispatch`` is accepted for the family interface (nothing on this
    path dispatches).  ``policy``: on this rank's model shards (the
    module's docstring); the loss is the same on every rank of the
    group."""
    tokens = batch["tokens"]
    h = embed(tokens[:, :-1], params["embed"], policy,
              cfg.vocab).to(cfg.adtype)
    h = apply_stack(params, h, cfg, policy)
    return lm_loss(h, params, tokens[:, 1:], cfg, loss_chunk,
                   policy=policy), {}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class RWKVCache(NamedTuple):
    wkv: torch.Tensor       # [L, B, H, N, N] float32
    shift_tm: torch.Tensor  # [L, B, d]
    shift_cm: torch.Tensor  # [L, B, d]


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device=None) -> RWKVCache:
    dev = resolve_device(device)
    d, L = cfg.d_model, cfg.n_layers
    N = cfg.ssm_head_dim
    H = d // N
    return RWKVCache(
        wkv=torch.zeros((L, batch, H, N, N), dtype=torch.float32,
                        device=dev),
        shift_tm=torch.zeros((L, batch, d), dtype=cfg.adtype, device=dev),
        shift_cm=torch.zeros((L, batch, d), dtype=cfg.adtype, device=dev))


def prefill(params, batch: dict, cfg: ModelConfig, dispatch=None,
            max_len: Optional[int] = None):
    """Consume the prompt; return (last logits [B, V] float32,
    RWKVCache, n_consumed)."""
    h = embed(batch["tokens"], params["embed"]).to(cfg.adtype)
    S = h.shape[1]
    wkv, tm, cm = [], [], []
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        h, t, c, state = _layer(h, lp, cfg)
        wkv.append(state)
        tm.append(t)
        cm.append(c)
    cache = RWKVCache(torch.stack(wkv), torch.stack(tm), torch.stack(cm))
    hl = rmsnorm(h[:, -1], params["final_norm"])
    return (hl @ params["head"]).to(torch.float32), cache, S


def decode_step(params, cache: RWKVCache, token, pos, cfg: ModelConfig,
                dispatch=None):
    """One token per row (token [B]); ``pos`` is unused (the recurrence
    has no positions).  Returns (logits [B, V] float32, a new cache)."""
    h = embed(token[:, None], params["embed"]).to(cfg.adtype)
    B, _, d = h.shape
    N = cfg.ssm_head_dim
    H = d // N
    wkv, s1, s2 = [], [], []
    for i, lp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        st_tm, st_cm = cache.shift_tm[i], cache.shift_cm[i]
        x1 = rmsnorm(h, lp["ln1"])[:, 0]

        def mx(m):
            return x1 + (st_tm - x1) * lp[m].to(x1.dtype)

        r, k, v = ((mx(m) @ lp[wn]).reshape(B, H, N).to(torch.float32)
                   for m, wn in (("mix_r", "wr"), ("mix_k", "wk"),
                                 ("mix_v", "wv")))
        g = F.silu(mx("mix_g") @ lp["wg"])
        w = _decay(mx("mix_w"), lp).reshape(B, H, N)
        state, out = wkv6_decode(cache.wkv[i], r, k, v, w, lp["bonus"])
        out = _group_norm(out, lp["ln_x"], d).to(h.dtype) * g
        h = h + (out @ lp["wo"])[:, None]
        x2 = rmsnorm(h, lp["ln2"])[:, 0]
        xk = x2 + (st_cm - x2) * lp["cmix_k"].to(x2.dtype)
        xr = x2 + (st_cm - x2) * lp["cmix_r"].to(x2.dtype)
        kk = torch.square(F.relu(xk @ lp["ck"]))
        h = h + (torch.sigmoid(xr @ lp["cr"]) * (kk @ lp["cv"]))[:, None]
        wkv.append(state)
        s1.append(x1)
        s2.append(x2)
    new_cache = RWKVCache(torch.stack(wkv), torch.stack(s1), torch.stack(s2))
    h = rmsnorm(h, params["final_norm"])
    return (h[:, 0] @ params["head"]).to(torch.float32), new_cache
