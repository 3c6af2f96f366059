"""Mamba2 (SSD) blocks and the Zamba2 hybrid stack (arXiv:2411.15242): a
port of ``repro.models.zamba2``.

Mamba2 with a scalar decay per head:

    a_t = exp(dt_t * A_h)           (A_h < 0, dt_t = softplus(...))
    h_t = a_t h_{t-1} + (dt_t x_t) ⊗ B_t        h in R^{P x N} per head
    y_t = h_t C_t + D_h x_t

Training and prefill run ``repro``'s chunked SSD form (``ssd_chunked``,
chunks of 64: a masked quadratic form inside a chunk, the state carried
across chunks); as in ``rwkv6``, the intra-chunk products of a group of
chunks run as one batch and only the carry walks the chunks in order.
``ssd_ref`` is the sequential oracle; decode is the O(1) recurrence.

Zamba2: a stack of Mamba2 blocks and one *shared* attention + SwiGLU
block (one parameter set) applied before layers 0, ``attn_every``,
2 ``attn_every``, ... on concat(hidden, the embeddings) @ ``w_cat``,
its output projected back by ``w_back``.  Its window is static (one
Python int, ``repro``'s), so under ``cfg.use_pallas`` its prefill runs
the flash-attention kernel and its decode the flash-decode kernel.

``loss_fn(..., policy=)`` trains on the policy's model group, as
``repro`` places the leaves (``sharding.specs._zamba_specs``): ``params``
are this rank's shards; a leaf the group does not divide stays whole.
The mixer: ``w_z`` / ``w_x`` column-parallel by channel (with
``conv_x``, ``conv_bx`` and ``ln_y``), ``w_dt`` by head (with
``dt_bias``, ``A_log`` and ``D``); B and C computed whole on every
rank from their whole weights.  Where the group divides the heads each
rank runs the SSD on its own heads, B and C entering through
``copy_in``; else it gathers x whole, runs every head and keeps its
channels.  The gated norm over the split channels sums its mean square
over the group (:func:`group_rmsnorm`); ``w_out`` row-parallel, then
``reduce_out``.  The shared block: ``w_cat`` column-parallel, its
output gathered whole (``gather_whole``) for the attention and SwiGLU
under the policy (``layers``' dense blocks), ``w_back`` row-parallel on
its slice (``split_features``).  The embedding and head are
vocab-parallel.  The serving functions take no policy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import NO_SHARDING, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    KVCache,
    attn_block_decode,
    attn_block_train,
    attn_params,
    cache_prefill,
    dense_init,
    embed,
    init_kv_cache,
    layer_cache,
    mlp_params,
    norm_params,
    prompt_positions,
    remat,
    rmsnorm,
    swiglu,
    unstack_layers,
)
from repro_torch.models.rwkv6 import GROUP_ELEMS
from repro_torch.models.transformer import lm_loss
from repro_torch.sharding.collectives import (copy_in, copy_in_all,
                                              gather_whole, reduce_out,
                                              split_features)


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_decode(h, x_t, dt_t, A, B_t, C_t, D):
    """One step.  h: [Bt, H, P, N]; x_t: [Bt, H, P]; dt_t: [Bt, H];
    B_t, C_t: [Bt, N].  Returns (h, y [Bt, H, P])."""
    a_t = torch.exp(dt_t * A)
    upd = (x_t * dt_t[..., None])[..., :, None] * B_t[:, None, None, :]
    h = a_t[..., None, None] * h + upd
    y = (h @ C_t[:, None, :, None])[..., 0] + D[None, :, None] * x_t
    return h, y


def ssd_ref(x, dt, A, B, C, D):
    """Sequential oracle.  x: [Bt, S, H, P]; dt: [Bt, S, H]; A: [H] (< 0);
    B, C: [Bt, S, N]; D: [H].  Returns y [Bt, S, H, P] float32."""
    Bt, S, H, P = x.shape
    h = torch.zeros((Bt, H, P, B.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        h, y = ssd_decode(h, x[:, t].to(torch.float32),
                          dt[:, t].to(torch.float32), A,
                          B[:, t].to(torch.float32),
                          C[:, t].to(torch.float32), D)
        ys.append(y)
    return torch.stack(ys, dim=1)


def _ssd_group(xc, dtc, Bc, Cc, lac, D):
    """Intra-chunk terms of a group of chunks, batched over the leading
    [n] axis: (C_t exp(la_t), the intra-chunk output with the D skip,
    each chunk's state decay, its state increment)."""
    c = xc.shape[-2]
    # intra: scores[t, j] = (C_t . B_j) exp(la_t - la_j) dt_j, j <= t
    dec = torch.exp(torch.clamp(lac[..., :, None] - lac[..., None, :],
                                -60.0, 0.0))
    cb = Cc @ Bc.transpose(-1, -2)                    # [n, Bt, c, c]
    scores = cb[:, :, None] * dec * dtc[..., None, :]  # [n, Bt, H, t, j]
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xc.device))
    scores = torch.where(tri, scores, torch.zeros_like(scores))
    y = scores @ xc + D[:, None, None] * xc
    # state: h' = exp(la_c) h + sum_j exp(la_c - la_j) dt_j x_j ⊗ B_j
    la_c = lac[..., -1]                               # [n, Bt, H]
    wdec = torch.exp(torch.clamp(la_c[..., None] - lac, -60.0, 0.0)) * dtc
    upd = (xc * wdec[..., None]).transpose(-1, -2) @ Bc[:, :, None]
    c_dec = Cc[:, :, None] * torch.exp(lac)[..., None]  # [n, Bt, H, c, N]
    return c_dec, y, torch.exp(la_c)[..., None, None], upd


def ssd_chunked(x, dt, A, B, C, D, chunk: int = 64,
                return_state: bool = False):
    """Chunked SSD (``repro``'s form: log decays cumulated inside a
    chunk, differences clipped to [-60, 0], the sequence zero-padded to
    whole chunks).  Same arguments as ``ssd_ref``; returns y, and the
    final state [Bt, H, P, N] with ``return_state``."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B, C))
    nch = (S + pad) // c
    f32 = torch.float32
    xr = x.to(f32).reshape(Bt, nch, c, H, P).permute(1, 0, 3, 2, 4)
    dtr = dt.to(f32).reshape(Bt, nch, c, H).permute(1, 0, 3, 2)
    Br = B.to(f32).reshape(Bt, nch, c, N).transpose(0, 1)
    Cr = C.to(f32).reshape(Bt, nch, c, N).transpose(0, 1)
    # xr: [nch, Bt, H, c, P]; dtr: [nch, Bt, H, c]; Br / Cr: [nch, Bt, c, N]
    la = torch.cumsum(dtr * A[None, None, :, None], dim=-1)  # inclusive
    group = max(1, GROUP_ELEMS // (Bt * H * c * max(c, N)))
    h = torch.zeros((Bt, H, P, N), dtype=f32, device=x.device)
    ys = []
    for g0 in range(0, nch, group):
        sl = slice(g0, g0 + group)
        c_dec, y, decay, upd = _ssd_group(xr[sl], dtr[sl], Br[sl], Cr[sl],
                                          la[sl], D)
        for i in range(y.shape[0]):
            # inter: y_t += exp(la_t) * C_t h0, then the carry
            ys.append(c_dec[i] @ h.transpose(-1, -2) + y[i])
            h = decay[i] * h + upd[i]
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(
        Bt, nch * c, H, P)[:, :S]
    return (y, h) if return_state else y


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------


def mamba_params(gen, cfg: ModelConfig, stacked: Optional[int], device=None):
    """``repro``'s unpacked projections (separate z / x / B / C / dt
    weights and per-part conv filters), stacked on [L] when
    ``stacked``."""
    d = cfg.d_model
    din = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = din // cfg.ssm_head_dim
    K = cfg.ssm_conv
    pre = (stacked,) if stacked else ()
    pd = cfg.pdtype

    def w(shape, scale=None):
        return dense_init(gen, pre + shape, pd, scale=scale, device=device)

    def full(shape, value, dtype=pd):
        return torch.full(pre + shape, value, dtype=dtype, device=device)

    return {
        "ln": full((d,), 0.0),
        "w_z": w((d, din)),
        "w_x": w((d, din)),
        "w_B": w((d, N)),
        "w_C": w((d, N)),
        "w_dt": w((d, H)),
        "conv_x": w((K, din), scale=0.5),
        "conv_B": w((K, N), scale=0.5),
        "conv_C": w((K, N), scale=0.5),
        "conv_bx": full((din,), 0.0),
        "conv_bB": full((N,), 0.0),
        "conv_bC": full((N,), 0.0),
        "dt_bias": full((H,), 0.0, torch.float32),
        "A_log": full((H,), 0.0, torch.float32),     # A = -exp(A_log)
        "D": full((H,), 1.0, torch.float32),
        "ln_y": full((din,), 0.0),                    # gated norm
        "w_out": w((din, d)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: [B, S, C]; w: [K, C]."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return F.silu(y + b)


def group_rmsnorm(x, w, policy, n: int, eps: float = 1e-6):
    """``rmsnorm`` over ``n`` features the policy's model group splits:
    ``x`` [..., n / M] and ``w`` this rank's slices, the mean square
    from the group's summed squares (all-reduced both ways: the total
    feeds each rank's own features)."""
    xf = x.to(torch.float32)
    ss = reduce_out((xf * xf).sum(dim=-1, keepdim=True), policy)
    var = copy_in(ss, policy) / n
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(x.dtype)


def mamba_block(h, mp, cfg: ModelConfig, return_state: bool = False,
                policy=None):
    """Full-sequence Mamba2 block, h: [Bt, S, d].  Returns y, or (y, ssm
    state, conv state) with ``return_state``: the conv state is the last
    K - 1 pre-activation columns of [x | B | C].  ``policy``: on this
    rank's shards (the module's docstring; every collective the identity
    where the group does not split the channels, and no state returned
    where it does)."""
    Bt, S, d = h.shape
    din = cfg.ssm_expand * d
    P = cfg.ssm_head_dim
    H = din // P
    policy = policy or NO_SHARDING
    tp = policy if policy.splits(din) else NO_SHARDING
    if return_state and tp.active:
        raise ValueError("a split mamba block returns no state")
    straddle = tp.active and not tp.splits(H)
    hn = rmsnorm(h, mp["ln"])
    hc = copy_in(hn, tp)                              # column-parallel in
    z = hc @ mp["w_z"]
    x_raw = hc @ mp["w_x"]
    B_raw = hn @ mp["w_B"]
    C_raw = hn @ mp["w_C"]
    xs = _causal_conv(x_raw, mp["conv_x"], mp["conv_bx"])
    Bm = _causal_conv(B_raw, mp["conv_B"], mp["conv_bB"])
    Cm = _causal_conv(C_raw, mp["conv_C"], mp["conv_bC"])
    if straddle:
        # heads straddle ranks: every head on every rank, alike
        xs, dt = gather_whole(xs, tp), hn @ mp["w_dt"]
    else:
        # whole heads a rank: B and C read by every rank's heads
        Bm, Cm = copy_in_all([Bm, Cm], tp)
        dt = hc @ mp["w_dt"]
    dt = F.softplus(dt.to(torch.float32) + mp["dt_bias"])
    A = -torch.exp(mp["A_log"])
    y, ssm_state = ssd_chunked(xs.reshape(Bt, S, -1, P), dt, A, Bm, Cm,
                               mp["D"], return_state=True)
    y = y.reshape(Bt, S, -1)
    if straddle:
        y = split_features(y, tp)
    y = y.to(h.dtype) * F.silu(z)
    y = (group_rmsnorm(y, mp["ln_y"], tp, din) if tp.active
         else rmsnorm(y, mp["ln_y"]))
    y = reduce_out(y @ mp["w_out"], tp)
    if not return_state:
        return y
    K = cfg.ssm_conv
    raw = torch.cat([x_raw, B_raw, C_raw], dim=-1)
    return y, ssm_state, raw[:, -(K - 1):, :]


def mamba_decode(h1, mp, cfg: ModelConfig, ssm_state, conv_state):
    """One-token Mamba2.  h1: [Bt, 1, d]; conv_state: [Bt, K - 1, C].
    Returns (y [Bt, 1, d], ssm state, conv state)."""
    Bt = h1.shape[0]
    din = cfg.ssm_expand * cfg.d_model
    N = cfg.ssm_state
    P = cfg.ssm_head_dim
    H = din // P
    hn = rmsnorm(h1, mp["ln"])[:, 0]
    z = hn @ mp["w_z"]
    xbc = torch.cat([hn @ mp["w_x"], hn @ mp["w_B"], hn @ mp["w_C"]], dim=-1)
    dt = hn @ mp["w_dt"]
    window = torch.cat([conv_state, xbc[:, None]], dim=1)   # [Bt, K, C]
    conv_w = torch.cat([mp["conv_x"], mp["conv_B"], mp["conv_C"]], dim=-1)
    conv_b = torch.cat([mp["conv_bx"], mp["conv_bB"], mp["conv_bC"]])
    y_conv = (window.to(torch.float32)
              * conv_w.to(torch.float32)).sum(dim=1) + conv_b
    y_conv = F.silu(y_conv).to(h1.dtype)
    xs = y_conv[..., :din].reshape(Bt, H, P)
    Bm = y_conv[..., din:din + N]
    Cm = y_conv[..., din + N:]
    dtv = F.softplus(dt.to(torch.float32) + mp["dt_bias"])
    A = -torch.exp(mp["A_log"])
    ssm_state, y = ssd_decode(ssm_state, xs.to(torch.float32), dtv, A,
                              Bm.to(torch.float32), Cm.to(torch.float32),
                              mp["D"])
    y = y.reshape(Bt, din).to(h1.dtype)
    y = (rmsnorm(y * F.silu(z), mp["ln_y"]) @ mp["w_out"])[:, None]
    return y, ssm_state, window[:, 1:]


# ---------------------------------------------------------------------------
# zamba2 hybrid stack
# ---------------------------------------------------------------------------


def shared_apps(cfg: ModelConfig) -> list:
    """The layers the shared block runs before: 0, attn_every, ..."""
    return list(range(0, cfg.n_layers, cfg.attn_every)) \
        if cfg.attn_every > 0 else []


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random weights from ``gen`` on ``device`` (default cuda), in
    ``repro``'s tree (Mamba layers stacked on [L], one shared block)."""
    dev = resolve_device(device)
    d = cfg.d_model
    params = {
        "embed": dense_init(gen, (cfg.vocab, d), cfg.pdtype, scale=1.0,
                            device=dev),
        "layers": mamba_params(gen, cfg, cfg.n_layers, dev),
        "final_norm": norm_params(cfg, None, dev),
        "head": dense_init(gen, (d, cfg.vocab), cfg.pdtype, device=dev),
    }
    if cfg.attn_every > 0:
        params["shared"] = {
            "w_cat": dense_init(gen, (2 * d, d), cfg.pdtype, device=dev),
            "ln1": norm_params(cfg, None, dev),
            "attn": attn_params(gen, cfg, None, dev),
            "ln2": norm_params(cfg, None, dev),
            "mlp": mlp_params(gen, cfg, None, device=dev),
            "w_back": dense_init(gen, (d, d), cfg.pdtype, device=dev),
        }
    return params


def _shared_window(cfg: ModelConfig) -> int:
    return cfg.swa_pattern[0] if cfg.swa_pattern else -1


def _shared_block(h, h0, sp, cfg: ModelConfig, positions, dispatch=None,
                  policy=None):
    """Returns (h, (k, v)): the block's attention runs the prefill kernel
    under ``cfg.use_pallas`` (its window is static).  ``policy``: on
    this rank's shards (the module's docstring)."""
    tp = policy if policy is not None and policy.splits(cfg.d_model) \
        else NO_SHARDING
    x = torch.cat([h, h0], dim=-1)
    x = gather_whole(copy_in(x, tp) @ sp["w_cat"], tp)
    a, kv = attn_block_train(rmsnorm(x, sp["ln1"]), sp["attn"], cfg,
                             _shared_window(cfg), positions, dispatch,
                             static_window=True, policy=policy)
    x = x + a
    x = x + swiglu(rmsnorm(x, sp["ln2"]), sp["mlp"], dispatch, policy,
                   cfg.d_ff)
    return h + reduce_out(split_features(x, tp) @ sp["w_back"], tp), kv


def _shared_out(h, h0, sp, cfg, positions, dispatch, policy=None):
    return _shared_block(h, h0, sp, cfg, positions, dispatch, policy)[0]


def _mamba_layer(h, mp, cfg, policy=None):
    return h + mamba_block(h, mp, cfg, policy=policy)


def apply_stack(params, h, positions, cfg: ModelConfig, dispatch=None,
                policy=None):
    """The stack for training: the shared block before each of
    ``shared_apps``' layers, each Mamba layer residual.  Under
    ``cfg.remat`` a forward that autograd records checkpoints each Mamba
    layer and each shared-block application (a recompute replays its
    collectives, on every rank of the group alike)."""
    checkpointed = cfg.remat and h.requires_grad
    apps = set(shared_apps(cfg))
    h0 = h
    for i, mp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        if i in apps:
            fn = functools.partial(_shared_out, sp=params["shared"], cfg=cfg,
                                   positions=positions, dispatch=dispatch,
                                   policy=policy)
            h = remat(fn, h, h0) if checkpointed else fn(h, h0)
        layer = functools.partial(_mamba_layer, mp=mp, cfg=cfg,
                                  policy=policy)
        h = remat(layer, h) if checkpointed else layer(h)
    return h


def loss_fn(params, batch: dict, cfg: ModelConfig, dispatch=None,
            loss_chunk: int = 1024, policy=None):
    """Next-token cross-entropy; returns (loss, {}) as ``repro``'s.
    ``policy``: on this rank's model shards (the module's docstring); the
    loss is the same on every rank of the group."""
    tokens = batch["tokens"]
    h = embed(tokens[:, :-1], params["embed"], policy,
              cfg.vocab).to(cfg.adtype)
    B, S, _ = h.shape
    h = apply_stack(params, h, prompt_positions(B, S, h.device), cfg,
                    dispatch, policy)
    return lm_loss(h, params, tokens[:, 1:], cfg, loss_chunk, dispatch,
                   policy), {}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class ZambaCache(NamedTuple):
    ssm: torch.Tensor          # [L, Bt, H, P, N] float32
    conv: torch.Tensor         # [L, Bt, K - 1, C]
    attn: Optional[KVCache]    # stacked [n_apps, ...] or None


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> ZambaCache:
    dev = resolve_device(device)
    din = cfg.ssm_expand * cfg.d_model
    N, P, K = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv
    H = din // P
    apps = shared_apps(cfg)
    attn = (init_kv_cache(cfg, batch, _shared_window(cfg), max_len,
                          stacked=len(apps), device=dev) if apps else None)
    return ZambaCache(
        ssm=torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32,
                        device=dev),
        conv=torch.zeros((cfg.n_layers, batch, K - 1, din + 2 * N),
                         dtype=cfg.adtype, device=dev),
        attn=attn)


def prefill(params, batch: dict, cfg: ModelConfig, dispatch=None,
            max_len: Optional[int] = None):
    """Consume the prompt; return (last logits [B, V] float32,
    ZambaCache, n_consumed).  Under ``cfg.use_pallas`` each shared-block
    application launches ``flash_attention`` once."""
    h = embed(batch["tokens"], params["embed"]).to(cfg.adtype)
    B, S, _ = h.shape
    max_len = max_len or max(cfg.max_seq_len, S)
    positions = prompt_positions(B, S, h.device)
    apps = set(shared_apps(cfg))
    h0 = h
    ssm, conv, kvs = [], [], []
    for i, mp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        if i in apps:
            h, kv = _shared_block(h, h0, params["shared"], cfg, positions,
                                  dispatch)
            kvs.append(kv)
        y, ssm_s, conv_s = mamba_block(h, mp, cfg, return_state=True)
        h = h + y
        ssm.append(ssm_s)
        conv.append(conv_s)
    hl = rmsnorm(h[:, -1], params["final_norm"])
    logits = (hl @ params["head"]).to(torch.float32)
    attn = None
    if kvs:
        attn = init_kv_cache(cfg, B, _shared_window(cfg), max_len,
                             stacked=len(kvs), device=h.device)
        for j, (k, v) in enumerate(kvs):
            cache_prefill(layer_cache(attn, j), k, v, S)
    cache = ZambaCache(ssm=torch.stack(ssm),
                       conv=torch.stack(conv).to(cfg.adtype), attn=attn)
    return logits, cache, S


def decode_step(params, cache: ZambaCache, token, pos, cfg: ModelConfig,
                dispatch=None):
    """One token per row (token [B]) at ``pos`` (an int or [B]).  The
    shared block's ring caches are updated in place (under
    ``cfg.use_pallas`` its attention launches ``flash_decode`` once an
    application); returns (logits [B, V] float32, the cache with new SSM
    and conv states)."""
    h = embed(token[:, None], params["embed"]).to(cfg.adtype)
    h0 = h
    apps = shared_apps(cfg)
    sp = params.get("shared")
    ssm, conv = [], []
    for i, mp in enumerate(unstack_layers(params["layers"], cfg.n_layers)):
        if i in apps:
            x = torch.cat([h, h0], dim=-1) @ sp["w_cat"]
            a, _ = attn_block_decode(
                rmsnorm(x, sp["ln1"]), sp["attn"], cfg,
                layer_cache(cache.attn, apps.index(i)), pos,
                _shared_window(cfg), dispatch)
            x = x + a
            x = x + swiglu(rmsnorm(x, sp["ln2"]), sp["mlp"])
            h = h + x @ sp["w_back"]
        y, s_new, c_new = mamba_decode(h, mp, cfg, cache.ssm[i],
                                       cache.conv[i])
        h = h + y
        ssm.append(s_new)
        conv.append(c_new)
    new_cache = ZambaCache(ssm=torch.stack(ssm),
                           conv=torch.stack(conv).to(cfg.adtype),
                           attn=cache.attn)
    h = rmsnorm(h, params["final_norm"])
    return (h[:, 0] @ params["head"]).to(torch.float32), new_cache
