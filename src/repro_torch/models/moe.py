"""Mixture-of-Experts decoder (llama4-maverick, qwen3-moe): a port of
``repro.models.moe``.

Layers come in periods of ``moe_interleave``: the last layer of a period
routes its FFN to experts, the others run a dense SwiGLU (llama4: every
2nd layer MoE, top-1, plus a shared expert; qwen3: every layer MoE,
top-8).  Routing follows ``repro`` step for step: softmax router
probabilities, the top-k experts in ``lax.top_k``'s order (ties to the
lower expert index, ``core.operators.top_k_indices``), fixed-capacity
buffers filled by a stable sort of the assignments (``_assignments``;
the overflow is dropped and counted) and the experts' SwiGLUs as
batched matmuls over all E experts on this rank.

``repro``'s expert-parallel path (a nested ``shard_map`` over the
``model`` axis with a hand-written VJP) is ROADMAP queue 1 item 12 and
is refused (``moe_ffn``'s ``ep_axis``); its training path, ported here,
differentiates the local computation with plain autograd.  Nothing in a
loss reads a value back to the host, so a training round captures as
one CUDA graph; every scatter writes each slot at most once, so the
backward is deterministic.

The periods are scanned in ``repro`` (their windows are traced), so
prefill attention runs ``chunked_attention``; decode runs the
flash-decode kernel under ``cfg.use_pallas``.  The expert products
accumulate in float32 and, in bfloat16, round their result to bfloat16
where ``repro`` keeps it in float32 (``preferred_element_type``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.operators import top_k_indices
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    attn_block_decode,
    attn_block_train,
    attn_params,
    cache_prefill,
    chunked_ce,
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
from repro_torch.sharding.specs import PendingPort, refuse_model_axis


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _stack_init(gen, shape, dtype, device):
    """``dense_init`` of a stacked leaf, drawn one layer at a time in
    float32 and cast into the stack: a float32 draw of a whole expert
    stack would need 4 bytes a parameter at once (38.6 GB for
    qwen3-moe-30b-a3b's w1)."""
    if torch.device(device).type == "meta":
        return dense_init(gen, shape, dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = dense_init(gen, shape[1:], dtype, device=device)
    return out


def _expert_params(gen, cfg: ModelConfig, stacked: int, device):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": dense_init(gen, (stacked, d, E), torch.float32,
                             device=device),
        "w1": _stack_init(gen, (stacked, E, d, ff), cfg.pdtype, device),
        "w3": _stack_init(gen, (stacked, E, d, ff), cfg.pdtype, device),
        "w2": _stack_init(gen, (stacked, E, ff, d), cfg.pdtype, device),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_params(gen, cfg, stacked, d_ff=cfg.dense_ff,
                                 device=device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random weights from ``gen`` on ``device`` (default cuda), in
    ``repro``'s tree: attention and norms stacked on [L], the experts on
    [L / moe_interleave], the dense FFNs of the other layers on their
    own stack."""
    dev = resolve_device(device)
    L, P_ = cfg.n_layers, cfg.moe_interleave
    if L % P_:
        raise ValueError("n_layers must divide by moe_interleave")
    nper = L // P_
    layers = {
        "ln1": norm_params(cfg, L, dev),
        "attn": attn_params(gen, cfg, L, dev),
        "ln2": norm_params(cfg, L, dev),
        "moe": _expert_params(gen, cfg, nper, dev),
    }
    if P_ > 1:
        layers["dense_mlp"] = mlp_params(gen, cfg, L - nper,
                                         d_ff=cfg.dense_ff, device=dev)
    return {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                            scale=1.0, device=dev),
        "layers": layers,
        "final_norm": norm_params(cfg, None, dev),
        "head": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.pdtype,
                           device=dev),
    }


# ---------------------------------------------------------------------------
# routed FFN
# ---------------------------------------------------------------------------


def _capacity(n_assign: int, E: int, cf: float) -> int:
    return max(4, int(math.ceil(n_assign / E * cf)))


def _route(x2d, router, cfg: ModelConfig):
    """x2d: [T, d].  Returns (eids [T, K], weights [T, K] float32,
    the switch-style load-balance aux loss)."""
    probs = torch.softmax(x2d.to(torch.float32) @ router, dim=-1)
    eids = top_k_indices(probs, cfg.moe_top_k)
    w = torch.gather(probs, -1, eids)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    E = router.shape[-1]
    experts = torch.arange(E, device=eids.device)
    frac = (eids[..., None] == experts).to(torch.float32).sum(1).mean(0)
    aux = E * (frac * probs.mean(0)).sum()
    return eids, w, aux


def _assignments(eids, e_start: int, E_loc: int, C: int):
    """``repro``'s routing bookkeeping: each assignment's token, whether
    its expert is one of [e_start, e_start + E_loc), whether it is kept,
    and its local expert and capacity position (0 where not kept).
    Positions come from a stable sort of the assignments by local expert
    (the overflow bucket E_loc last), so an expert's first C assignments
    in token order are kept."""
    T, K = eids.shape
    A = T * K
    dev = eids.device
    flat_e = eids.reshape(A)
    tok_of = torch.div(torch.arange(A, device=dev), K, rounding_mode="floor")
    local = (flat_e >= e_start) & (flat_e < e_start + E_loc)
    le = torch.where(local, flat_e - e_start,
                     torch.full_like(flat_e, E_loc))
    le_sorted, order = torch.sort(le, stable=True)
    start_of = torch.searchsorted(le_sorted,
                                  torch.arange(E_loc + 1, device=dev))
    pos_sorted = torch.arange(A, device=dev) - start_of[le_sorted]
    pos = torch.zeros_like(pos_sorted).scatter(0, order, pos_sorted)
    keep = local & (pos < C)
    zero = torch.zeros_like(le)
    return (tok_of, local, keep, torch.where(keep, le, zero),
            torch.where(keep, pos, zero))


def _expert_compute_local(x2d, eids, weights, w1, w3, w2, e_start: int,
                          E_loc: int, C: int):
    """Contribution of experts [e_start, e_start + E_loc) to every token
    ([T, d] float32) and the count of dropped assignments.  Each (expert,
    slot) receives at most one kept assignment; the rest write a sink
    row that nothing reads, and a token's K contributions are added in
    order."""
    T, K = eids.shape
    d = x2d.shape[-1]
    _tok, local, keep, le, pos = _assignments(eids, e_start, E_loc, C)
    sink = E_loc * C
    slot = torch.where(keep, le * C + pos, torch.full_like(le, sink))
    # token t's row for each of its K assignments (assignments are
    # token-major), without a gather whose backward would add K rows
    rows = x2d[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = x2d.new_zeros((sink + 1, d)).index_put((slot,), rows)
    buf = buf[:sink].reshape(E_loc, C, d)
    h = F.silu(torch.bmm(buf, w1).to(torch.float32)) \
        * torch.bmm(buf, w3).to(torch.float32)
    o = torch.bmm(h.to(x2d.dtype), w2).to(torch.float32).reshape(sink, d)
    o = torch.cat([o, o.new_zeros((1, d))])
    wk = torch.where(keep, weights.reshape(T * K),
                     torch.zeros_like(weights.reshape(T * K)))
    contrib = (o[slot] * wk[:, None]).reshape(T, K, d)
    out = contrib[:, 0]
    for j in range(1, K):
        out = out + contrib[:, j]
    return out, (local & ~keep).sum()


def moe_ffn(x, mp, cfg: ModelConfig, ep_axis: Optional[str] = None):
    """x: [B, S, d] -> ([B, S, d], {"aux_loss", "dropped"} as float32
    tensors).  ``ep_axis`` (``repro``'s ``policy.ep_axis``, the expert
    parallel path over the ``model`` axis) is not ported."""
    if ep_axis is not None:
        raise PendingPort(
            "expert parallelism (ep_axis) is not ported to repro_torch "
            "yet: ROADMAP queue 1 item 12b")
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    eids, w, aux = _route(x2d, mp["router"], cfg)
    E = cfg.n_experts
    C = _capacity(B * S * cfg.moe_top_k, E, cfg.capacity_factor)
    out, dropped = _expert_compute_local(x2d, eids, w, mp["w1"], mp["w3"],
                                         mp["w2"], 0, E, C)
    out = out.to(x.dtype)
    if cfg.shared_expert:
        out = out + swiglu(x2d, mp["shared"])
    return out.reshape(B, S, d), {"aux_loss": aux,
                                  "dropped": dropped.to(torch.float32)}


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------


def _periods(params, cfg: ModelConfig) -> list:
    """Per period: (the period's P_ per-layer attention / norm trees, its
    P_ - 1 dense FFNs, its experts), each stacked leaf unbound once."""
    L, P_ = cfg.n_layers, cfg.moe_interleave
    nper = L // P_
    lay = params["layers"]
    per_layer = unstack_layers(
        {k: lay[k] for k in ("ln1", "attn", "ln2")}, L)
    dense = (unstack_layers(lay["dense_mlp"], L - nper) if P_ > 1 else [])
    experts = unstack_layers(lay["moe"], nper)
    return [(per_layer[p * P_:(p + 1) * P_],
             dense[p * (P_ - 1):(p + 1) * (P_ - 1)], experts[p])
            for p in range(nper)]


def _period(h, layers, dense, experts, windows, positions, cfg, dispatch,
            collect_kv: bool = False):
    """One period: (h, aux, dropped, [(k, v)] per layer if collected)."""
    kvs = []
    for j, lp in enumerate(layers):
        a, kv = attn_block_train(rmsnorm(h, lp["ln1"]), lp["attn"], cfg,
                                 windows[j], positions, dispatch)
        h = h + a
        hn = rmsnorm(h, lp["ln2"])
        if j == len(layers) - 1:
            f, metrics = moe_ffn(hn, experts, cfg)
        else:
            f = swiglu(hn, dense[j])
        h = h + f
        if collect_kv:
            kvs.append(kv)
    return h, metrics["aux_loss"], metrics["dropped"], kvs


def _period_out(h, layers, dense, experts, windows, positions, cfg,
                dispatch):
    return _period(h, layers, dense, experts, windows, positions, cfg,
                   dispatch)[:3]


def apply_stack(params, h, positions, cfg: ModelConfig, dispatch=None,
                collect_kv: bool = False):
    """The periods in order.  Returns (h, per-layer [(k, v)] or None,
    {"aux_loss": the periods' mean, "dropped": their sum}).  Under
    ``cfg.remat`` a forward that autograd records checkpoints each
    period, as ``repro`` checkpoints its scan body."""
    P_ = cfg.moe_interleave
    wins = [int(w) for w in cfg.layer_windows()]
    checkpointed = cfg.remat and h.requires_grad and not collect_kv
    auxs, drops, kvs = [], [], []
    for p, (layers, dense, experts) in enumerate(_periods(params, cfg)):
        windows = wins[p * P_:(p + 1) * P_]
        if checkpointed:
            h, aux, dropped = remat(functools.partial(
                _period_out, layers=layers, dense=dense, experts=experts,
                windows=windows, positions=positions, cfg=cfg,
                dispatch=dispatch), h)
        else:
            h, aux, dropped, kv = _period(h, layers, dense, experts,
                                          windows, positions, cfg, dispatch,
                                          collect_kv)
            kvs += kv
        auxs.append(aux)
        drops.append(dropped)
    metrics = {"aux_loss": torch.stack(auxs).mean(),
               "dropped": torch.stack(drops).sum()}
    return h, (kvs if collect_kv else None), metrics


def loss_fn(params, batch: dict, cfg: ModelConfig, dispatch=None,
            loss_chunk: int = 1024, policy=None):
    """Next-token cross-entropy plus ``router_aux_weight`` times the
    load-balance loss.  Returns (loss, {"aux_loss", "dropped"}), both
    device tensors."""
    if policy is not None:
        refuse_model_axis(cfg.family, policy.size)
    tokens = batch["tokens"]
    h = embed(tokens[:, :-1], params["embed"]).to(cfg.adtype)
    B, S, _ = h.shape
    h, _, metrics = apply_stack(params, h,
                                prompt_positions(B, S, h.device), cfg,
                                dispatch)
    h = rmsnorm(h, params["final_norm"])
    ce = chunked_ce(h, params["head"], tokens[:, 1:], loss_chunk,
                    cfg.remat and h.requires_grad)
    return ce + cfg.router_aux_weight * metrics["aux_loss"], metrics


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """[L]-stacked ring caches (every layer at the first layer's window,
    ``repro``'s rule)."""
    return init_kv_cache(cfg, batch, cfg.layer_windows()[0], max_len,
                         stacked=cfg.n_layers, device=resolve_device(device))


def prefill(params, batch: dict, cfg: ModelConfig, dispatch=None,
            max_len: Optional[int] = None):
    """Consume the prompt; return (last logits [B, 1, V] float32, cache,
    n_consumed)."""
    h = embed(batch["tokens"], params["embed"]).to(cfg.adtype)
    B, S, _ = h.shape
    max_len = max_len or max(cfg.max_seq_len, S)
    h, kvs, _ = apply_stack(params, h, prompt_positions(B, S, h.device),
                            cfg, dispatch, collect_kv=True)
    hl = rmsnorm(h[:, -1:], params["final_norm"])
    logits = (hl @ params["head"]).to(torch.float32)
    cache = init_cache(cfg, B, max_len, device=h.device)
    for i, (k, v) in enumerate(kvs):
        cache_prefill(layer_cache(cache, i), k, v, S)
    return logits, cache, S


def decode_step(params, cache, token, pos, cfg: ModelConfig, dispatch=None):
    """One token per row (token [B]) at ``pos`` (an int or [B]); the
    cache is updated in place (under ``cfg.use_pallas`` each layer's
    attention launches ``flash_decode`` once).  Returns (logits [B, V]
    float32, cache)."""
    h = embed(token[:, None], params["embed"]).to(cfg.adtype)
    wins = cfg.layer_windows()
    for p, (layers, dense, experts) in enumerate(_periods(params, cfg)):
        for j, lp in enumerate(layers):
            i = p * cfg.moe_interleave + j
            a, _ = attn_block_decode(rmsnorm(h, lp["ln1"]), lp["attn"], cfg,
                                     layer_cache(cache, i), pos,
                                     int(wins[i]), dispatch)
            h = h + a
            hn = rmsnorm(h, lp["ln2"])
            if j == len(layers) - 1:
                f, _ = moe_ffn(hn, experts, cfg)
            else:
                f = swiglu(hn, dense[j])
            h = h + f
    h = rmsnorm(h, params["final_norm"])
    return (h[:, 0] @ params["head"]).to(torch.float32), cache
