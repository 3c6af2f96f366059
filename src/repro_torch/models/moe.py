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

``loss_fn(..., policy=)`` trains on the ``model`` group, as ``repro``
does on its ``model`` axis: the attention, the dense / shared SwiGLUs,
the embedding and the head run tensor-parallel as the dense family's
(``models.layers``), and the experts are split over the group
(``sharding.specs._moe_specs``: axis 1 of the [nper, E, ...] stacks).
Tokens stay whole on every rank; each rank computes its experts'
contribution to every token (``_expert_compute_local`` with its
``e_start``), and the float32 partials are summed over the group before
the cast to the activation dtype (``_EPApply``, ``repro``'s
``_make_ep_apply``: one [T, d] all-reduce a MoE layer forward; its
hand-written backward, ``_expert_bwd_local``, sums dx and the routing
weights' gradient over the group and keeps the experts' own).  A
group that does not divide E leaves the experts whole on every rank
(``sanitize_spec``), and every rank runs the whole-E path.  The serving
functions take no policy (ROADMAP queue 1 item 12d).

Without a model group nothing in a loss reads a value back to the host,
so a training round captures as one CUDA graph; every scatter writes
each slot at most once, so the backward is deterministic.

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

from repro_torch.configs.base import ModelConfig, ShardingPolicy
from repro_torch.core.operators import top_k_indices
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
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
from repro_torch.models.transformer import lm_loss


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


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The expert products' accumulation dtype: float32 (float64 for
    float64 inputs, as a gradient check gives)."""
    return torch.promote_types(dtype, torch.float32)


def _slots(eids, e_start: int, E_loc: int, C: int):
    """(local, keep, slot): each assignment's buffer row ``le * C + pos``
    where it is kept, else the sink row ``E_loc * C`` that nothing
    reads."""
    _tok, local, keep, le, pos = _assignments(eids, e_start, E_loc, C)
    sink = E_loc * C
    return local, keep, torch.where(keep, le * C + pos,
                                    torch.full_like(le, sink))


def _experts_fwd(x2d, slot, w1, w3, w2, E_loc: int, C: int):
    """The experts' SwiGLUs on their capacity buffers: (buf [E_loc, C,
    d], pre1, pre3, h, o [E_loc * C + 1, d] with the sink's zero row
    last).  Each (expert, slot) receives at most one kept assignment;
    the rest write the sink row."""
    T = x2d.shape[0]
    K = slot.shape[0] // T
    d = x2d.shape[-1]
    acc = _acc(x2d.dtype)
    sink = E_loc * C
    # token t's row for each of its K assignments (assignments are
    # token-major), without a gather whose backward would add K rows
    rows = x2d[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = x2d.new_zeros((sink + 1, d)).index_put((slot,), rows)
    buf = buf[:sink].reshape(E_loc, C, d)
    pre1 = torch.bmm(buf, w1).to(acc)
    pre3 = torch.bmm(buf, w3).to(acc)
    h = F.silu(pre1) * pre3
    o = torch.bmm(h.to(x2d.dtype), w2).to(acc).reshape(sink, d)
    return buf, pre1, pre3, h, torch.cat([o, o.new_zeros((1, d))])


def _token_sum(rows, T: int, K: int):
    """[T * K, d] rows, token-major -> [T, d]: a token's K rows added in
    order."""
    rows = rows.reshape(T, K, -1)
    out = rows[:, 0]
    for j in range(1, K):
        out = out + rows[:, j]
    return out


def _expert_compute_local(x2d, eids, weights, w1, w3, w2, e_start: int,
                          E_loc: int, C: int):
    """Contribution of experts [e_start, e_start + E_loc) to every token
    ([T, d] float32) and the count of dropped assignments (``repro``'s
    function: ``w1`` / ``w3`` / ``w2`` are those experts' stacks)."""
    T, K = eids.shape
    local, keep, slot = _slots(eids, e_start, E_loc, C)
    o = _experts_fwd(x2d, slot, w1, w3, w2, E_loc, C)[-1]
    wk = torch.where(keep, weights.reshape(T * K),
                     torch.zeros_like(weights.reshape(T * K)))
    return _token_sum(o[slot] * wk[:, None], T, K), (local & ~keep).sum()


def _expert_bwd_local(x2d, eids, weights, w1, w3, w2, e_start: int,
                      E_loc: int, C: int, dout):
    """The hand-written VJP of :func:`_expert_compute_local` on one
    shard (``repro``'s): the forward's residuals recomputed from the
    inputs, then (dx2d partial [T, d], dweights partial [T, K], dw1,
    dw3, dw2), all float32.  The partials are this shard's experts'
    part of the gradients; the experts' gradients are whole."""
    T, K = eids.shape
    d = x2d.shape[-1]
    acc = _acc(x2d.dtype)
    sink = E_loc * C
    _local, keep, slot = _slots(eids, e_start, E_loc, C)
    buf, pre1, pre3, h, o = _experts_fwd(x2d, slot, w1, w3, w2, E_loc, C)
    dcontrib = dout.to(acc)[:, None, :].expand(T, K, d).reshape(T * K, d)
    wk = torch.where(keep, weights.reshape(T * K).to(acc),
                     torch.zeros((), dtype=acc, device=x2d.device))
    # contrib = o[slot] * w  =>  dw = <dout, o[slot]> where kept
    dweights = ((dcontrib * o[slot]).sum(dim=-1) * keep).reshape(T, K)
    do = dcontrib.new_zeros((sink + 1, d)).index_put(
        (slot,), dcontrib * wk[:, None])[:sink].reshape(E_loc, C, d)
    dh = torch.bmm(do, w2.to(acc).transpose(1, 2))
    dw2 = torch.bmm(h.to(x2d.dtype).to(acc).transpose(1, 2), do)
    sig = torch.sigmoid(pre1)
    dpre3 = dh * F.silu(pre1)
    dpre1 = dh * pre3 * (sig * (1 + pre1 * (1 - sig)))
    dbuf = (torch.bmm(dpre1, w1.to(acc).transpose(1, 2))
            + torch.bmm(dpre3, w3.to(acc).transpose(1, 2)))
    bw = buf.to(acc).transpose(1, 2)
    dw1 = torch.bmm(bw, dpre1)
    dw3 = torch.bmm(bw, dpre3)
    dbuf = torch.cat([dbuf.reshape(sink, d), dbuf.new_zeros((1, d))])
    return (_token_sum(dbuf[slot], T, K), dweights, dw1, dw3, dw2)


class _EPApply(torch.autograd.Function):
    """``repro``'s ``_make_ep_apply`` on the model group: this rank's
    experts' contribution to every token, the float32 partials summed
    over the group (and the dropped count, as an integer); backward,
    :func:`_expert_bwd_local` with dx and the routing weights' gradient
    summed over the group in float32, the experts' gradients kept on
    their rank, none for ``eids``.  It keeps only its inputs for the
    backward, as ``repro``'s residuals are its inputs."""

    @staticmethod
    def forward(ctx, x2d, eids, weights, w1, w3, w2, mesh, e_start, E_loc,
                C):
        out, dropped = _expert_compute_local(x2d, eids, weights, w1, w3,
                                             w2, e_start, E_loc, C)
        out = mesh.all_reduce_sum(out, over="model")
        dropped = mesh.all_reduce_sum(dropped.to(torch.int64),
                                      over="model")
        ctx.save_for_backward(x2d, eids, weights, w1, w3, w2)
        ctx.shard = (mesh, e_start, E_loc, C)
        ctx.mark_non_differentiable(dropped)
        return out, dropped

    @staticmethod
    def backward(ctx, dout, _ddropped):
        x2d, eids, weights, w1, w3, w2 = ctx.saved_tensors
        mesh, e_start, E_loc, C = ctx.shard
        dx, dwts, dw1, dw3, dw2 = _expert_bwd_local(
            x2d, eids, weights, w1, w3, w2, e_start, E_loc, C, dout)
        dx = mesh.all_reduce_sum(dx, over="model")
        dwts = mesh.all_reduce_sum(dwts, over="model")
        return (dx.to(x2d.dtype), None, dwts.to(weights.dtype),
                dw1.to(w1.dtype), dw3.to(w3.dtype), dw2.to(w2.dtype),
                None, None, None, None)


def ep_apply(x2d, eids, weights, w1, w3, w2, policy: ShardingPolicy,
             C: int):
    """The experts' output summed over the policy's model group, which
    splits them (``_EPApply``): ([T, d] float32, dropped, int64)."""
    E_loc = w1.shape[0]
    return _EPApply.apply(x2d, eids, weights, w1, w3, w2, policy.mesh,
                          policy.rank * E_loc, E_loc, C)


def moe_ffn(x, mp, cfg: ModelConfig, policy: Optional[ShardingPolicy] = None):
    """x: [B, S, d] -> ([B, S, d], {"aux_loss", "dropped"} as float32
    tensors).  Under a ``policy`` whose model group splits the E experts
    (``policy.ep_axis``, "model"), ``mp``'s expert stacks are this
    rank's E / M and the experts run expert-parallel (:func:`ep_apply`);
    the router is whole, so every rank routes alike, and the capacity
    comes from the global T and E.  Without one (or where the group does
    not divide E) every expert runs here."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    eids, w, aux = _route(x2d, mp["router"], cfg)
    E = cfg.n_experts
    C = _capacity(B * S * cfg.moe_top_k, E, cfg.capacity_factor)
    if policy is not None and policy.ep_axis is not None \
            and policy.splits(E):
        out, dropped = ep_apply(x2d, eids, w, mp["w1"], mp["w3"], mp["w2"],
                                policy, C)
    else:
        out, dropped = _expert_compute_local(x2d, eids, w, mp["w1"],
                                             mp["w3"], mp["w2"], 0, E, C)
    out = out.to(x.dtype)
    if cfg.shared_expert:
        out = out + swiglu(x2d, mp["shared"], None, policy,
                           cfg.dense_ff or cfg.d_ff)
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
            collect_kv: bool = False, policy=None):
    """One period: (h, aux, dropped, [(k, v)] per layer if collected).
    ``policy``: the attention and the dense SwiGLUs tensor-parallel, the
    experts expert-parallel (:func:`moe_ffn`)."""
    kvs = []
    for j, lp in enumerate(layers):
        a, kv = attn_block_train(rmsnorm(h, lp["ln1"]), lp["attn"], cfg,
                                 windows[j], positions, dispatch,
                                 policy=policy)
        h = h + a
        hn = rmsnorm(h, lp["ln2"])
        if j == len(layers) - 1:
            f, metrics = moe_ffn(hn, experts, cfg, policy)
        else:
            f = swiglu(hn, dense[j], None, policy, cfg.dense_ff or cfg.d_ff)
        h = h + f
        if collect_kv:
            kvs.append(kv)
    return h, metrics["aux_loss"], metrics["dropped"], kvs


def _period_out(h, layers, dense, experts, windows, positions, cfg,
                dispatch, policy=None):
    return _period(h, layers, dense, experts, windows, positions, cfg,
                   dispatch, policy=policy)[:3]


def apply_stack(params, h, positions, cfg: ModelConfig, dispatch=None,
                collect_kv: bool = False, policy=None):
    """The periods in order.  Returns (h, per-layer [(k, v)] or None,
    {"aux_loss": the periods' mean, "dropped": their sum}).  Under
    ``cfg.remat`` a forward that autograd records checkpoints each
    period, as ``repro`` checkpoints its scan body (its recompute
    replays the period's collectives, the experts' all-reduce among
    them, on every rank of the group alike)."""
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
                dispatch=dispatch, policy=policy), h)
        else:
            h, aux, dropped, kv = _period(h, layers, dense, experts,
                                          windows, positions, cfg, dispatch,
                                          collect_kv, policy)
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
    device tensors.  ``policy``: on this rank's model shards
    (``sharding.specs.shard_tree``), the module's docstring; the
    embedding and the head vocab-parallel.  The loss, ``aux_loss``
    (from the whole router) and ``dropped`` (the group's sum) are the
    same on every rank of the group."""
    tokens = batch["tokens"]
    h = embed(tokens[:, :-1], params["embed"], policy,
              cfg.vocab).to(cfg.adtype)
    B, S, _ = h.shape
    h, _, metrics = apply_stack(params, h,
                                prompt_positions(B, S, h.device), cfg,
                                dispatch, policy=policy)
    ce = lm_loss(h, params, tokens[:, 1:], cfg, loss_chunk, dispatch, policy)
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
