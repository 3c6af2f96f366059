"""Dense decoder-only transformer (yi, stablelm, gemma3 backbones): a
port of ``repro.models.transformer``.

Two layouts, as in ``repro``: with ``cfg.scan_layers`` (every config's
default) the layer parameters are stacked on a leading [L] axis, and a
Python loop over the layers takes the place of ``lax.scan``; without it
``params["layers"]`` is a list of L per-layer dicts with 2-D leaves, and
prefill under ``cfg.use_pallas`` runs the flash-attention kernel
(``models.layers.attn_block_train``).  Either way the per-layer
attention window is a Python int, so gemma3's 5:1 local / global pattern
runs each layer at its own window.  A leaf is a tensor or a compressed
serving weight (``serve.compressed.CompressedTensor``); a stacked one is
sliced per layer the same way.

Training (``loss_fn``) differentiates through the stack: each stacked
tensor is unbound into its layers once per forward, so autograd stacks
the layers' gradients once (indexing ``w[i]`` per layer would write a
full-size zero gradient of the stack for every layer).  With
``cfg.remat`` each layer and each chunk of the LM head runs under
``torch.utils.checkpoint``, ``jax.checkpoint``'s counterpart: their
activations are recomputed in the backward instead of kept.  The
flash-attention kernel has no backward, in ``repro`` as here: on an
unscanned stack under ``use_pallas`` the loss evaluates but does not
differentiate.

``loss_fn(..., policy=)`` trains tensor-parallel: ``params`` are this
rank's slices (``sharding.specs.shard_tree``) and the blocks run
column- / row-parallel over the policy's model group
(``models.layers``), the embedding and the head (the tied embedding's
transpose, or ``head``) vocab-parallel.  Multimodal prefix embeddings
are whole on every rank.  The serving functions take no policy.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (
    attn_block_decode,
    attn_block_decode_paged,
    attn_block_train,
    attn_params,
    cache_prefill,
    chunked_ce,
    dense_init,
    embed,
    init_kv_cache,
    layer_cache,
    layer_pool,
    mlp_params,
    norm_params,
    prompt_positions,
    remat,
    rmsnorm,
    swiglu,
    unstack_layers,
)
from repro_torch.sharding.collectives import copy_in


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random weights from ``gen`` (drawn on the generator's device) on
    ``device`` (default cuda): layers stacked on [L] with
    ``cfg.scan_layers``, else a list of L per-layer dicts."""
    dev = resolve_device(device)

    def block(L):
        return {
            "ln1": norm_params(cfg, L, dev),
            "attn": attn_params(gen, cfg, L, dev),
            "ln2": norm_params(cfg, L, dev),
            "mlp": mlp_params(gen, cfg, L, device=dev),
        }

    layers = (block(cfg.n_layers) if cfg.scan_layers
              else [block(None) for _ in range(cfg.n_layers)])
    params = {
        "embed": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.pdtype,
                            scale=1.0, device=dev),
        "layers": layers,
        "final_norm": norm_params(cfg, None, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                    cfg.pdtype, device=dev)
    return params


def _layer(tree, i: int):
    """Layer ``i`` of the layers: an entry of the per-layer list, or of
    the stacked dict (tensors indexed, compressed leaves sliced with
    ``CompressedTensor.layer``)."""
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree.layer(i)


def _vocab_policy(cfg: ModelConfig, policy):
    """The policy where its model group splits the vocab, else None."""
    if policy is not None and policy.splits(cfg.vocab):
        return policy
    return None


def _apply_head(h, params, cfg: ModelConfig, dispatch=None, policy=None):
    """LM head: ``h @ head`` (or ``h @ embed.T`` when tied); a compressed
    table's rows enumerate the vocab either way.  Under a ``policy``
    that splits the vocab: this rank's slice of the logits (``h``
    enters the column-parallel region)."""
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    if not isinstance(w, torch.Tensor):
        return w.matmul(h, dispatch)
    if _vocab_policy(cfg, policy) is not None:
        h = copy_in(h, policy)
    return h @ (w.T if cfg.tie_embeddings else w)


def lm_loss(h, params, labels, cfg: ModelConfig, loss_chunk: int,
            dispatch=None, policy=None, n_prefix: int = 0):
    """The final norm and the mean next-token cross-entropy of final
    hidden states h [B, S, d] against ``labels``, every family's: the LM
    head (:func:`_apply_head`) applied in sequence chunks of
    ``loss_chunk`` (``layers.chunked_ce``; under ``cfg.remat`` each
    chunk is checkpointed), vocab-parallel where the policy's model
    group divides the vocab.  The first ``n_prefix`` positions (prefix
    embeddings, context only) are left out."""
    h = rmsnorm(h, params["final_norm"])
    if n_prefix:
        h = h[:, n_prefix:]
    head = functools.partial(_apply_head, params=params, cfg=cfg,
                             dispatch=dispatch, policy=policy)
    return chunked_ce(h, head, labels, loss_chunk,
                      cfg.remat and h.requires_grad,
                      _vocab_policy(cfg, policy))


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _layer_fwd(h, lp, window: int, positions, cfg: ModelConfig, dispatch,
               policy=None):
    """One layer: (h, (k, v))."""
    a, kv = attn_block_train(rmsnorm(h, lp["ln1"]), lp["attn"], cfg,
                             window, positions, dispatch,
                             static_window=not cfg.scan_layers,
                             policy=policy)
    h = h + a
    h = h + swiglu(rmsnorm(h, lp["ln2"]), lp["mlp"], dispatch, policy,
                   cfg.d_ff)
    return h, kv


def _layer_out(h, lp, window, positions, cfg, dispatch, policy=None):
    return _layer_fwd(h, lp, window, positions, cfg, dispatch, policy)[0]


def apply_stack(params, h, positions, cfg: ModelConfig, dispatch=None,
                collect_kv: bool = False, policy=None):
    """Runs all layers.  Returns (h, (ks, vs) | None): per-layer lists of
    k, v [B, S, KV, hd].  Under ``cfg.remat``, a forward that autograd
    records checkpoints each layer (its recompute replays the layer's
    collectives, on every rank of the group alike)."""
    layers = unstack_layers(params["layers"], cfg.n_layers)
    checkpointed = cfg.remat and h.requires_grad and not collect_kv
    ks, vs = [], []
    for lp, w in zip(layers, cfg.layer_windows()):
        if checkpointed:
            h = remat(functools.partial(
                _layer_out, lp=lp, window=int(w), positions=positions,
                cfg=cfg, dispatch=dispatch, policy=policy), h)
            continue
        h, (k, v) = _layer_fwd(h, lp, int(w), positions, cfg, dispatch,
                               policy)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return h, ((ks, vs) if collect_kv else None)


def embed_inputs(params, batch: dict, cfg: ModelConfig, policy=None):
    """Returns (h, n_prefix): token embeddings with optional multimodal
    prefix embeddings prepended (whole on every rank)."""
    h = embed(batch["tokens"], params["embed"], policy,
              cfg.vocab).to(cfg.adtype)
    if "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(cfg.adtype)
        return torch.cat([pre, h], dim=1), pre.shape[1]
    return h, 0


def forward(params, batch: dict, cfg: ModelConfig, dispatch=None):
    """Full-sequence logits [B, S_total, V] float32."""
    h, _ = embed_inputs(params, batch, cfg)
    B, S, _ = h.shape
    positions = prompt_positions(B, S, h.device)
    h, _ = apply_stack(params, h, positions, cfg, dispatch)
    h = rmsnorm(h, params["final_norm"])
    return _apply_head(h, params, cfg, dispatch).to(torch.float32)


def loss_fn(params, batch: dict, cfg: ModelConfig, dispatch=None,
            loss_chunk: int = 1024, policy=None):
    """Next-token cross-entropy over the token segment (prefix
    embeddings are context only), ``repro``'s ``loss_fn``.  The LM head
    is applied in sequence chunks of ``loss_chunk`` so the [B, S, V]
    float32 logits are never formed whole; under ``cfg.remat`` each
    chunk is checkpointed, so its logits are not kept for the backward
    either.  ``policy``: tensor-parallel over its model group (the
    module's docstring); the loss is the same on every rank of the
    group.  Returns (loss, {"ntokens": B * S})."""
    tokens = batch["tokens"]                          # [B, S + 1]
    inp = {**batch, "tokens": tokens[:, :-1]}
    labels = tokens[:, 1:].to(torch.int64)
    h, n_prefix = embed_inputs(params, inp, cfg, policy)
    B, S, _ = h.shape
    positions = prompt_positions(B, S, h.device)
    h, _ = apply_stack(params, h, positions, cfg, dispatch, policy=policy)
    loss = lm_loss(h, params, labels, cfg, loss_chunk, dispatch, policy,
                   n_prefix)
    return loss, {"ntokens": B * (S - n_prefix)}


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def uniform_windows(cfg: ModelConfig) -> bool:
    return len(set(cfg.layer_windows())) == 1


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """[L]-stacked ring caches for a scanned stack whose layers share one
    window, else one cache per layer (``repro``'s rule)."""
    wins = cfg.layer_windows()
    if uniform_windows(cfg) and cfg.scan_layers:
        return init_kv_cache(cfg, batch, wins[0], max_len,
                             stacked=cfg.n_layers, device=device)
    return [init_kv_cache(cfg, batch, w, max_len, device=device)
            for w in wins]


def prefill(params, batch: dict, cfg: ModelConfig, dispatch=None,
            max_len: Optional[int] = None):
    """Consume the prompt; return (last_token_logits [B, 1, V], cache,
    n_consumed)."""
    h, _ = embed_inputs(params, batch, cfg)
    B, S, _ = h.shape
    max_len = max_len or max(cfg.max_seq_len, S)
    positions = prompt_positions(B, S, h.device)
    h, (ks, vs) = apply_stack(params, h, positions, cfg, dispatch,
                              collect_kv=True)
    hl = rmsnorm(h[:, -1:], params["final_norm"])
    logits = _apply_head(hl, params, cfg, dispatch).to(torch.float32)
    cache = init_cache(cfg, B, max_len, device=h.device)
    for i in range(cfg.n_layers):
        cache_prefill(layer_cache(cache, i), ks[i], vs[i], S)
    return logits, cache, S


def decode_step(params, cache, token: torch.Tensor, pos, cfg: ModelConfig,
                dispatch=None):
    """One decode step.  token: [B] int; pos: the global position, an int
    or [B] (each row at its own).  Updates ``cache`` in place and returns
    (logits [B, V] float32, cache)."""
    h = embed(token[:, None], params["embed"]).to(cfg.adtype)
    for i, w in enumerate(cfg.layer_windows()):
        lp = _layer(params["layers"], i)
        a, _ = attn_block_decode(rmsnorm(h, lp["ln1"]), lp["attn"], cfg,
                                 layer_cache(cache, i), pos, int(w),
                                 dispatch)
        h = h + a
        h = h + swiglu(rmsnorm(h, lp["ln2"]), lp["mlp"], dispatch)
    h = rmsnorm(h, params["final_norm"])
    logits = _apply_head(h[:, 0], params, cfg, dispatch).to(torch.float32)
    return logits, cache


def decode_step_paged(params, pool, tables, tokens: torch.Tensor,
                      positions: torch.Tensor, active: torch.Tensor,
                      cfg: ModelConfig, dispatch=None):
    """One decode step over the shared KV page pool, the whole slot batch
    at once.  tokens / positions / active: [B]; pool: ``PagedKVCache``
    stacked [L, ...] (updated in place); tables: [B, P] block tables
    shared by every layer.  Returns (logits [B, V] float32, pool).
    Paged serving needs uniform windows and stacked layers."""
    if not (uniform_windows(cfg) and cfg.scan_layers):
        raise ValueError("paged decode requires uniform windows and "
                         "scanned layers")
    h = embed(tokens[:, None], params["embed"]).to(cfg.adtype)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        a, _ = attn_block_decode_paged(
            rmsnorm(h, lp["ln1"]), lp["attn"], cfg, layer_pool(pool, i),
            tables, positions, active, dispatch)
        h = h + a
        h = h + swiglu(rmsnorm(h, lp["ln2"]), lp["mlp"], dispatch)
    h = rmsnorm(h, params["final_norm"])
    logits = _apply_head(h[:, 0], params, cfg, dispatch).to(torch.float32)
    return logits, pool
