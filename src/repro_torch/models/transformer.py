"""Dense decoder-only transformer (yi, stablelm, gemma3 backbones): a
port of ``repro.models.transformer``'s serving path.

Parameters are stacked on a leading [L] axis, as ``repro``'s scanned
stacks are, and a Python loop over the layers takes the place of
``lax.scan``; the per-layer attention window is a Python int.  A leaf of
the stack is a tensor or a compressed serving weight
(``serve.compressed.CompressedTensor``), sliced per layer the same way.
``loss_fn`` (LM training) waits for ROADMAP queue 1 item 13.
"""

from __future__ import annotations

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
    dense_init,
    embed,
    init_kv_cache,
    layer_cache,
    layer_pool,
    mlp_params,
    norm_params,
    rmsnorm,
    swiglu,
)


def _check_scanned(cfg: ModelConfig) -> None:
    if not cfg.scan_layers:
        raise NotImplementedError(
            "repro_torch runs stacked ([L, ...]) layer parameters only; "
            "scan_layers=False (and the prefill flash_attention_fwd kernel "
            "it reaches) is ROADMAP queue 1 item 13 / queue 2")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None):
    """Random weights from ``gen`` (drawn on the generator's device) on
    ``device`` (default cuda)."""
    _check_scanned(cfg)
    dev = resolve_device(device)
    L = cfg.n_layers
    layers = {
        "ln1": norm_params(cfg, L, dev),
        "attn": attn_params(gen, cfg, L, dev),
        "ln2": norm_params(cfg, L, dev),
        "mlp": mlp_params(gen, cfg, L, device=dev),
    }
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
    """Layer ``i`` of the stacked layer dict: tensors are indexed,
    compressed leaves sliced (``CompressedTensor.layer``)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return tree.layer(i)


def _apply_head(h, params, cfg: ModelConfig, dispatch=None):
    """LM head: ``h @ head`` (or ``h @ embed.T`` when tied); a compressed
    table's rows enumerate the vocab either way."""
    w = params["embed"] if cfg.tie_embeddings else params["head"]
    if not isinstance(w, torch.Tensor):
        return w.matmul(h, dispatch)
    return h @ (w.T if cfg.tie_embeddings else w)


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def apply_stack(params, h, positions, cfg: ModelConfig, dispatch=None,
                collect_kv: bool = False):
    """Runs all layers.  Returns (h, (k [L, B, S, KV, hd], v) | None)."""
    _check_scanned(cfg)
    ks, vs = [], []
    for i, w in enumerate(cfg.layer_windows()):
        lp = _layer(params["layers"], i)
        a, (k, v) = attn_block_train(rmsnorm(h, lp["ln1"]), lp["attn"], cfg,
                                     int(w), positions, dispatch)
        h = h + a
        h = h + swiglu(rmsnorm(h, lp["ln2"]), lp["mlp"], dispatch)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    return h, ((torch.stack(ks), torch.stack(vs)) if collect_kv else None)


def embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Returns (h, n_prefix): token embeddings with optional multimodal
    prefix embeddings prepended."""
    h = embed(batch["tokens"], params["embed"]).to(cfg.adtype)
    if "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(cfg.adtype)
        return torch.cat([pre, h], dim=1), pre.shape[1]
    return h, 0


def forward(params, batch: dict, cfg: ModelConfig, dispatch=None):
    """Full-sequence logits [B, S_total, V] float32."""
    h, _ = embed_inputs(params, batch, cfg)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    h, _ = apply_stack(params, h, positions, cfg, dispatch)
    h = rmsnorm(h, params["final_norm"])
    return _apply_head(h, params, cfg, dispatch).to(torch.float32)


def loss_fn(params, batch: dict, cfg: ModelConfig, dispatch=None):
    raise NotImplementedError(
        "the LM training loss is not ported to repro_torch yet: ROADMAP "
        "queue 1 item 13")


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------


def uniform_windows(cfg: ModelConfig) -> bool:
    return len(set(cfg.layer_windows())) == 1


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """[L]-stacked ring caches when every layer has the same window, else
    one cache per layer (their lengths differ)."""
    wins = cfg.layer_windows()
    if uniform_windows(cfg):
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
    positions = torch.arange(S, device=h.device).expand(B, S)
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
