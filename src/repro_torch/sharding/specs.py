"""Per-architecture parameter specs for the tensor-parallel ``model``
axis (a port of ``repro.sharding.specs``).

A spec is a plain tuple with one entry per leading dimension of its
leaf: ``None`` (not sharded), ``"model"`` or a tuple of axis names;
dimensions past the tuple's length are not sharded.  Conventions
(megatron-style), as in ``repro``: column-parallel weights shard their
out-features (``"model"`` on the last dim), row-parallel ones their
in-features, embeddings the vocab.

The port runs no tensor parallelism yet (ROADMAP queue 1 item 12), but
the specs still decide which axis every leaf is compressed along
(``core.distributed._pick_axis`` keeps Top_k off the ``model`` axis), and
so the wire bits.  ``repro``'s ``activation_policy`` has no counterpart:
the port's model places nothing.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def is_spec(z) -> bool:
    """Leaf test for spec trees: a spec tuple or ``None``."""
    return z is None or isinstance(z, tuple)


def _dense_layer_specs(cfg: ModelConfig, L: bool = True):
    pre = (None,) if L else ()
    return {
        "ln1": (*pre, None),
        "ln2": (*pre, None),
        "attn": {
            "wq": (*pre, None, "model"),
            "wk": (*pre, None, "model"),
            "wv": (*pre, None, "model"),
            "wo": (*pre, "model", None),
        },
        "mlp": {
            "w1": (*pre, None, "model"),
            "w3": (*pre, None, "model"),
            "w2": (*pre, "model", None),
        },
    }


def _moe_specs(cfg: ModelConfig):
    lay = {
        "ln1": (None, None),
        "ln2": (None, None),
        "attn": {
            "wq": (None, None, "model"),
            "wk": (None, None, "model"),
            "wv": (None, None, "model"),
            "wo": (None, "model", None),
        },
        "moe": {
            "router": (None, None, None),
            "w1": (None, "model", None, None),   # experts over 'model'
            "w3": (None, "model", None, None),
            "w2": (None, "model", None, None),
        },
    }
    if cfg.shared_expert:
        lay["moe"]["shared"] = {
            "w1": (None, None, "model"),
            "w3": (None, None, "model"),
            "w2": (None, "model", None),
        }
    if cfg.moe_interleave > 1:
        lay["dense_mlp"] = {
            "w1": (None, None, "model"),
            "w3": (None, None, "model"),
            "w2": (None, "model", None),
        }
    return lay


def _rwkv_specs(cfg: ModelConfig):
    v = {
        "ln1": (None, None), "ln2": (None, None),
        "mix_r": (None, None), "mix_k": (None, None),
        "mix_v": (None, None), "mix_w": (None, None),
        "mix_g": (None, None),
        "wr": (None, None, "model"),
        "wk": (None, None, "model"),
        "wv": (None, None, "model"),
        "wg": (None, None, "model"),
        "wo": (None, "model", None),
        "w0": (None, None),
        "wA": (None, None, None),
        "wB": (None, None, None),
        "bonus": (None, "model", None),   # heads over model
        "ln_x": (None, None),
        "cmix_k": (None, None), "cmix_r": (None, None),
        "ck": (None, None, "model"),
        "cv": (None, "model", None),
        "cr": (None, None, "model"),
    }
    return v


def _zamba_specs(cfg: ModelConfig):
    lay = {
        "ln": (None, None),
        "w_z": (None, None, "model"),
        "w_x": (None, None, "model"),
        "w_B": (None, None, None),
        "w_C": (None, None, None),
        "w_dt": (None, None, "model"),
        "conv_x": (None, None, "model"),
        "conv_B": (None, None, None),
        "conv_C": (None, None, None),
        "conv_bx": (None, "model"),
        "conv_bB": (None, None),
        "conv_bC": (None, None),
        "dt_bias": (None, "model"),
        "A_log": (None, "model"),
        "D": (None, "model"),
        "ln_y": (None, "model"),
        "w_out": (None, "model", None),
    }
    shared = {
        "w_cat": (None, "model"),
        "ln1": (None,),
        "attn": {
            "wq": (None, "model"), "wk": (None, "model"),
            "wv": (None, "model"), "wo": ("model", None),
        },
        "ln2": (None,),
        "mlp": {
            "w1": (None, "model"), "w3": (None, "model"),
            "w2": ("model", None),
        },
        "w_back": ("model", None),
    }
    return lay, shared


def param_specs(cfg: ModelConfig):
    """Spec tree matching the family's ``init_params`` structure."""
    if cfg.family == "dense":
        specs = {
            "embed": ("model", None),
            "layers": _dense_layer_specs(cfg),
            "final_norm": (None,),
        }
        if not cfg.tie_embeddings:
            specs["head"] = (None, "model")
        return specs
    if cfg.family == "moe":
        return {
            "embed": ("model", None),
            "layers": _moe_specs(cfg),
            "final_norm": (None,),
            "head": (None, "model"),
        }
    if cfg.family == "rwkv6":
        return {
            "embed": ("model", None),
            "layers": _rwkv_specs(cfg),
            "final_norm": (None,),
            "head": (None, "model"),
        }
    if cfg.family == "zamba2":
        lay, shared = _zamba_specs(cfg)
        out = {
            "embed": ("model", None),
            "layers": lay,
            "final_norm": (None,),
            "head": (None, "model"),
        }
        if cfg.attn_every > 0:
            out["shared"] = shared
        return out
    raise KeyError(cfg.family)


def sanitize_spec(spec, shape, mesh) -> tuple:
    """Drop entries whose axis size does not divide the dimension (e.g.
    internvl2's 92553 vocab on a 16-way model axis): those dimensions are
    replicated.  ``mesh.shape`` maps axis names to sizes."""
    if spec is None:
        return ()
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(e if dim % size == 0 else None)
    return tuple(out)
