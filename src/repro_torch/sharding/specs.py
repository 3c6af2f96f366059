"""Per-architecture parameter specs for the tensor-parallel ``model``
axis (a port of ``repro.sharding.specs``).

A spec is a plain tuple with one entry per leading dimension of its
leaf: ``None`` (not sharded), ``"model"`` or a tuple of axis names;
dimensions past the tuple's length are not sharded.  Conventions
(megatron-style), as in ``repro``: column-parallel weights shard their
out-features (``"model"`` on the last dim), row-parallel ones their
in-features, embeddings the vocab.

The specs place each leaf on the ``model`` axis (a rank holds its
slice: :func:`shard_layout`, :func:`shard_tree`, :func:`gather_tree`)
and decide which axis every leaf is compressed along
(``core.distributed._pick_axis`` keeps Top_k off the ``model`` axis), and
so the wire bits, whatever the model axis's size.  Every family trains
tensor-parallel: the dense family (ROADMAP queue 1 item 12a), the MoE
family expert-parallel (12b), RWKV-6 and Zamba2 (12c).
``activation_policy`` gives the model code its ``ShardingPolicy``: the
mesh whose model group the port's own collectives run over, where
``repro``'s hands XLA sharding constraints.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShardingPolicy
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten

class PendingPort(NotImplementedError):
    """A path refused until the ROADMAP item its message names ports it
    (serving or the fault runtime on a model axis above 1)."""


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


def activation_policy(cfg: ModelConfig, mesh=None, *,
                      for_serving: bool = False) -> ShardingPolicy:
    """The model code's ``ShardingPolicy`` on ``mesh`` (``repro``'s
    function: there the activation constraints, here the mesh whose
    ``model`` group the model's collectives run over).  ``ep_axis`` is
    "model" for the MoE family, as ``repro`` sets it: its experts run
    expert-parallel over the model group.  Serving with a model axis
    above 1 is refused (ROADMAP queue 1 item 12d)."""
    size = 1 if mesh is None else mesh.model_size
    if for_serving and size > 1:
        raise PendingPort(
            f"serving with a model axis of {size} is not ported (ROADMAP "
            "queue 1 item 12d)")
    return ShardingPolicy(
        mesh=mesh if size > 1 else None,
        ep_axis="model" if cfg.family == "moe" else None)


def batch_specs(kind: str, data_axes=("data",)) -> dict:
    """The batch's placement: rows over the data axes, replicated over
    the model group (``repro``'s ``batch_specs``)."""
    da = tuple(data_axes)
    da = da[0] if len(da) == 1 else da
    if kind == "train":
        return {"tokens": (da, None, None)}
    return {"tokens": (da, None)}


def head_divisibility_note(cfg: ModelConfig, model_size: int) -> str:
    """Roofline annotation: which shardings are limited by divisibility."""
    notes = []
    if cfg.family in ("dense", "moe"):
        if (cfg.n_heads * cfg.hd) % model_size:
            notes.append(f"attn out dim {cfg.n_heads * cfg.hd} !% {model_size}")
        if (cfg.n_kv_heads * cfg.hd) % model_size:
            notes.append(
                f"kv dim {cfg.n_kv_heads * cfg.hd} !% {model_size} (replicated)"
            )
    return "; ".join(notes) or "clean"


# ---------------------------------------------------------------------------
# a rank's slices
# ---------------------------------------------------------------------------


def model_axis(spec, shape, mesh) -> Optional[int]:
    """The axis of a leaf of whole ``shape`` that the model group splits
    under :func:`sanitize_spec`, or None (the leaf is whole on every
    rank of the group).  A spec that splits an axis over another mesh
    axis too is refused: parameters shard over ``model`` only."""
    if mesh.model_size == 1:
        return None
    out = None
    for ax, e in enumerate(sanitize_spec(spec, shape, mesh)):
        if e is None:
            continue
        if e != "model" and e != ("model",):
            raise ValueError(f"spec {spec} splits axis {ax} over {e!r}: "
                             "parameters shard over 'model' only")
        if out is not None:
            raise ValueError(f"spec {spec} splits two axes over 'model'")
        out = ax
    return out


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where the model group splits each leaf of a tree (flatten order):
    ``axes[i]`` the axis of leaf i, or None where it is whole on every
    rank; ``shapes[i]`` its whole shape.  ``size`` / ``rank``: the model
    group's (``mesh.model_size`` / ``mesh.model_rank``)."""

    axes: tuple
    shapes: tuple
    size: int
    rank: int

    def numels(self) -> list:
        """Each leaf's elements, whole."""
        out = []
        for shape in self.shapes:
            k = 1
            for d in shape:
                k *= int(d)
            out.append(k)
        return out

    def numel(self) -> int:
        """The whole tree's elements (every leaf whole)."""
        return sum(self.numels())

    def own(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of leaf i given whole (a view)."""
        ax = self.axes[i]
        if ax is None:
            return x
        n = x.shape[ax] // self.size
        return x.narrow(ax, self.rank * n, n)


def shard_layout(specs, tree, mesh) -> ShardLayout:
    """The :class:`ShardLayout` of a whole tree (its leaves' shapes: a
    ``meta`` tree will do) on ``mesh``'s model group."""
    leaves = tree_leaves(tree)
    spec_leaves = (tree_leaves(specs, is_leaf=is_spec) if specs is not None
                   else [None] * len(leaves))
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                         "leaves")
    shapes = tuple(tuple(x.shape) for x in leaves)
    return ShardLayout(
        axes=tuple(model_axis(sp, sh, mesh)
                   for sp, sh in zip(spec_leaves, shapes)),
        shapes=shapes, size=mesh.model_size, rank=mesh.model_rank)


def shard_tree(tree, layout: ShardLayout):
    """This rank's slice of each leaf of a whole tree, a copy of its own
    where the leaf is split (so the whole leaf can go)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [
        x if layout.axes[i] is None else layout.own(x, i).clone()
        for i, x in enumerate(leaves)])


def gather_leaf(x: torch.Tensor, axis: Optional[int], mesh) -> torch.Tensor:
    """A whole leaf from the model group's slices along ``axis`` (one
    all-gather over the model group; None: ``x`` is whole)."""
    if axis is None:
        return x
    return torch.cat(mesh.all_gather(x, over="model").unbind(0), dim=axis)


def gather_tree(tree, layout: ShardLayout, mesh):
    """The inverse of :func:`shard_tree`: the whole leaves, gathered from
    the model group's slices.  Every rank of the group must call it."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [gather_leaf(x, layout.axes[i], mesh)
                                 for i, x in enumerate(leaves)])
