"""Minimal optax-style gradient transforms (a port of
``repro.optim.transforms``).

``update(grads, state, params, lr) -> (updates, new_state)``; the new
parameters are ``params - updates`` (updates already carry the learning
rate), matching the paper's bookkeeping where ``x_t - x̂_{t+1/2}``
accumulates ``sum_j eta_j * d_j``.  Every update is elementwise, so the
engine applies one transform to all workers' parameters at once, with
the worker axis leading.  ``lr`` is a float32 scalar tensor; scalars are
applied in float32 in ``repro``'s expression order.

A transform whose update needs per-step values computed on the host
(Adam's bias corrections, from its host step count) names them with
``step_scalars(state, n) -> float32 [n, m]``: the values of the next n
updates.  A caller that cannot run host code per step (the engine's
round program, a CUDA graph on the card) passes row i to update i as
``update(..., scalars=row)``, a float32 [m] tensor on the device;
without it the update computes the same values itself.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

OptState = Any


class GradientTransform(NamedTuple):
    init: Callable[[Any], OptState]
    update: Callable[..., tuple[Any, OptState]]
    step_scalars: Optional[Callable[[OptState, int], np.ndarray]] = None


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _times_lr(lr, x: torch.Tensor) -> torch.Tensor:
    """``lr * x`` as a float32 product rounded once to x's dtype, whether
    ``lr`` is a host scalar (the per-step runtime) or a tensor on x's
    device (the round program): PyTorch casts a device scalar to a
    bfloat16 operand's dtype first, a host one it does not."""
    if x.dtype in (torch.float32, torch.float64):
        return lr * x
    return (lr * x.to(torch.float32)).to(x.dtype)


def sgd(weight_decay: float = 0.0) -> GradientTransform:
    def init(params):
        return ()

    def update(grads, state, params, lr, scalars=None):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        return tree_map(lambda g: _times_lr(lr, g), grads), state

    return GradientTransform(init, update)


def momentum_sgd(momentum: float = 0.9, nesterov: bool = False,
                 weight_decay: float = 0.0) -> GradientTransform:
    """SGD with (heavy-ball) momentum, applied on local iterations as in
    the paper's ResNet-50 experiments (momentum 0.9)."""

    def init(params):
        return {"mu": _zeros_like(params)}

    def update(grads, state, params, lr, scalars=None):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        if nesterov:
            eff = tree_map(lambda m, g: momentum * m + g, mu, grads)
        else:
            eff = mu
        return tree_map(lambda e: _times_lr(lr, e), eff), {"mu": mu}

    return GradientTransform(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> GradientTransform:
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "count": 0}

    def bias_corrections(count: int) -> list:
        # float32 powers on the host (libm powf), as repro's b ** f32(count)
        c = np.float32(count)
        return [np.float32(1) - np.float32(b1) ** c,
                np.float32(1) - np.float32(b2) ** c]

    def step_scalars(state, n: int) -> np.ndarray:
        """(1 - b1^t, 1 - b2^t) of the next ``n`` updates, float32 [n, 2]."""
        return np.array([bias_corrections(state["count"] + 1 + i)
                         for i in range(n)], np.float32)

    def update(grads, state, params, lr, scalars=None):
        count = state["count"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * (g * g),
                     state["v"], grads)
        if scalars is None:
            # on the parameters' device: a true division by a device
            # scalar, as the round program's (a CPU scalar divisor is a
            # reciprocal multiply in PyTorch's CUDA kernels)
            dev = tree_leaves(m)[0].device if tree_leaves(m) else None
            scalars = torch.from_numpy(np.array(bias_corrections(count),
                                                np.float32)).to(dev)
        bc1, bc2 = scalars[0], scalars[1]

        def upd(m_, v_, p):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p
            return _times_lr(lr, u)

        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "count": count}

    return GradientTransform(init, update, step_scalars)


def apply_updates(params, updates):
    """params - updates (updates already carry the learning rate)."""
    return tree_map(lambda p, u: (p - u).to(p.dtype), params, updates)


def make_optimizer(name: str, **kw) -> GradientTransform:
    table = {"sgd": sgd, "momentum": momentum_sgd, "adam": adam}
    if name not in table:
        raise KeyError(f"unknown optimizer {name!r}; have {sorted(table)}")
    return table[name](**kw)
