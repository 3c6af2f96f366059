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
``step_scalars(state, n, alive=None, recover=None) -> float32 [n, ...,
m]``: the values of the next n updates.  A caller that cannot run host
code per step (the engine's round program, a CUDA graph on the card)
passes row i to update i as ``update(..., scalars=row)``, a float32
[..., m] tensor on the device; without it the update computes the same
values itself.

A host count is an int, or an int array with one count for each worker
(the engine's state has a leading worker axis R, as ``repro``'s vmapped
state does): a worker that is down keeps its count and a recovered one
restarts from a fresh state, so the counts part.  ``alive`` /
``recover`` (bool [n, ...], one row a step) replay that on the host.
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

    def bias_corrections(count) -> np.ndarray:
        """float32 [..., 2]: (1 - b1^c, 1 - b2^c) for a count or an array
        of counts.  Each power is a float32 scalar power (libm powf), as
        repro's b ** f32(count); numpy's vectorized float32 power rounds
        some counts otherwise."""
        cs = np.asarray(count)
        out = np.empty(cs.shape + (2,), np.float32)
        for i, c in np.ndenumerate(cs):
            c = np.float32(c)
            out[i] = (np.float32(1) - np.float32(b1) ** c,
                      np.float32(1) - np.float32(b2) ** c)
        return out

    def step_scalars(state, n: int, alive=None, recover=None) -> np.ndarray:
        """The bias corrections of the next ``n`` updates, float32 [n, 2]
        (or [n, R, 2] for a count a worker).  ``alive`` / ``recover``
        (bool [n, R]): a recovered worker's count restarts at 0 before
        the step, a dead worker's stays after it (its update is computed
        and discarded, at the count it would have had)."""
        count = np.asarray(state["count"])
        rows = []
        for i in range(n):
            if recover is not None:
                count = np.where(recover[i], 0, count)
            nxt = count + 1
            rows.append(bias_corrections(nxt))
            count = nxt if alive is None else np.where(alive[i], nxt, count)
        return np.stack(rows) if rows else np.zeros(
            (0,) + count.shape + (2,), np.float32)

    def update(grads, state, params, lr, scalars=None):
        count = state["count"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * (g * g),
                     state["v"], grads)
        if scalars is None:
            # on the parameters' device: a true division by a device
            # tensor, as the round program's (a CPU scalar divisor is a
            # reciprocal multiply in PyTorch's CUDA kernels)
            dev = tree_leaves(m)[0].device if tree_leaves(m) else None
            scalars = torch.from_numpy(bias_corrections(count)).to(dev)
        bc1, bc2 = scalars[..., 0], scalars[..., 1]

        def upd(m_, v_, p):
            # a count a worker: [R] corrections over the leading axis
            shape = tuple(bc1.shape) + (1,) * (m_.dim() - bc1.dim())
            u = (m_ / bc1.reshape(shape)) / (
                torch.sqrt(v_ / bc2.reshape(shape)) + eps)
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
