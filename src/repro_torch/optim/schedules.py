"""Learning-rate schedules (a port of ``repro.optim.schedules``).

Each schedule maps a step (an int) to a float32 scalar tensor, evaluated
in float32 in ``repro``'s expression order, so both packages step with
the same learning rates: e.g. ``inverse_time`` is
``f32(xi) / (f32(a) + f32(step))``.  Powers of float32 scalars are taken
on the host with numpy (libm ``powf``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _step(step) -> int:
    return int(step)


def constant(lr: float):
    def fn(step):
        return _f32(lr)

    return fn


def inverse_time(xi: float, a: float):
    """eta_t = xi / (a + t)  (paper Lemma 4 / Theorem 2/3 form)."""

    def fn(step):
        return _f32(xi) / (_f32(a) + _f32(_step(step)))

    return fn


def paper_convex_lr(c: float, lam: float, d: int, H: int, k: int):
    """Section 5.2.2: lr = c / (lambda (a + t)), a = d H / k."""
    a = float(d) * H / max(k, 1)
    return inverse_time(c / lam, a)


def piecewise_decay(base_lr: float, boundaries, factor: float = 0.1):
    bnds = [int(b) for b in boundaries]

    def fn(step):
        n = sum(_step(step) >= b for b in bnds)
        return _f32(base_lr) * _f32(np.float32(factor) ** np.float32(n))

    return fn


def warmup_piecewise(base_lr: float, warmup_steps: int, boundaries,
                     factor: float = 0.1):
    """Linear warmup then piecewise decay (paper's ResNet-50 schedule)."""
    pw = piecewise_decay(base_lr, boundaries, factor)

    def fn(step):
        if _step(step) < warmup_steps:
            s = _f32(_step(step))
            return _f32(base_lr) * (s + 1.0) / _f32(max(warmup_steps, 1))
        return pw(step)

    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    def fn(step):
        s = _f32(_step(step))
        if _step(step) < warmup_steps:
            return _f32(base_lr) * (s + 1.0) / _f32(max(warmup_steps, 1))
        prog = torch.clamp((s - _f32(warmup_steps))
                           / _f32(max(total_steps - warmup_steps, 1)),
                           0.0, 1.0)
        inner = _f32((1 - min_ratio) * 0.5) * (
            1.0 + torch.cos(_f32(math.pi) * prog))
        return _f32(base_lr) * (_f32(min_ratio) + inner)

    return fn
