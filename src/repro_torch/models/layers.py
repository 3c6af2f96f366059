"""Shared layer helpers (the part of ``repro.models.layers`` the ported
models need so far)."""

from __future__ import annotations

from typing import Optional

import torch


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """N(0, 1) * scale (default fan_in ** -0.5), drawn from ``gen`` on
    the generator's device and moved to ``device``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32) * s
    return w.to(device=device, dtype=dtype)
