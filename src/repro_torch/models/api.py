"""Family dispatcher (a port of ``repro.models.api``): uniform access to
every architecture family.

Each family exposes ``init_params(gen, cfg, device)``, ``loss_fn``,
``prefill``, ``decode_step`` and ``init_cache``; the dense transformer
also ``forward``.  The dense transformer runs in both of its layer
layouts (stacked, and unscanned with ``scan_layers=False``).
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe, rwkv6, transformer, zamba2

_FAMILIES = {"dense": transformer, "moe": moe, "rwkv6": rwkv6,
             "zamba2": zamba2}


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    m = _FAMILIES.get(cfg.family)
    if m is None:
        raise KeyError(f"unknown family {cfg.family!r}")
    return SimpleNamespace(
        init_params=m.init_params,
        loss_fn=m.loss_fn,
        prefill=m.prefill,
        decode_step=m.decode_step,
        init_cache=m.init_cache,
        forward=getattr(m, "forward", None),
        module=m,
    )
