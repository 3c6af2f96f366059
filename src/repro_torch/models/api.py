"""Family dispatcher (a port of ``repro.models.api``): uniform access to
the model families the port has.

Each family exposes ``init_params(gen, cfg, device)``, ``loss_fn``,
``prefill``, ``decode_step``, ``init_cache`` and ``forward``.  Only the
dense transformer is ported; the MoE, RWKV-6 and Zamba2 families are
ROADMAP queue 1 item 13.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILIES = ("dense", "moe", "rwkv6", "zamba2")


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    fam = cfg.family
    if fam not in _FAMILIES:
        raise KeyError(f"unknown family {fam!r}")
    if fam != "dense":
        raise NotImplementedError(
            f"model family {fam!r} is not ported to repro_torch yet: "
            "ROADMAP queue 1 item 13")
    m = transformer
    return SimpleNamespace(
        init_params=m.init_params,
        loss_fn=m.loss_fn,
        prefill=m.prefill,
        decode_step=m.decode_step,
        init_cache=m.init_cache,
        forward=m.forward,
        module=m,
    )
