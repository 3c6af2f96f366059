"""Config registry (a port of ``repro.configs``): ``--arch <id>``
resolution for every architecture, and the compression-policy presets."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.policies import (
    ARCH_POLICIES,
    POLICY_PRESETS,
    get_policy_preset,
)

ARCHS = {
    "yi-6b": "yi_6b",
    "stablelm-3b": "stablelm_3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "gemma3-1b": "gemma3_1b",
    "rwkv6-3b": "rwkv6_3b",
    "musicgen-medium": "musicgen_medium",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "yi-34b": "yi_34b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-26b": "internvl2_26b",
}

#: archs with a sub-quadratic long-context path => run long_500k
LONG_CONTEXT_ARCHS = {"rwkv6-3b", "zamba2-7b", "gemma3-1b"}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str, *, smoke: bool = False, **kw) -> ModelConfig:
    mod = _module(arch)
    return mod.smoke() if smoke else mod.full(**kw)


def shape_supported(arch: str, shape: str) -> tuple[bool, str]:
    """(supported, reason) for the 10x4 dry-run matrix."""
    sh = INPUT_SHAPES[shape]
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "full-attention arch; no sub-quadratic variant (DESIGN.md)"
    return True, ""


__all__ = [
    "ARCHS",
    "ARCH_POLICIES",
    "LONG_CONTEXT_ARCHS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "POLICY_PRESETS",
    "get_config",
    "get_policy_preset",
    "shape_supported",
]
