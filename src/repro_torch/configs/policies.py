"""Per-architecture compression-policy presets (a port of
``repro.configs.policies``; DESIGN.md §6).

Named ``core.policy`` DSL strings for ``launch/train.py --policy
preset:<name>`` (or ``preset:arch`` to pick by ``--arch``).  The
heterogeneous presets follow the paper's layer-wise Top_k setup plus
Wangni et al.'s observation that *where* the sparsity budget lands
matters: aggressive Top_k on the big matmuls, QSGD on the embedding /
head tables, dense (identity) on the norms, biases and other small
glue the error-feedback memory should not be spent on.

Pattern vocabulary (leaf paths are '/'-joined, e.g. ``layers/attn/wq``;
see ``core.policy.tree_paths``): transformer stacks expose
``embed|head|final_norm|layers/attn/*|layers/mlp/*|layers/ln*``; the
SSM families expose their own mixer names, matched by the family
presets below.
"""

from __future__ import annotations

from repro_torch.core import policy as pol

#: named presets (DSL strings — parse with ``core.policy.parse``)
POLICY_PRESETS: dict[str, str] = {
    # the historical homogeneous default (catch-all Top_k 1%)
    "uniform_topk": "topk:k=0.01",
    # heterogeneous: dense norms/biases, QSGD embeddings/head, Top_k
    # on everything big — the ResNet-50-style layer-wise setup
    "lm_hetero": ("ln|norm|bias|scale|gate_bias->identity;"
                  "embed|head->qsgd:s=15;"
                  ".*->topk:k=0.01"),
    # bidirectional: same uplink + an error-compensated Top_k downlink
    "lm_hetero_bidir": ("ln|norm|bias|scale|gate_bias->identity;"
                        "embed|head->qsgd:s=15;"
                        ".*->topk:k=0.01"
                        " >> ln|norm|bias->identity;.*->topk:k=0.05"),
    # one global survivor budget (1% of the matched dims) spent
    # proportional to leaf size across the matmul leaves
    "budget_1pct": ("budget=0.01;"
                    "attn|mlp|ffn|expert|proj|mixer->topk;"
                    ".*->identity"),
    # 1-bit wire: SignTop_k everywhere it pays, dense glue
    "sign_hetero": ("ln|norm|bias|scale->identity;"
                    ".*->signtopk:k=0.01,m=2"),
}

#: default preset per assigned architecture (``preset:arch``)
ARCH_POLICIES: dict[str, str] = {
    "yi-6b": "lm_hetero",
    "yi-34b": "lm_hetero",
    "stablelm-3b": "lm_hetero",
    "gemma3-1b": "lm_hetero",
    "llama4-maverick-400b-a17b": "budget_1pct",
    "qwen3-moe-30b-a3b": "budget_1pct",
    "musicgen-medium": "lm_hetero",
    "internvl2-26b": "lm_hetero",
    "rwkv6-3b": "sign_hetero",
    "zamba2-7b": "sign_hetero",
}


def get_policy_preset(name: str, arch: str | None = None):
    """Resolve ``preset:<name>`` (or ``preset:arch``) to a parsed
    ``PolicySpec``/``ChannelSpec``.  Unknown names fail loudly."""
    if name == "arch":
        if arch is None or arch not in ARCH_POLICIES:
            raise KeyError(
                f"no per-arch policy preset for {arch!r}; have "
                f"{sorted(ARCH_POLICIES)}")
        name = ARCH_POLICIES[arch]
    if name not in POLICY_PRESETS:
        raise KeyError(
            f"unknown policy preset {name!r}; have {sorted(POLICY_PRESETS)}")
    return pol.parse(POLICY_PRESETS[name])
