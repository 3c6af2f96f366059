"""Model configuration schema (a port of ``repro.configs.base``).

Every architecture has a module ``configs/<id>.py`` exporting ``full()``
(the published config) and ``smoke()`` (a reduced variant of the same
family).  ``ModelConfig`` keeps ``repro``'s fields and names; its
``pdtype`` / ``adtype`` are torch dtypes.  ``ShardingPolicy`` is the
counterpart of ``repro``'s: where ``repro`` hands XLA activation
sharding constraints, the port's model code runs the tensor-parallel
collectives itself, so the policy carries the mesh whose ``model`` group
they run over (its size and this rank's place in it) and ``ep_axis``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """What the model code needs of the tensor-parallel mesh (``repro``'s
    ``ShardingPolicy``; built by ``sharding.specs.activation_policy``).

    ``mesh`` is a ``launch.mesh.Mesh`` (or None: no model group); the
    model's collectives (``sharding/collectives.py``) run over its
    ``model`` group through its methods.  ``ep_axis``: the mesh axis of
    explicit expert parallelism (MoE: "model"; ``models.moe.moe_ffn``
    splits the experts over the model group where it divides them).
    With a model group of one every collective is the identity and the
    model runs as without a policy."""

    mesh: Any = None
    ep_axis: Optional[str] = None

    @property
    def size(self) -> int:
        """M: the ranks of the model group."""
        return 1 if self.mesh is None else self.mesh.model_size

    @property
    def rank(self) -> int:
        """This rank's place in its model group."""
        return 0 if self.mesh is None else self.mesh.model_rank

    @property
    def active(self) -> bool:
        return self.size > 1

    def splits(self, n: int) -> bool:
        """Does the model group split a dimension of ``n``?  Only where
        it divides (``sharding.specs.sanitize_spec``'s rule: a dimension
        that does not divide stays whole on every rank)."""
        return self.active and n % self.size == 0


NO_SHARDING = ShardingPolicy()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"            # dense | moe | rwkv6 | zamba2 | softmax | resnet
    # transformer common
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None   # default d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1000
    rope_theta: float = 1e4
    max_seq_len: int = 8192
    tie_embeddings: bool = False
    # attention pattern: window size per layer; -1 = global full attention.
    # ``swa_pattern=(w, w, w, w, w, -1)`` means 5 local : 1 global (gemma3).
    swa_pattern: Optional[Tuple[int, ...]] = None
    # MoE
    n_experts: int = 0
    moe_top_k: int = 1
    moe_interleave: int = 1          # every Nth layer is MoE (1 = all)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dense_ff: Optional[int] = None   # FFN width of non-MoE interleaved layers
                                     # and the shared expert (default d_ff)
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 6              # zamba2: shared attn block cadence
    # multimodal stubs
    modality: Optional[str] = None   # None | "audio" | "vision"
    n_frontend_tokens: int = 256     # patches / frames prepended
    # numerics / execution
    param_dtype: str = "bfloat16"
    act_dtype: str = "bfloat16"
    q_chunk: int = 512               # chunked attention query block
    remat: bool = True
    scan_layers: bool = True
    use_pallas: bool = False         # route attention through the Pallas kernel
    # citation for the assigned config
    source: str = ""

    # -- derived -----------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer attention window (-1 = full)."""
        if self.swa_pattern is None:
            return tuple([-1] * self.n_layers)
        pat = self.swa_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (dense embedding + stack)."""
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        if self.family == "softmax":
            return (self.d_model + 1) * self.vocab
        n = V * d  # embed
        if not self.tie_embeddings:
            n += d * V
        n += d  # final norm
        if self.family == "rwkv6":
            att = d * (4 * d) + 6 * d  # r,k,v,o + decays/mixes (approx lora'd)
            ffn = d * ff + ff * d
            n += L * (att + ffn + 2 * d)
            return n
        if self.family == "zamba2":
            din = self.ssm_expand * d
            mamba = d * (2 * din) + din * d + din * (2 * self.ssm_state) + din
            n += L * (mamba + 2 * d)
            # shared attention+mlp block (counted once)
            n += 4 * d * self.n_heads * hd + 3 * d * ff
            return n
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        dense_ffn = 3 * d * ff
        if self.family == "moe":
            dff = self.dense_ff or ff
            moe_layers = sum(
                1 for i in range(L) if (i + 1) % self.moe_interleave == 0
            )
            dense_layers = L - moe_layers
            expert_ffn = self.n_experts * 3 * d * ff + d * self.n_experts
            if self.shared_expert:
                expert_ffn += 3 * d * dff
            n += L * (attn + 2 * d) + dense_layers * 3 * d * dff \
                + moe_layers * expert_ffn
        else:
            n += L * (attn + dense_ffn + 2 * d)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.param_count()
        d, ff, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        dff = self.dense_ff or ff
        moe_layers = sum(1 for i in range(L) if (i + 1) % self.moe_interleave == 0)
        dense_layers = L - moe_layers
        act_ffn = self.moe_top_k * 3 * d * ff + (3 * d * dff if self.shared_expert else 0)
        n = 2 * V * d + d + L * (attn + 2 * d) \
            + dense_layers * 3 * d * dff + moe_layers * act_ffn
        return n


# ---------------------------------------------------------------------------
# assigned input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
