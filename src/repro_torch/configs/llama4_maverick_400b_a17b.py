"""llama4-maverick-400b-a17b — interleaved MoE (every 2nd layer MoE,
128 experts top-1, shared expert), early-fusion multimodal backbone
[hf:meta-llama/Llama-4-Scout-17B-16E].

Param budget check (ModelConfig.param_count): 24 MoE layers x 128
experts x 3*5120*8192 ~= 386B + dense/attn/embed ~= 400B total,
~17B active.
"""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, dense_ff=16384, vocab=202048, rope_theta=5e5,
        max_seq_len=32768,
        n_experts=128, moe_top_k=1, moe_interleave=2, shared_expert=True,
        capacity_factor=1.25,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=96, dense_ff=192, vocab=512, max_seq_len=256,
        n_experts=4, moe_top_k=1, moe_interleave=2, shared_expert=True,
        capacity_factor=4.0,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
