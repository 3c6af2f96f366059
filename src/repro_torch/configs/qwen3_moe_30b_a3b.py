"""qwen3-moe-30b-a3b — 128 experts, top-8, per-expert ff 768
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936, rope_theta=1e6, max_seq_len=32768,
        n_experts=128, moe_top_k=8, moe_interleave=1,
        capacity_factor=1.25,
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=512, max_seq_len=256,
        n_experts=4, moe_top_k=2, moe_interleave=1, capacity_factor=4.0,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
