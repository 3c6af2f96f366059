"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  swa_pattern supplies the shared block's window at
long context (long_500k); -1 (full) elsewhere."""
from repro_torch.configs.base import ModelConfig


def full(long_context: bool = False) -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="zamba2",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
        d_ff=14336, vocab=32000, max_seq_len=1 << 20,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        attn_every=6,
        swa_pattern=(4096,) if long_context else None,
        source="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="zamba2",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=512, max_seq_len=256,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
        attn_every=2,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="arXiv:2411.15242",
    )
