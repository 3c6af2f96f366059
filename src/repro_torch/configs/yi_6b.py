"""yi-6b — llama-arch dense GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-6b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=11008, vocab=64000, rope_theta=5e6, max_seq_len=32768,
        source="arXiv:2403.04652",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-6b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=1, head_dim=32,
        d_ff=688, vocab=512, rope_theta=5e6, max_seq_len=256,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="arXiv:2403.04652",
    )
