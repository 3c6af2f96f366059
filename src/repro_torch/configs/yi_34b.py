"""yi-34b — llama-arch dense GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab=64000, rope_theta=5e6, max_seq_len=32768,
        q_chunk=128,
        source="arXiv:2403.04652",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=640, vocab=512, max_seq_len=256,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="arXiv:2403.04652",
    )
