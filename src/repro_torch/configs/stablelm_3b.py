"""stablelm-3b — dense MHA (kv = heads) [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b", family="dense",
        n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
        d_ff=6912, vocab=50304, rope_theta=1e4, max_seq_len=16384,
        source="hf:stabilityai/stablelm-2-1_6b",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=8, head_dim=32,
        d_ff=432, vocab=512, max_seq_len=256,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
