"""rwkv6-3b "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="rwkv6",
        n_layers=32, d_model=2560, d_ff=8960, vocab=65536,
        ssm_head_dim=64, max_seq_len=1 << 20,
        source="arXiv:2404.05892",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke", family="rwkv6",
        n_layers=2, d_model=128, d_ff=448, vocab=512,
        ssm_head_dim=16, max_seq_len=256,
        param_dtype="float32", act_dtype="float32",
        source="arXiv:2404.05892",
    )
