"""internvl2-26b — InternLM2-20B language backbone consuming InternViT
patch embeddings; the ViT+projector frontend is the allowed stub
[arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="dense",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=92553, rope_theta=1e6, max_seq_len=32768,
        modality="vision", n_frontend_tokens=256,
        source="arXiv:2404.16821",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke", family="dense",
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=2, head_dim=32,
        d_ff=512, vocab=512, max_seq_len=256,
        modality="vision", n_frontend_tokens=16,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="arXiv:2404.16821",
    )
