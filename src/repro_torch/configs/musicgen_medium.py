"""musicgen-medium — decoder-only over EnCodec tokens; the EnCodec
conv codec frontend is the allowed stub (precomputed conditioning frame
embeddings are prepended) [arXiv:2306.05284]."""
from repro_torch.configs.base import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="dense",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
        d_ff=6144, vocab=2048, rope_theta=1e4, max_seq_len=32768,
        modality="audio", n_frontend_tokens=64,
        source="arXiv:2306.05284",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke", family="dense",
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=6, head_dim=32,
        d_ff=384, vocab=512, max_seq_len=256,
        modality="audio", n_frontend_tokens=8,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="arXiv:2306.05284",
    )
