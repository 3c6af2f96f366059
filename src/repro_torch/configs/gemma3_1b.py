"""gemma3-1b — 5:1 local:global attention (window 1024), kv=1,
262k vocab, 128k rope [hf:google/gemma-3-1b-pt]."""
from repro_torch.configs.base import ModelConfig

_PATTERN = (1024, 1024, 1024, 1024, 1024, -1)


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262144, rope_theta=1e6, max_seq_len=131072,
        swa_pattern=_PATTERN, tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke", family="dense",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=432, vocab=512, max_seq_len=256,
        swa_pattern=(16, -1), tie_embeddings=True,
        param_dtype="float32", act_dtype="float32", q_chunk=32,
        source="hf:google/gemma-3-1b-pt",
    )
