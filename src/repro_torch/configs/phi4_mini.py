"""Phi-4-mini 3.8B [arXiv:2412.08905] — dense decoder: RoPE + SwiGLU + GQA.

32L d_model=3072 24H (kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.models.config import ModelConfig, dense_unit

ARCH_ID = "phi4-mini-3.8b"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="dense",
        d_model=3072,
        vocab_size=200064,
        unit=dense_unit(1),
        num_units=32,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        tie_embeddings=True,
        citation="arXiv:2412.08905",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=120, num_units=2, num_heads=4, num_kv_heads=2,
                      d_ff=256, vocab_size=1024)
