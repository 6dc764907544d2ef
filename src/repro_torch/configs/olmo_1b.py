"""OLMo-1B [arXiv:2402.00838] — dense decoder with non-parametric LayerNorm.

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.models.config import ModelConfig, dense_unit

ARCH_ID = "olmo-1b"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="dense",
        d_model=2048,
        vocab_size=50304,
        unit=dense_unit(1),
        num_units=16,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        norm="layernorm_np",   # OLMo's non-parametric LN
        tie_embeddings=True,
        citation="arXiv:2402.00838",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=128, num_units=2, num_heads=4, num_kv_heads=4,
                      d_ff=256, vocab_size=1024)
