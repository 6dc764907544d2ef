"""HuBERT X-Large [arXiv:2106.07447] — audio encoder-only backbone.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means cluster targets).
Frontend (mel + conv feature extractor) is a stub per DESIGN.md §5; the
backbone trains with masked frame prediction.  Encoder-only: no decode step.
"""
from repro_torch.models.config import ModelConfig, dense_unit

ARCH_ID = "hubert-xlarge"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="audio",
        d_model=1280,
        vocab_size=504,
        unit=dense_unit(1),
        num_units=48,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        act="gelu",
        norm="layernorm",
        causal=False,
        rope="none",          # HuBERT uses a conv positional embedding
        frontend="audio",
        citation="arXiv:2106.07447",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=128, num_units=2, num_heads=4, num_kv_heads=4,
                      d_ff=256, vocab_size=54)
