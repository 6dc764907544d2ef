"""Qwen2-VL-7B [arXiv:2409.12191] — VLM backbone with M-RoPE.

28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064.
Vision encoder (ViT + projector) is a stub per DESIGN.md §5; the language
backbone consumes merged text-token + patch embeddings with (t,h,w) M-RoPE
position streams.
"""
from repro_torch.models.config import ModelConfig, dense_unit

ARCH_ID = "qwen2-vl-7b"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="vlm",
        d_model=3584,
        vocab_size=152064,
        unit=dense_unit(1),
        num_units=28,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        attention_bias=True,
        rope="mrope",
        mrope_sections=(16, 24, 24),   # head_dim 128 -> half 64 = 16+24+24
        rope_theta=1e6,
        frontend="vision",
        citation="arXiv:2409.12191",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=128, num_units=2, num_heads=4, num_kv_heads=2,
                      d_ff=256, vocab_size=1024, mrope_sections=(4, 6, 6))
