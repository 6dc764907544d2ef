"""Mixtral-8x7B [arXiv:2401.04088] — MoE 8 experts top-2 with SWA.

32L d_model=4096 32H (kv=8) d_ff=14336/expert vocab=32000, window 4096.
Sliding-window attention makes the long_500k decode cache bounded.
"""
from repro_torch.models.config import ModelConfig, moe_unit

ARCH_ID = "mixtral-8x7b"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="moe",
        d_model=4096,
        vocab_size=32000,
        unit=moe_unit(1, mixer="attn_swa"),
        num_units=32,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        sliding_window=4096,
        num_experts=8,
        num_experts_per_tok=2,
        moe_d_ff=14336,
        rope_theta=1e6,
        citation="arXiv:2401.04088",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=128, num_units=2, num_heads=4, num_kv_heads=2,
                      d_ff=256, moe_d_ff=256, vocab_size=1024,
                      num_experts=4, num_experts_per_tok=2, sliding_window=32)
