"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — fine-grained MoE: 128 experts top-8.

48L d_model=2048 32H (kv=4, head_dim=128) per-expert d_ff=768 vocab=151936.
"""
from repro_torch.models.config import ModelConfig, moe_unit

ARCH_ID = "qwen3-moe-30b-a3b"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="moe",
        d_model=2048,
        vocab_size=151936,
        unit=moe_unit(1),
        num_units=48,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        moe_d_ff=768,
        num_experts=128,
        num_experts_per_tok=8,
        rope_theta=1e6,
        citation="hf:Qwen/Qwen3-30B-A3B",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=128, num_units=2, num_heads=4, num_kv_heads=2,
                      head_dim=32, d_ff=96, moe_d_ff=96, vocab_size=1024,
                      num_experts=4, num_experts_per_tok=2)
