"""RWKV-6 "Finch" 7B [arXiv:2404.05892] — attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536 head_dim=64 (64 heads).
Sub-quadratic: O(1) decode state; runs the long_500k shape.
"""
from repro_torch.models.config import MLP_RWKV, LayerSpec, ModelConfig

ARCH_ID = "rwkv6-7b"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="ssm",
        d_model=4096,
        vocab_size=65536,
        unit=(LayerSpec(mixer="rwkv6", mlp=MLP_RWKV),),
        num_units=32,
        d_ff=14336,
        rwkv_head_dim=64,
        rwkv_lora_mix=32,
        rwkv_lora_decay=64,
        norm="layernorm",
        citation="arXiv:2404.05892",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=128, num_units=2, d_ff=256, vocab_size=1024,
                      rwkv_head_dim=32, rwkv_lora_mix=8, rwkv_lora_decay=8)
