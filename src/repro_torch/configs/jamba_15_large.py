"""Jamba-1.5-Large 398B [arXiv:2403.19887] — hybrid Mamba+attention 1:7, MoE.

72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536, MoE 16 experts top-2.
Unit of 8 layers: 1 attention + 7 Mamba; MoE MLP on every other layer
(4 MoE per unit).  Hybrid: long_500k runs (bounded attention fraction).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "jamba-1.5-large-398b"


def _unit():
    layers = []
    for i in range(8):
        mixer = "attn" if i == 0 else "mamba"
        mlp = "moe" if i % 2 == 1 else "dense"
        layers.append(LayerSpec(mixer=mixer, mlp=mlp))
    return tuple(layers)


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="hybrid",
        d_model=8192,
        vocab_size=65536,
        unit=_unit(),
        num_units=9,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        moe_d_ff=24576,
        num_experts=16,
        num_experts_per_tok=2,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        citation="arXiv:2403.19887",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    unit = (
        LayerSpec(mixer="attn", mlp="dense"),
        LayerSpec(mixer="mamba", mlp="moe"),
    )
    return get_config(unit=unit, num_units=1, d_model=128, num_heads=4,
                      num_kv_heads=2, d_ff=256, moe_d_ff=256, vocab_size=1024,
                      num_experts=4, num_experts_per_tok=2, mamba_d_state=8)
