"""Gemma-3 4B [hf:google/gemma-3-1b-pt family] — 5:1 local:global attention.

34L d_model=2560 8H (kv=4, head_dim=256) d_ff=10240 vocab=262144,
sliding window 1024 on local layers; 128k-class context via the 5:1 pattern.
Unit of 6 layers (5 local + 1 global) x 5, tail of 4 local layers = 34.
Counts as sub-quadratic for long_500k (bounded global-layer fraction).
"""
from repro_torch.models.config import LayerSpec, ModelConfig

ARCH_ID = "gemma3-4b"


def _unit():
    return tuple(
        LayerSpec(mixer="attn_local", mlp="dense") for _ in range(5)
    ) + (LayerSpec(mixer="attn_global", mlp="dense"),)


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="dense",
        d_model=2560,
        vocab_size=262144,
        unit=_unit(),
        num_units=5,
        tail=tuple(LayerSpec(mixer="attn_local", mlp="dense") for _ in range(4)),
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        sliding_window=1024,
        act="geglu",
        scale_embeddings=True,
        tie_embeddings=True,
        rope_theta=1e6,
        citation="hf:google/gemma-3-1b-pt",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    unit = (
        LayerSpec(mixer="attn_local", mlp="dense"),
        LayerSpec(mixer="attn_global", mlp="dense"),
    )
    return get_config(unit=unit, num_units=1, tail=(), d_model=128,
                      num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                      vocab_size=1024, sliding_window=16)
