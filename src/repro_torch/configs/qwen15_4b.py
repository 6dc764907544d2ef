"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family] — dense decoder with QKV bias.

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.models.config import ModelConfig, dense_unit

ARCH_ID = "qwen1.5-4b"


def get_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID,
        arch_type="dense",
        d_model=2560,
        vocab_size=151936,
        unit=dense_unit(1),
        num_units=40,
        num_heads=20,
        num_kv_heads=20,
        d_ff=6912,
        attention_bias=True,
        rope_theta=5e6,
        citation="hf:Qwen/Qwen1.5-0.5B",
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config() -> ModelConfig:
    return get_config(d_model=128, num_units=2, num_heads=4, num_kv_heads=4,
                      d_ff=256, vocab_size=1024)
