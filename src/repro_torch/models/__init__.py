"""The LM zoo's dense attention decoders (port of ``repro.models``).

Ported: the config schema, norms, dense / gated MLPs, RoPE, grouped-query
attention with the sliding-window ring buffer (dense path), the decode
cache and the model stack.  Mamba, RWKV-6, MoE, M-RoPE, the frontends and
the chunked / flash attention path wait for ROADMAP.md Queue 1 item 12.
"""
from repro_torch.models.cache import init_cache
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.transformer import (
    Batch,
    decode_step,
    forward,
    init_model,
    prefill,
)

__all__ = [
    "Batch",
    "LayerSpec",
    "ModelConfig",
    "decode_step",
    "forward",
    "init_cache",
    "init_model",
    "prefill",
]
