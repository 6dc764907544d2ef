"""The LM zoo (port of ``repro.models``).

Ported: the config schema, norms, dense / gated MLPs, RoPE, grouped-query
attention with the sliding-window ring buffer (dense path), MoE (the
dense path), RWKV-6 (chunked prefill, exact decode), the decode caches
and the model stack.  Mamba and the jamba hybrid, the audio / vision
frontends, M-RoPE and the chunked / flash attention path wait for
ROADMAP.md Queue 1 item 12; the expert-parallel MoE for item 11.
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
