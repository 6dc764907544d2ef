"""The LM zoo (port of ``repro.models``).

The config schema, norms, dense / gated MLPs, RoPE and M-RoPE, HuBERT's
convolutional position embedding, grouped-query attention with the
sliding-window ring buffer (dense up to ``DENSE_MAX``, flash with a
recompute backward beyond), MoE (the dense path and the expert-parallel
one with capacity dispatch), Mamba and the jamba hybrid (exact
sequential scan), RWKV-6 (chunked prefill, exact decode), the audio /
vision frontends and their batch stubs, the decode caches and the model
stack.  ``forward`` / ``prefill`` / ``decode_step`` take the reference's
``ctx`` (``shardctx.ShardCtx``): on a DeviceMesh the model runs on
DTensor parameters under sharding propagation, activations pinned to
the context's layout, and MoE layers take the expert-parallel path.
"""
from repro_torch.models.cache import init_cache
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.frontends import (
    hubert_batch,
    lm_batch,
    mrope_positions_for_image,
    vlm_batch,
)
from repro_torch.models.mamba import init_mamba_state, mamba_forward, mamba_step
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
    "flash_attention",
    "forward",
    "hubert_batch",
    "init_cache",
    "init_mamba_state",
    "init_model",
    "lm_batch",
    "mamba_forward",
    "mamba_step",
    "mrope_positions_for_image",
    "prefill",
    "vlm_batch",
]
