"""Model configuration schema for the LM zoo.

Port of ``repro/models/config.py`` (plain dataclasses, copied as they
are).  A model is a stack of layer *units*: a unit is a short
heterogeneous sequence of layers (e.g. Jamba's ``7 x mamba + 1 x attn``
period, Gemma-3's ``5 x local + 1 x global`` period) that repeats
``num_units`` times, plus an optional non-repeating ``tail``.
Homogeneous models (most) have a unit of a single layer.  Unit parameters
are stacked on a leading ``num_units`` axis, as the reference stacks
them for its ``lax.scan``; the port loops over that axis in Python.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# Mixer kinds -----------------------------------------------------------------
ATTN = "attn"                # full (causal or bidirectional) attention
ATTN_SWA = "attn_swa"        # sliding-window attention (window from config)
ATTN_LOCAL = "attn_local"    # alias of SWA used by local:global patterns
ATTN_GLOBAL = "attn_global"  # full attention inside a local:global pattern
MAMBA = "mamba"              # selective SSM (Mamba-1, as in Jamba)
RWKV = "rwkv6"               # RWKV-6 "Finch" data-dependent-decay time mix

# MLP kinds -------------------------------------------------------------------
MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_RWKV = "rwkv_channel_mix"  # RWKV channel mix replaces the MLP
MLP_NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside a repeating unit."""

    mixer: str = ATTN
    mlp: str = MLP_DENSE


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab_size: int
    # Layer stack: unit repeated num_units times, then tail.
    unit: Tuple[LayerSpec, ...]
    num_units: int
    tail: Tuple[LayerSpec, ...] = ()

    # ---- attention ----
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // num_heads
    attention_bias: bool = False       # QKV bias (Qwen1.5)
    causal: bool = True                # False for encoder-only (HuBERT)
    sliding_window: int = 0            # window for SWA / local layers
    rope: str = "standard"             # "standard" | "mrope" | "none"
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # head_dim/2 split for M-RoPE (t,h,w)
    attn_logit_softcap: float = 0.0

    # ---- MLP ----
    d_ff: int = 0
    act: str = "swiglu"                # swiglu | gelu | geglu
    mlp_bias: bool = False

    # ---- norm / embeddings ----
    norm: str = "rmsnorm"              # rmsnorm | layernorm | layernorm_np
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scale_embeddings: bool = False     # Gemma-style sqrt(d) embed scaling

    # ---- MoE ----
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0                  # per-expert FF dim (0 -> d_ff)
    moe_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01

    # ---- RWKV-6 ----
    rwkv_head_dim: int = 64
    rwkv_lora_mix: int = 32            # token-shift DDLoRA rank
    rwkv_lora_decay: int = 64          # decay DDLoRA rank

    # ---- Mamba (Jamba-style) ----
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0             # 0 -> ceil(d_model / 16)

    # ---- modality frontend stub ----
    frontend: str = ""                 # "" | "audio" | "vision"

    # ---- runtime ----
    dtype: str = "float32"             # activation/param dtype name
    remat: object = False              # False | True (unit) | "layer"
    moe_impl: str = "auto"             # auto | dense | expert_parallel
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.unit) * self.num_units + len(self.tail)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        if self.mamba_dt_rank:
            return self.mamba_dt_rank
        return -(-self.d_model // 16)

    def all_layers(self) -> Tuple[LayerSpec, ...]:
        return self.unit * self.num_units + self.tail

    def has_mixer(self, kind: str) -> bool:
        return any(l.mixer == kind for l in self.all_layers())

    def has_attention(self) -> bool:
        return any(l.mixer.startswith("attn") for l in self.all_layers())

    def is_subquadratic(self) -> bool:
        """True when no layer keeps an unbounded full-attention KV cache.

        SSM / RWKV state is O(1); sliding-window layers keep a bounded window.
        Models that are hybrids with a *few* full-attention layers (Jamba,
        Gemma-3 local:global) are treated as effectively sub-quadratic for the
        long-context shape per DESIGN.md §5.
        """
        layers = self.all_layers()
        full = sum(1 for l in layers if l.mixer in (ATTN, ATTN_GLOBAL))
        if full == 0:
            return True
        # hybrid carve-out: bounded fraction of full-attention layers
        return full / len(layers) <= 0.25

    def is_decoder(self) -> bool:
        return self.causal

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_unit(n: int = 1, mixer: str = ATTN) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec(mixer=mixer, mlp=MLP_DENSE) for _ in range(n))


def moe_unit(n: int = 1, mixer: str = ATTN) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec(mixer=mixer, mlp=MLP_MOE) for _ in range(n))
