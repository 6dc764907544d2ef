"""Architecture registry: ``--arch <id>`` resolution for the launcher.

Port of ``repro/configs/registry.py``; the ten arch configs beside it are
data only and copied as they are."""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from repro_torch.configs import (
    gemma3_4b,
    hubert_xlarge,
    jamba_15_large,
    mixtral_8x7b,
    olmo_1b,
    phi4_mini,
    qwen15_4b,
    qwen2_vl_7b,
    qwen3_moe_30b,
    rwkv6_7b,
)

_MODULES = {
    m.ARCH_ID: m
    for m in (
        hubert_xlarge,
        qwen15_4b,
        olmo_1b,
        rwkv6_7b,
        mixtral_8x7b,
        qwen3_moe_30b,
        phi4_mini,
        jamba_15_large,
        gemma3_4b,
        qwen2_vl_7b,
    )
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, **kw) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id].get_config(**kw)


def smoke_config(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (matches init_model's tree)."""
    D, V = cfg.d_model, cfg.vocab_size
    hd = cfg.resolved_head_dim
    total = 0
    if cfg.frontend != "audio":
        total += V * D                       # embed
    else:
        total += D                           # mask_emb
        total += 31 * (D // 16) * D + D      # conv pos
    if not cfg.tie_embeddings:
        total += V * D                       # lm head
    norm_p = {"rmsnorm": D, "layernorm": 2 * D, "layernorm_np": 0}[cfg.norm]
    for spec in cfg.all_layers():
        total += norm_p                      # norm1
        if spec.mixer.startswith("attn"):
            total += D * cfg.num_heads * hd + 2 * D * cfg.num_kv_heads * hd
            total += cfg.num_heads * hd * D
            if cfg.attention_bias:
                total += cfg.num_heads * hd + 2 * cfg.num_kv_heads * hd
        elif spec.mixer == "mamba":
            din, ds = cfg.mamba_d_inner, cfg.mamba_d_state
            dtr = cfg.resolved_dt_rank
            total += D * 2 * din + cfg.mamba_d_conv * din + din
            total += din * (dtr + 2 * ds) + dtr * din + din
            total += din * ds + din + din * D
            total += dtr + 2 * ds            # jamba dt/B/C norms
        elif spec.mixer == "rwkv6":
            L1, L2 = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
            total += D + 5 * D               # mus
            total += D * 5 * L1 + 5 * L1 * D # mix lora
            total += 5 * D * D               # r,k,v,g,o
            total += D + D * L2 + L2 * D     # decay
            total += D + 2 * D               # u + groupnorm
        if spec.mlp != "none":
            total += norm_p                  # norm2
        if spec.mlp == "dense":
            n = 3 if cfg.act in ("swiglu", "geglu") else 2
            total += n * D * cfg.d_ff
        elif spec.mlp == "moe":
            F = cfg.resolved_moe_d_ff
            n = 3 if cfg.act in ("swiglu", "geglu") else 2
            total += D * cfg.num_experts + cfg.num_experts * n * D * F
        elif spec.mlp == "rwkv_channel_mix":
            total += 2 * D + D * cfg.d_ff + cfg.d_ff * D + D * D
    total += norm_p                          # final norm
    return total


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters active per token (MoE counts only top-k experts)."""
    if cfg.num_experts == 0:
        return param_count(cfg)
    full = param_count(cfg)
    F = cfg.resolved_moe_d_ff
    n = 3 if cfg.act in ("swiglu", "geglu") else 2
    per_expert = n * cfg.d_model * F
    n_moe = sum(1 for s in cfg.all_layers() if s.mlp == "moe")
    inactive = n_moe * (cfg.num_experts - cfg.num_experts_per_tok) * per_expert
    return full - inactive
