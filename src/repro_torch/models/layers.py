"""Shared building blocks of the LM zoo: init helpers, norms, MLPs, RoPE
and M-RoPE, HuBERT's convolutional position embedding.

Port of ``repro/models/layers.py``.  Parameters are plain nested dicts of
tensors with the reference's keys and layouts (dense weights ``(in,
out)``, the conv position kernel ``(W, I, O)``); every ``init_*`` draws
from an explicit ``torch.Generator`` and makes its tensors on the
generator's device, and every ``apply`` is a function of its inputs.
Norms and RoPE compute in float32 and cast back, as the reference does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16", ...) as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# ----------------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    """Float32 normals on the generator's device, times ``std`` (in place:
    a full-width expert stack is 12.9 GB)."""
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *, dtype,
               scale: float = 1.0) -> torch.Tensor:
    return normal(gen, (in_dim, out_dim), scale / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, *, dtype) -> torch.Tensor:
    return normal(gen, (vocab, dim), 0.02).to(dtype)


# ----------------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dtype, device) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        return {
            "scale": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "bias": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        }
    if cfg.norm == "layernorm_np":  # OLMo non-parametric LN
        return {}
    raise ValueError(f"unknown norm {cfg.norm!r}")


def apply_norm(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    eps = cfg.norm_eps
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * params["scale"].to(torch.float32)).to(x.dtype)
    # layernorm variants; the variance as jnp.var takes it: the mean of the
    # squared deviations (no affine for OLMo's layernorm_np)
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = centered.square().mean(dim=-1, keepdim=True)
    y = centered * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    return y.to(x.dtype)


# ----------------------------------------------------------------------------
# activations
# ----------------------------------------------------------------------------


def act_fn(name: str):
    if name in ("swiglu", "silu"):
        return F.silu
    if name in ("gelu", "geglu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def is_gated(name: str) -> bool:
    return name in ("swiglu", "geglu")


# ----------------------------------------------------------------------------
# dense MLP
# ----------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, d_ff: int = 0) -> dict:
    d_ff = d_ff or cfg.d_ff
    p = {"down": dense_init(gen, d_ff, cfg.d_model, dtype=dtype)}
    if is_gated(cfg.act):
        p["gate"] = dense_init(gen, cfg.d_model, d_ff, dtype=dtype)
        p["up"] = dense_init(gen, cfg.d_model, d_ff, dtype=dtype)
    else:
        p["up"] = dense_init(gen, cfg.d_model, d_ff, dtype=dtype)
    if cfg.mlp_bias:
        p["up_b"] = torch.zeros((d_ff,), dtype=dtype, device=gen.device)
        p["down_b"] = torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)
    return p


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    f = act_fn(cfg.act)
    if is_gated(cfg.act):
        h = f(x @ params["gate"]) * (x @ params["up"])
    else:
        h = x @ params["up"]
        if "up_b" in params:
            h = h + params["up_b"]
        h = f(h)
    # on a mesh, h reduced first: a Partial h (a batch of one, the gated
    # product's sum over data) would make DTensor gather down's D
    from repro_torch.models.shardctx import reduce_partial

    y = reduce_partial(h) @ params["down"]
    if "down_b" in params:
        y = y + params["down_b"]
    return y


# ----------------------------------------------------------------------------
# rotary embeddings
# ----------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # the base filled on the device (a tensor made from a Python number
    # would be a blocking host-to-device copy)
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exponents)


def apply_rope(
    x: torch.Tensor,          # (B, S, H, Dh)
    positions: torch.Tensor,  # (B, S) int
    theta: float,
) -> torch.Tensor:
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs        # (B,S,Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(
    x: torch.Tensor,          # (B, S, H, Dh)
    positions: torch.Tensor,  # (3, B, S) int — (t, h, w) streams
    theta: float,
    sections: Tuple[int, ...],
) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): head_dim/2 frequency slots are partitioned
    into (temporal, height, width) sections, each rotated by its own position
    stream.  For pure-text tokens all three streams coincide and M-RoPE
    reduces exactly to standard RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # (half,)
    # the stream each frequency slot takes its position from
    stream_id = torch.cat([
        torch.full((n,), i, dtype=torch.long, device=x.device)
        for i, n in enumerate(sections)])                          # (half,)
    pos = positions.movedim(0, -1)[..., stream_id]                 # (B,S,half)
    angles = pos.to(torch.float32) * freqs
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# conv positional embedding (HuBERT-style, grouped 1-D conv over time)
# ----------------------------------------------------------------------------


def init_conv_pos(gen: torch.Generator, cfg: ModelConfig, dtype,
                  kernel: int = 31, groups: int = 16) -> dict:
    per_group = cfg.d_model // groups
    w = normal(gen, (kernel, per_group, cfg.d_model),
               1.0 / math.sqrt(kernel * per_group))
    return {"w": w.to(dtype),
            "b": torch.zeros((cfg.d_model,), dtype=dtype, device=gen.device)}


def apply_conv_pos(params: dict, x: torch.Tensor, groups: int = 16) -> torch.Tensor:
    """x: (B, S, D); a grouped conv over S with 'SAME' padding, then the
    bias and tanh-approximated GELU.  The (W, I, O) kernel is conv1d's
    (O, I, W) weight with no flip: both are cross-correlations."""
    w = params["w"]
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0),
                 padding=(w.shape[0] - 1) // 2, groups=groups)
    return F.gelu(y.transpose(1, 2) + params["b"], approximate="tanh")
