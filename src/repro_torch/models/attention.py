"""Grouped-query attention with RoPE, causal, bidirectional and
sliding-window masking, plus a KV cache for decode.

Port of ``repro/models/attention.py``, dense path only:
``_dense_attention`` materializes the (S_q, S_kv) scores, which covers
sequences up to ``DENSE_MAX`` and single-token decode, everything a
serving node at these lengths runs.  The reference's chunked / flash
path for longer sequences (``models/flash.py``) waits for ROADMAP.md
Queue 1 item 12(e) and raises, as M-RoPE (item 12(d)) does.  Attention is plain PyTorch (matmuls and a
float32 masked softmax), as the reference's is plain JAX.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import ATTN_LOCAL, ATTN_SWA, ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init, not_ported

DENSE_MAX = 2048     # max sequence length for the dense path

NEG_INF = -1e30


def is_windowed(mixer: str) -> bool:
    return mixer in (ATTN_SWA, ATTN_LOCAL)


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype=dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype=dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype=dtype),
        "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype=dtype),
    }
    if cfg.attention_bias:
        dev = gen.device
        p["bq"] = torch.zeros((cfg.num_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dtype, device=dev)
    return p


# ----------------------------------------------------------------------------
# masking
# ----------------------------------------------------------------------------


def _pair_mask(
    q_pos: torch.Tensor,   # (..., Sq)
    kv_pos: torch.Tensor,  # (..., Skv)  (absolute positions; -1 = invalid slot)
    *,
    causal: bool,
    window: int,
) -> torch.Tensor:
    """Boolean (..., Sq, Skv) mask — True where attention is allowed."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    ok = k >= 0
    if causal:
        ok = ok & (k <= q)
    if window > 0:
        ok = ok & (q - k < window)
    return ok


# ----------------------------------------------------------------------------
# core attention computation
# ----------------------------------------------------------------------------


def _dense_attention(q, k, v, mask, softcap: float) -> torch.Tensor:
    """q: (B,Sq,H,Dh); k,v: (B,Skv,Kv,Dh); mask: (B,Sq,Skv) bool."""
    B, Sq, H, Dh = q.shape
    Kv = k.shape[2]
    G = H // Kv
    qf = q.to(torch.float32) * (Dh ** -0.5)
    qg = qf.reshape(B, Sq, Kv, G, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(torch.float32))
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


# ----------------------------------------------------------------------------
# public entry points
# ----------------------------------------------------------------------------


def _project_qkv(params, x, cfg: ModelConfig):
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return (
        q.reshape(B, S, cfg.num_heads, hd),
        k.reshape(B, S, cfg.num_kv_heads, hd),
        v.reshape(B, S, cfg.num_kv_heads, hd),
    )


def _rotate(x, positions, cfg: ModelConfig):
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if positions.dim() == 3:  # m-rope style positions on a standard-rope model
        positions = positions[0]
    return apply_rope(x, positions, cfg.rope_theta)


def attention_forward(
    params: dict,
    x: torch.Tensor,          # (B,S,D)
    positions: torch.Tensor,  # (B,S) or (3,B,S)
    cfg: ModelConfig,
    mixer: str,
    return_kv: bool = False,
):
    """Full-sequence attention (training / prefill, no cache).

    With ``return_kv=True`` also returns the rotated K and V (for prefill
    cache construction)."""
    S = x.shape[1]
    if S > DENSE_MAX:
        raise not_ported(f"attention over S = {S} > DENSE_MAX = {DENSE_MAX} "
                         f"(the chunked / flash path)")
    q, k, v = _project_qkv(params, x, cfg)
    q = _rotate(q, positions, cfg)
    k = _rotate(k, positions, cfg)
    pos2d = positions[0] if positions.dim() == 3 else positions
    window = cfg.sliding_window if is_windowed(mixer) else 0
    mask = _pair_mask(pos2d, pos2d, causal=cfg.causal, window=window)
    out = _dense_attention(q, k, v, mask, cfg.attn_logit_softcap)
    B, Sq = out.shape[0], out.shape[1]
    out = out.reshape(B, Sq, -1) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


def attention_decode(
    params: dict,
    x: torch.Tensor,            # (B,1,D)
    position: torch.Tensor,     # (B,) int32 absolute position of the new token
    cache_k: torch.Tensor,      # (B,Sc,Kv,Dh)  rotated keys
    cache_v: torch.Tensor,      # (B,Sc,Kv,Dh)
    cache_pos: torch.Tensor,    # (B,Sc) absolute position per slot (-1 invalid)
    cfg: ModelConfig,
    mixer: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a (possibly ring-buffer) KV cache.

    Returns (out, cache_k, cache_v, cache_pos).  The cache tensors are
    written in place (the new token's slot) and returned: the reference's
    engine donates them to the step for the same effect.  Keys are stored
    rotated, so the cache never needs re-rotation.  Sliding-window layers
    use a ring buffer: slot = position % Sc.
    """
    q, k, v = _project_qkv(params, x, cfg)
    if cfg.rope == "mrope":
        raise not_ported("M-RoPE decode")
    if cfg.rope != "none":
        q = apply_rope(q, position[:, None], cfg.rope_theta)
        k = apply_rope(k, position[:, None], cfg.rope_theta)

    Sc = cache_k.shape[1]
    window = cfg.sliding_window if is_windowed(mixer) else 0
    # Ring-buffer slot.  For full-attention layers Sc == max_len so this is
    # just ``position``; for windowed layers it wraps around the window.
    slot = (position % Sc).long()

    b_idx = torch.arange(x.shape[0], device=x.device)
    cache_k[b_idx, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[b_idx, slot] = v[:, 0].to(cache_v.dtype)
    cache_pos[b_idx, slot] = position.to(cache_pos.dtype)

    q_pos = position[:, None]                       # (B,1)
    mask = _pair_mask(q_pos, cache_pos, causal=cfg.causal, window=window)
    out = _dense_attention(q, cache_k, cache_v, mask, cfg.attn_logit_softcap)
    B = out.shape[0]
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, cache_k, cache_v, cache_pos
