"""Grouped-query attention with RoPE / M-RoPE, causal, bidirectional and
sliding-window masking, plus a KV cache for decode.

Port of ``repro/models/attention.py``.  Two execution paths, as there:

* ``_dense_attention`` materializes the (S_q, S_kv) scores; used for
  sequences up to ``DENSE_MAX`` and single-token decode.
* over ``DENSE_MAX``, ``models.flash.flash_attention``: the online
  softmax over 512-key blocks with a recompute backward, K and V first
  expanded to the H query heads.  It needs S to be a multiple of 512 and
  has no logit softcap; otherwise ``ValueError`` (never a fall back to
  the dense path).

The reference's ``_chunked_attention`` has no caller there and is not
ported.  Attention is plain PyTorch (matmuls and a float32 masked
softmax), as the reference's is plain JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ATTN_LOCAL, ATTN_SWA, ModelConfig
from repro_torch.models.flash import (
    flash_attention,
    local_attention,
    pick_q_block,
)
from repro_torch.models.layers import apply_mrope, apply_rope, dense_init
from repro_torch.models.shardctx import (
    all_reducer,
    as_dtensor,
    grad_like,
    is_dtensor,
    keep_dims,
    local_groups,
    local_part,
    shard_range,
    softmax_merge,
    unshard_dim,
)

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
    qg = unshard_dim(qf, 2, Kv).reshape(B, Sq, Kv, G, Dh)
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
    # on a mesh, a head count the model axis does not divide: the
    # projection's columns are gathered before the heads are split
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    return (
        unshard_dim(q, 2, H).reshape(B, S, H, hd),
        unshard_dim(k, 2, Kv).reshape(B, S, Kv, hd),
        unshard_dim(v, 2, Kv).reshape(B, S, Kv, hd),
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
    ctx=None,
):
    """Full-sequence attention (training / prefill, no cache).

    With ``return_kv=True`` also returns the rotated K and V (for prefill
    cache construction).  A ``ShardCtx`` pins Q / K / V to its head
    layout, and on a model axis of M > 1 the flash path's blocks to
    heads over model (H % M == 0) or, failing that, to Q blocks over
    model (``pick_q_block``), as the reference does."""
    q, k, v = _project_qkv(params, x, cfg)
    q = _rotate(q, positions, cfg)
    k = _rotate(k, positions, cfg)
    if ctx is not None and hasattr(ctx, "kv"):
        # head-shard Q/K/V when head counts divide the model axis
        q = ctx.q(q)
        k = ctx.kv(k)
        v = ctx.kv(v)
    pos2d = positions[0] if positions.dim() == 3 else positions
    window = cfg.sliding_window if is_windowed(mixer) else 0
    if x.shape[1] <= DENSE_MAX:
        def attend(q_, k_, v_, q_pos, kv_pos):
            mask = _pair_mask(q_pos, kv_pos, causal=cfg.causal, window=window)
            return _dense_attention(q_, k_, v_, mask, cfg.attn_logit_softcap)

        if (getattr(ctx, "model_size", 1) > 1 and ctx.q_spec is not None
                and is_dtensor(q)):
            # heads over model: each rank's rows and heads on their own
            # (DTensor cannot flatten batch and heads both split to one
            # product's batch; torch 2.11 refuses it)
            k_h, v_h = k, v
            if k.shape[2] % ctx.model_size:    # KV expanded to the H heads
                G = cfg.num_heads // cfg.num_kv_heads
                k_h = ctx.q(k.repeat_interleave(G, dim=2))
                v_h = ctx.q(v.repeat_interleave(G, dim=2))
            out = local_attention(attend, q, k_h, v_h, pos2d, pos2d, ctx.mesh,
                                  ctx.dp, None, ctx.model_axis)
        else:
            out = attend(q, k, v, pos2d, pos2d)
    else:
        if cfg.attn_logit_softcap > 0:
            raise ValueError("the flash path has no logit softcap")
        # KV expanded to the full H heads, as the reference does
        G = cfg.num_heads // cfg.num_kv_heads
        k_e = k.repeat_interleave(G, dim=2) if G > 1 else k
        v_e = v.repeat_interleave(G, dim=2) if G > 1 else v
        if ctx is not None and hasattr(ctx, "q"):
            k_e = ctx.q(k_e)
            v_e = ctx.q(v_e)
        # block_spec over the canonical (B, nq, Kv, G, QB, ...) layout
        q_block, block_spec, mesh = 512, None, None
        if ctx is not None and getattr(ctx, "model_size", 1) > 1:
            mesh = ctx.mesh
            if ctx.q_spec is not None:     # H % mesh == 0: shard heads
                block_spec = (ctx.dp, None, ctx.model_axis, None, None, None)
            else:                          # shard the q-block dim instead
                q_block = pick_q_block(x.shape[1], ctx.model_size)
                block_spec = (ctx.dp, ctx.model_axis, None, None, None, None)
        out = flash_attention(q, k_e, v_e, pos2d, pos2d, cfg.causal, window,
                              q_block=q_block, block_spec=block_spec,
                              mesh=mesh)
    B, Sq = out.shape[0], out.shape[1]
    out = grad_like(out.reshape(B, Sq, -1)) @ params["wo"]
    if return_kv:
        return out, k, v
    return out


def _rotate_decode(q, k, position, mrope_position, cfg: ModelConfig):
    """The new token's Q and K rotated by its position (an M-RoPE model by
    ``mrope_position`` when given, else the position on all three
    streams)."""
    if cfg.rope == "mrope":
        rp = (mrope_position if mrope_position is not None
              else position[None, :, None].expand(3, position.shape[0], 1))
        q = apply_mrope(q, rp, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, rp, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope != "none":
        q = apply_rope(q, position[:, None], cfg.rope_theta)
        k = apply_rope(k, position[:, None], cfg.rope_theta)
    return q, k


def _merged_attention(q, k, v, mask, softcap: float, reduce) -> torch.Tensor:
    """``_dense_attention`` over keys split across ranks: this rank's
    partial softmax over its slots, joined by ``shardctx.softmax_merge``
    (``reduce`` all-reduces over the ranks that split the keys)."""
    B, Sq, H, Dh = q.shape
    Kv = k.shape[2]
    qg = (q.to(torch.float32) * (Dh ** -0.5)).reshape(B, Sq, Kv, H // Kv, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    if scores.shape[-1]:
        m = torch.amax(scores, dim=-1, keepdim=True)
        e = torch.exp(scores - m)
        l = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgqs,bskd->bkgqd", e, v.to(torch.float32))
    else:                  # a rank that holds no slot of the cache
        m = scores.new_full(scores.shape[:-1] + (1,), NEG_INF)
        l = torch.zeros_like(m)
        o = m.new_zeros(scores.shape[:-1] + (Dh,))
    out = softmax_merge(m, l, o, reduce)                  # (B, Kv, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)


def _write_slot(cache, new, rows, local_slot, n_local: int, whole_len: bool):
    """``cache[rows, local_slot] = new`` for the rows whose slot lies in
    this rank's block of ``n_local`` slots (all of them when the block is
    the whole sequence); the other rows keep their values."""
    if whole_len:
        cache[rows, local_slot] = new
        return
    if not n_local:
        return
    hit = (local_slot >= 0) & (local_slot < n_local)
    idx = local_slot.clamp(0, n_local - 1)
    keep = cache[rows, idx]
    cache[rows, idx] = torch.where(
        hit.reshape(hit.shape + (1,) * (keep.dim() - 1)), new, keep)


def attention_decode(
    params: dict,
    x: torch.Tensor,            # (B,1,D)
    position: torch.Tensor,     # (B,) int32 absolute position of the new token
    cache_k: torch.Tensor,      # (B,Sc,Kv,Dh)  rotated keys
    cache_v: torch.Tensor,      # (B,Sc,Kv,Dh)
    cache_pos: torch.Tensor,    # (B,Sc) absolute position per slot (-1 invalid)
    cfg: ModelConfig,
    mixer: str,
    mrope_position: Optional[torch.Tensor] = None,   # (3,B,1) for mrope
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a (possibly ring-buffer) KV cache.

    Returns (out, cache_k, cache_v, cache_pos).  The cache tensors are
    written in place (the new token's slot) and returned: the reference's
    engine donates them to the step for the same effect.  Keys are stored
    rotated, so the cache never needs re-rotation.  Sliding-window layers
    use a ring buffer: slot = position % Sc.  An M-RoPE model rotates by
    ``mrope_position`` when it is given, else by the position on all three
    streams.

    A cache of DTensors (a DeviceMesh; ``launch.shardings.cache_pspecs``)
    is read and written as a local map: each rank takes its rows and KV
    heads of the new token's Q / K / V, writes them into its block only
    when the slot ``position % Sc`` falls in it, and attends over its
    slots; a sequence split over ranks joins the partial softmaxes with
    ``shardctx.softmax_merge`` (the reference's "small psums").
    """
    q, k, v = _project_qkv(params, x, cfg)
    if is_dtensor(cache_k):
        out = _decode_local_map(q, k, v, position, cache_k, cache_v,
                                cache_pos, cfg, mixer, mrope_position)
        return out @ params["wo"], cache_k, cache_v, cache_pos
    q, k = _rotate_decode(q, k, position, mrope_position, cfg)

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


def _decode_local_map(q, k, v, position, cache_k, cache_v, cache_pos,
                      cfg: ModelConfig, mixer: str, mrope_position):
    """``attention_decode``'s body on each rank's blocks of a DTensor
    cache (batch over the data axes, and KV heads or the sequence over
    model / data, as its placements say).  Returns the attention output
    (B, 1, H * Dh) as a DTensor: rows as the cache's, heads as its KV
    heads."""
    mesh = cache_k.device_mesh
    pl = tuple(cache_k.placements)
    B, Sc = cache_k.shape[0], cache_k.shape[1]
    H, Dh = q.shape[2], q.shape[3]
    rows_heads = keep_dims(pl, {0: 0, 2: 2})
    q_l, k_l, v_l = (local_part(t, mesh, rows_heads) for t in (q, k, v))
    pos_l = local_part(position, mesh, keep_dims(pl, {0: 0}))
    mrope_l = (None if mrope_position is None else
               local_part(mrope_position, mesh, keep_dims(pl, {0: 1})))
    q_l, k_l = _rotate_decode(q_l, k_l, pos_l, mrope_l, cfg)

    ck, cv, cp = cache_k.to_local(), cache_v.to_local(), cache_pos.to_local()
    s0, n = shard_range(mesh, pl, 1, Sc)
    slot = (pos_l % Sc).long() - s0
    rows = torch.arange(ck.shape[0], device=ck.device)
    for cache, new in ((ck, k_l[:, 0].to(ck.dtype)), (cv, v_l[:, 0].to(cv.dtype)),
                       (cp, pos_l.to(cp.dtype))):
        _write_slot(cache, new, rows, slot, n, n == Sc)

    window = cfg.sliding_window if is_windowed(mixer) else 0
    mask = _pair_mask(pos_l[:, None], cp, causal=cfg.causal, window=window)
    groups = local_groups(mesh, pl, 1)
    if groups:
        out = _merged_attention(q_l, ck, cv, mask, cfg.attn_logit_softcap,
                                all_reducer(groups))
    else:
        out = _dense_attention(q_l, ck, cv, mask, cfg.attn_logit_softcap)
    return as_dtensor(out.reshape(out.shape[0], 1, -1), mesh, rows_heads,
                      (B, 1, H * Dh))
