"""Stub modality frontends: batches for the audio and vision backbones.

Port of ``repro/models/frontends.py``.  The audio (HuBERT) conv feature
extractor and the VLM (Qwen2-VL) ViT encoder are not implemented, in the
reference as here; these stubs make frame / patch embeddings with the
shapes, dtypes and position semantics the real frontend would hand the
backbone, which is fully implemented.

The batches draw from a ``torch.Generator`` on its device: the reference's
``jax.random`` stream cannot be reproduced, so a parity run carries the
reference's batch across as numpy.  ``mrope_positions_for_image`` draws
nothing and equals the reference's exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import Batch


def _arange(n: int, device, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


# ----------------------------------------------------------------------------
# audio (HuBERT): 20 ms frames -> frame embeddings + masked-prediction targets
# ----------------------------------------------------------------------------


def hubert_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
                 frames: int, *, mask_prob: float = 0.08,
                 mask_span: int = 10) -> Batch:
    """A HuBERT masked-prediction training batch.

    ``embeds`` stand in for the conv-feature-extractor output; ``targets``
    are k-means cluster ids in [0, vocab); ``embed_mask`` marks masked frames
    (loss is computed only there, mirroring HuBERT's masked loss): each
    frame starts a span of ``mask_span`` frames with probability
    ``mask_prob``, the spans wrapping around the end as ``jnp.roll`` does."""
    dev = gen.device
    embeds = torch.randn((batch, frames, cfg.d_model), generator=gen,
                         device=dev).to(torch_dtype(cfg.dtype))
    targets = torch.randint(0, cfg.vocab_size, (batch, frames), generator=gen,
                            device=dev, dtype=torch.int32)
    starts = torch.rand((batch, frames), generator=gen, device=dev) < mask_prob
    mask = torch.zeros((batch, frames), dtype=torch.bool, device=dev)
    for off in range(mask_span):
        mask = mask | torch.roll(starts, off, dims=1)
    positions = _arange(frames, dev)[None].expand(batch, frames).contiguous()
    return Batch(tokens=None, embeds=embeds, embed_mask=mask,
                 positions=positions, targets=targets,
                 loss_mask=mask.to(torch.float32))


# ----------------------------------------------------------------------------
# vision (Qwen2-VL): dynamic-resolution patches + M-RoPE position streams
# ----------------------------------------------------------------------------


def mrope_positions_for_image(text_len_before: int, grid_h: int, grid_w: int,
                              text_len_after: int,
                              device="cpu") -> torch.Tensor:
    """The (3, S) int32 M-RoPE position streams for [text, image, text].

    Text tokens advance all three streams together; image patches share one
    temporal position while the h/w streams trace the patch grid — the
    Qwen2-VL scheme."""
    t = _arange(text_len_before, device)
    base = text_len_before
    hh, ww = torch.meshgrid(_arange(grid_h, device), _arange(grid_w, device),
                            indexing="ij")
    n_img = grid_h * grid_w
    after = _arange(text_len_after, device, start=base + max(grid_h, grid_w))
    img_t = torch.full((n_img,), base, dtype=torch.int32, device=device)
    return torch.stack([
        torch.cat([t, img_t, after]),
        torch.cat([t, base + hh.reshape(-1), after]),
        torch.cat([t, base + ww.reshape(-1), after]),
    ])                                                     # (3, S)


def vlm_batch(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int, *,
              image_patches: int = 0, grid: Tuple[int, int] = (0, 0)) -> Batch:
    """A Qwen2-VL-style mixed text+image training batch.

    ``embeds`` stand in for ViT->projector patch embeddings placed where
    ``embed_mask`` is True; the rest are text tokens, and only they carry
    loss."""
    dev = gen.device
    dtype = torch_dtype(cfg.dtype)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if image_patches:
        gh, gw = grid
        if gh * gw != image_patches:
            raise ValueError(f"grid {grid} is not {image_patches} patches")
        text_before = max(1, (seq - image_patches) // 2)
        text_after = seq - image_patches - text_before
        pos = mrope_positions_for_image(text_before, gh, gw, text_after, dev)
        positions = pos[:, None, :].expand(3, batch, seq).contiguous()
        emask = torch.zeros((seq,), dtype=torch.bool, device=dev)
        emask[text_before:text_before + image_patches] = True
        embed_mask = emask[None].expand(batch, seq).contiguous()
        embeds = torch.randn((batch, seq, cfg.d_model), generator=gen,
                             device=dev).to(dtype)
    else:
        positions = _arange(seq, dev)[None, None].expand(3, batch, seq).contiguous()
        embed_mask = torch.zeros((batch, seq), dtype=torch.bool, device=dev)
        embeds = torch.zeros((batch, seq, cfg.d_model), dtype=dtype, device=dev)
    return Batch(tokens=tokens, embeds=embeds, embed_mask=embed_mask,
                 positions=positions, targets=torch.roll(tokens, -1, dims=1),
                 loss_mask=(~embed_mask).to(torch.float32))


# ----------------------------------------------------------------------------
# plain text LM batch (everything else)
# ----------------------------------------------------------------------------


def lm_batch(gen: torch.Generator, cfg: ModelConfig, batch: int,
             seq: int) -> Batch:
    dev = gen.device
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    return Batch(tokens=tokens, embeds=None, embed_mask=None,
                 positions=_arange(seq, dev)[None].expand(batch, seq).contiguous(),
                 targets=torch.roll(tokens, -1, dims=1),
                 loss_mask=torch.ones((batch, seq), dtype=torch.float32,
                                      device=dev))
