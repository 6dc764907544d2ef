"""Prefill and decode steps for serving.

Port of the serving half of ``repro/launch/steps.py``.  The reference's
steps take a mesh and a ``ShardingPolicy``; on one card there is nothing
to shard, so the port's take neither.  The MoE sharding context and the
train step wait for ROADMAP.md Queue 1 items 12 and 13.
"""
from __future__ import annotations

import torch

from repro_torch.models import decode_step as model_decode_step
from repro_torch.models import prefill as model_prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Batch


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch: Batch):
        return model_prefill(params, cfg, batch, max_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, return_logits: bool = True):
    """One greedy decode step.

    ``return_logits=False`` drops the (B, 1, V) logits from the outputs:
    the serving hot loop only needs the argmax token.  The cache is
    updated in place and returned."""

    def serve_step(params, tokens, position, cache):
        logits, new_cache = model_decode_step(params, cfg, tokens, position,
                                              cache)
        next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        if return_logits:
            return next_token[:, None], logits, new_cache
        return next_token[:, None], new_cache

    return serve_step
