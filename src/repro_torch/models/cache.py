"""Decode-cache containers for the layer stack.

Port of ``repro/models/cache.py``.  A model cache is ``{"units": stacked, "tail": (per-layer, ...)}``, where
``stacked`` is a tuple over the unit's layers whose leaves carry a
leading ``num_units`` axis, as the reference's scanned cache does.

Per-layer cache by mixer kind:
  attn / attn_global : {"k": (B, max_len, Kv, hd), "v": ..., "pos": (B, max_len)}
  attn_swa / local   : same, but length min(window, max_len) (ring buffer)
  mamba              : {"conv": (B, dc-1, din), "ssm": (B, din, ds) f32}
  rwkv6              : {"tm": {shift (B, D), wkv (B, H, dh, dh) f32},
                        "cm": {shift (B, D)}}
A recurrent state has no position: every leaf of a slot's row is
overwritten when a request is inserted, so nothing of the slot's last
request survives.
"""
from __future__ import annotations

import torch

from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.attention import is_windowed
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.shardctx import is_dtensor, local_part, shard_range
from repro_torch.tree import tree_map


def attn_cache_len(cfg: ModelConfig, mixer: str, max_len: int) -> int:
    if is_windowed(mixer) and cfg.sliding_window > 0:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype, device="cpu"):
    if spec.mixer.startswith("attn"):
        L = attn_cache_len(cfg, spec.mixer, max_len)
        hd = cfg.resolved_head_dim
        return {
            "k": torch.zeros((batch, L, cfg.num_kv_heads, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, L, cfg.num_kv_heads, hd), dtype=dtype,
                             device=device),
            "pos": torch.full((batch, L), -1, dtype=torch.int32, device=device),
        }
    if spec.mixer == "mamba":
        return mamba_mod.init_mamba_state(cfg, batch, dtype, device)
    if spec.mixer == "rwkv6":
        return rwkv_mod.init_rwkv_state(cfg, batch, dtype, device)
    raise ValueError(spec.mixer)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cpu", *, mesh=None, pol=None,
               batch_sharded: bool = True) -> dict:
    """A fresh decode cache (zeros, slot positions -1).  With a
    ``DeviceMesh`` (and its ``ShardingPolicy``) every leaf is a DTensor
    laid out by ``cache_pspecs(..., batch_sharded=batch_sharded)``, each
    rank allocating only its own block."""
    if mesh is not None and not getattr(mesh, "is_local", False):
        from repro_torch.launch.shardings import cache_pspecs, map_specs
        from repro_torch.models.shardctx import full_dtensor

        shapes = init_cache(cfg, batch, max_len, dtype, "meta")
        return map_specs(
            lambda spec, t: full_dtensor(
                tuple(t.shape), -1 if t.dtype == torch.int32 else 0,
                t.dtype, device, mesh, spec),
            cache_pspecs(cfg, shapes, pol, batch_sharded=batch_sharded),
            shapes)
    unit = tuple(
        init_layer_cache(cfg, spec, batch, max_len, dtype, device)
        for spec in cfg.unit
    )
    stacked = tree_map(
        lambda x: x[None].expand((cfg.num_units,) + tuple(x.shape)).clone()
        if cfg.num_units else x,
        unit,
    )
    tail = tuple(
        init_layer_cache(cfg, spec, batch, max_len, dtype, device)
        for spec in cfg.tail
    )
    return {"units": stacked, "tail": tail}


def insert_slot_cache(cache: dict, slot_cache: dict, b: int) -> dict:
    """Write a batch-1 cache (one request, e.g. fresh from prefill) into batch
    row ``b`` of a batched decode cache, in place, and return it.

    This is the continuous-batching admission primitive: a finished slot's
    rows are overwritten by the next request's prefilled KV state, with no
    barrier on the other slots.  Unit leaves carry the stacked
    ``(num_units, B, ...)`` layout (batch axis 1); tail leaves are plain
    ``(B, ...)`` (batch axis 0).

    On a mesh (DTensor leaves) the write is shard-local: only the ranks
    whose block holds row ``b`` write, each its own slots or heads of the
    request's row (the slot cache is first laid out as the batched
    cache's row: whole over the data axes, its slots or heads split as
    the batched cache's).
    """

    def ins(axis):
        def f(big, small):
            if is_dtensor(big):
                _insert_local(big, small, b, axis)
                return big
            big.narrow(axis, b, small.shape[axis]).copy_(small)
            return big
        return f

    return {
        "units": tree_map(ins(1), cache["units"], slot_cache["units"]),
        "tail": tree_map(ins(0), cache["tail"], slot_cache["tail"]),
    }


def _insert_local(big, small, b: int, axis: int) -> None:
    """``insert_slot_cache`` on one DTensor leaf: the request's row in the
    leaf's layout but whole over the batch, copied by the ranks that own
    row ``b``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = big.device_mesh, tuple(big.placements)
    row_pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == axis
                   else p for p in pl)
    row = local_part(small, mesh, row_pl)
    b0, n = shard_range(mesh, pl, axis, big.shape[axis])
    if b0 <= b < b0 + n:
        big.to_local().narrow(axis, b - b0, row.shape[axis]).copy_(row)
