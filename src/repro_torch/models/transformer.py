"""The model stack: embedding -> layer units -> head.

Port of ``repro/models/transformer.py`` for dense attention decoders.
Three entry points:
  * ``forward``     — full-sequence, no cache.
  * ``prefill``     — full-sequence, returns the last logits + a filled
    decode cache.
  * ``decode_step`` — one token against the cache, which it updates in
    place.

Unit parameters keep the reference's stacked layout (every unit leaf has
a leading ``num_units`` axis; ``tail`` is a tuple), so the port's
sorted-key flatten walks the same leaves in the same order as the
reference's ``ravel_pytree`` and the chain codec's tiles fall alike.  The
reference ``lax.scan``s over that axis; here a Python loop walks it.  The
full-sequence paths take each stacked leaf apart once, with
``torch.unbind``, whose backward stacks the units' gradients in one copy
(indexing ``t[u]`` per unit would build a zero tensor of the whole stack
for every unit in the backward and sum the U of them).  ``cfg.remat``
checkpoints the units for the backward as the reference's
``jax.checkpoint`` does: ``True`` each unit, ``"layer"`` each unit and
each layer inside it (``torch.utils.checkpoint``, non-reentrant).

Mamba, RWKV-6 and MoE layers and the audio / vision frontends wait for
ROADMAP.md Queue 1 item 12: ``init_model`` and the forward paths raise
``NotImplementedError`` for them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention_decode,
    attention_forward,
    init_attention,
)
from repro_torch.models.cache import attn_cache_len
from repro_torch.models.config import MLP_DENSE, MLP_NONE, LayerSpec, ModelConfig
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_init,
    init_mlp,
    init_norm,
    not_ported,
    torch_dtype,
)
from repro_torch.tree import tree_leaves, tree_map, tree_stack


class Batch(NamedTuple):
    """Model inputs.  Any of tokens/embeds may be None depending on frontend."""

    tokens: Optional[torch.Tensor] = None        # (B,S) int
    embeds: Optional[torch.Tensor] = None        # (B,S,D)
    embed_mask: Optional[torch.Tensor] = None    # (B,S) bool: use embeds here
    positions: Optional[torch.Tensor] = None     # (B,S) int
    targets: Optional[torch.Tensor] = None       # (B,S) int
    loss_mask: Optional[torch.Tensor] = None     # (B,S) float32


def _check_layer(spec: LayerSpec) -> None:
    if not spec.mixer.startswith("attn"):
        raise not_ported(f"the {spec.mixer} mixer")
    if spec.mlp not in (MLP_DENSE, MLP_NONE):
        raise not_ported(f"the {spec.mlp} MLP")


def _check_frontend(cfg: ModelConfig) -> None:
    if cfg.frontend:
        raise not_ported(f"the {cfg.frontend} frontend")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------


def init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig, dtype):
    _check_layer(spec)
    p = {"norm1": init_norm(cfg, dtype, gen.device),
         "mixer": init_attention(gen, cfg, dtype)}
    if spec.mlp != MLP_NONE:
        p["norm2"] = init_norm(cfg, dtype, gen.device)
        p["mlp"] = init_mlp(gen, cfg, dtype)
    return p


def init_model(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The full parameter tree, drawn from ``gen`` on ``gen.device``.

    The reference's ``jax.random`` stream cannot be reproduced: parity runs
    carry the reference's params across (``repro_torch.convert``)."""
    _check_frontend(cfg)
    for spec in cfg.all_layers():
        _check_layer(spec)
    dtype = torch_dtype(cfg.dtype)
    params: dict = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype),
    }
    if cfg.num_units:
        params["units"] = tree_stack([
            tuple(init_layer(gen, spec, cfg, dtype) for spec in cfg.unit)
            for _ in range(cfg.num_units)
        ])
    params["tail"] = tuple(init_layer(gen, spec, cfg, dtype) for spec in cfg.tail)
    params["final_norm"] = init_norm(cfg, dtype, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(
            gen, cfg.vocab_size, cfg.d_model, dtype=dtype).T.contiguous()
    return params


# ----------------------------------------------------------------------------
# embedding / head
# ----------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]                   # (B,S,D)
    if cfg.scale_embeddings:
        # the reference rounds sqrt(d) to the activation dtype first; a
        # float32 tensor times a Python float does the same
        x = x * float(cfg.d_model ** 0.5)
    return x


def embed_inputs(params, cfg: ModelConfig, batch: Batch) -> torch.Tensor:
    _check_frontend(cfg)
    return _embed_tokens(params, cfg, batch.tokens)


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ----------------------------------------------------------------------------
# layer application
# ----------------------------------------------------------------------------


def apply_layer_forward(lp: dict, spec: LayerSpec, x: torch.Tensor,
                        positions: torch.Tensor, cfg: ModelConfig,
                        collect_cache: bool, max_len: int):
    """Returns (x, cache_entry_or_None)."""
    _check_layer(spec)
    h = apply_norm(lp["norm1"], x, cfg)
    cache_entry = None
    if collect_cache:
        mixed, krot, vrot = attention_forward(lp["mixer"], h, positions, cfg,
                                              spec.mixer, return_kv=True)
        cache_entry = _kv_to_cache(cfg, spec, krot, vrot, positions, max_len)
    else:
        mixed = attention_forward(lp["mixer"], h, positions, cfg, spec.mixer)
    x = x + mixed
    if spec.mlp == MLP_DENSE:
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)
    return x, cache_entry


def _kv_to_cache(cfg, spec, k, v, positions, max_len):
    """Pack prefill K/V (B,S,Kv,hd) into a decode cache entry."""
    B, S = k.shape[0], k.shape[1]
    L = attn_cache_len(cfg, spec.mixer, max_len)
    pos2d = positions[0] if positions.dim() == 3 else positions
    ck = torch.zeros((B, L) + tuple(k.shape[2:]), dtype=k.dtype, device=k.device)
    cv = torch.zeros((B, L) + tuple(v.shape[2:]), dtype=v.dtype, device=v.device)
    cp = torch.full((B, L), -1, dtype=torch.int32, device=k.device)
    if S >= L:
        # keep the last L tokens; ring-buffer slot = pos % L
        k_keep, v_keep, p_keep = k[:, S - L:], v[:, S - L:], pos2d[:, S - L:]
        slots = (p_keep % L).long()
        b_idx = torch.arange(B, device=k.device)[:, None]
        ck[b_idx, slots] = k_keep
        cv[b_idx, slots] = v_keep
        cp[b_idx, slots] = p_keep.to(torch.int32)
    else:
        ck[:, :S] = k
        cv[:, :S] = v
        cp[:, :S] = pos2d.to(torch.int32)
    return {"k": ck, "v": cv, "pos": cp}


def apply_layer_decode(lp: dict, spec: LayerSpec, x: torch.Tensor,
                       position: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One token through one layer; ``cache`` is written in place."""
    _check_layer(spec)
    h = apply_norm(lp["norm1"], x, cfg)
    mixed, _, _, _ = attention_decode(
        lp["mixer"], h, position, cache["k"], cache["v"], cache["pos"],
        cfg, spec.mixer,
    )
    x = x + mixed
    if spec.mlp == MLP_DENSE:
        x = x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)
    return x


def unit_slice(tree, u: int):
    """Unit ``u`` of a stacked unit tree (views into the stacked leaves)."""
    return tree_map(lambda t: t[u], tree)


def unbind_units(tree, n: int) -> List:
    """The ``n`` units of a stacked unit tree, each leaf taken apart once
    with ``torch.unbind`` (views into the stacked leaves)."""
    parts = [t.unbind(0) for t in tree_leaves(tree)]
    units = []
    for u in range(n):
        it = iter([p[u] for p in parts])
        units.append(tree_map(lambda _: next(it), tree))
    return units


# ----------------------------------------------------------------------------
# full model
# ----------------------------------------------------------------------------


def _default_positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[0], x.shape[1]
    return torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)


def _unit_forward(unit_params, x, positions, cfg, collect_cache, max_len):
    """One unit's layers in order: returns (x, caches)."""
    remat_layers = (cfg.remat == "layer" and not collect_cache
                    and torch.is_grad_enabled())
    caches = []
    for i, spec in enumerate(cfg.unit):
        if remat_layers:
            # per-layer checkpoint: the unit's backward re-materializes one
            # layer's internals at a time instead of the whole unit's
            x = checkpoint(lambda lp, xin, _s=spec: apply_layer_forward(
                lp, _s, xin, positions, cfg, False, 0)[0],
                unit_params[i], x, use_reentrant=False)
            caches.append(None)
        else:
            x, ce = apply_layer_forward(unit_params[i], spec, x, positions, cfg,
                                        collect_cache, max_len)
            caches.append(ce)
    return x, tuple(caches)


def _stack_forward(params, cfg, x, positions, collect_cache, max_len):
    """The units in order, then the tail layers."""
    per_unit: List[Tuple] = []
    remat = bool(cfg.remat) and not collect_cache and torch.is_grad_enabled()
    units = unbind_units(params["units"], cfg.num_units) if cfg.num_units else []
    for unit_params in units:
        if remat:
            # the unit's checkpoint; with remat == "layer" the inner
            # per-layer checkpoints bound the re-backward's working set
            x = checkpoint(lambda up, xin: _unit_forward(
                up, xin, positions, cfg, False, 0)[0],
                unit_params, x, use_reentrant=False)
        else:
            x, caches = _unit_forward(unit_params, x, positions, cfg,
                                      collect_cache, max_len)
            per_unit.append(caches)
    unit_caches = ()
    if collect_cache and cfg.num_units:
        unit_caches = tuple(
            tree_stack([per_unit[u][i] for u in range(cfg.num_units)])
            for i in range(len(cfg.unit))
        )
    tail_caches = []
    for i, spec in enumerate(cfg.tail):
        x, ce = apply_layer_forward(params["tail"][i], spec, x, positions, cfg,
                                    collect_cache, max_len)
        tail_caches.append(ce)
    return x, unit_caches, tuple(tail_caches)


def forward(params, cfg: ModelConfig, batch: Batch):
    """Full-sequence forward: returns (logits, aux_loss); the aux loss is
    the MoE router's, 0 for the dense layers ported here."""
    x = embed_inputs(params, cfg, batch)
    positions = batch.positions
    if positions is None:
        positions = _default_positions(x)
    x, _, _ = _stack_forward(params, cfg, x, positions, False, 0)
    return lm_logits(params, cfg, x), torch.zeros((), device=x.device)


def prefill(params, cfg: ModelConfig, batch: Batch, max_len: int):
    """Prefill: returns (logits_last (B,1,V), cache) with the cache filled."""
    x = embed_inputs(params, cfg, batch)
    positions = batch.positions
    if positions is None:
        positions = _default_positions(x)
    x, unit_caches, tail_caches = _stack_forward(params, cfg, x, positions,
                                                 True, max_len)
    logits = lm_logits(params, cfg, x[:, -1:])
    return logits, {"units": unit_caches, "tail": tail_caches}


def decode_step(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # (B,1) int
    position: torch.Tensor,      # (B,) int32
    cache: dict,
):
    """One decode step: returns (logits (B,1,V), cache), the cache updated
    in place."""
    _check_frontend(cfg)
    x = _embed_tokens(params, cfg, tokens)
    for u in range(cfg.num_units):
        unit_params = unit_slice(params["units"], u)
        unit_cache = unit_slice(cache["units"], u)
        for i, spec in enumerate(cfg.unit):
            x = apply_layer_decode(unit_params[i], spec, x, position,
                                   unit_cache[i], cfg)
    for i, spec in enumerate(cfg.tail):
        x = apply_layer_decode(params["tail"][i], spec, x, position,
                               cache["tail"][i], cfg)
    return lm_logits(params, cfg, x), cache
