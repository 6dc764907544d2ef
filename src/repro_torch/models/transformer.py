"""The model stack: embedding -> layer units -> head.

Port of ``repro/models/transformer.py``: attention, Mamba and RWKV-6
mixers with dense, MoE (the dense path) and RWKV channel-mix MLPs, and the
audio (HuBERT) and vision (Qwen2-VL) frontends.  Three entry points:
  * ``forward``     — full-sequence, no cache.
  * ``prefill``     — full-sequence, returns the last logits + a filled
    decode cache.
  * ``decode_step`` — one token against the cache, which it updates in
    place.
Each takes the reference's ``ctx``: a ``ShardCtx`` (``launch.steps.
make_moe_ctx``) pins activations and logits to its layout, gives the MoE
layers their mesh (so ``moe_impl="auto"`` takes the expert-parallel
path) and, on a DeviceMesh, runs the model under DTensor's
``implicit_replication``; without one the model runs as on one device,
its MoE layers dense.  On a DeviceMesh the decode cache is DTensors
laid out by ``launch.shardings.cache_pspecs``: the prefill builds each
rank's block from its own K / V and states (``_kv_to_cache_local``,
the Mamba mixer's local map) and the decode step writes each rank's
block in place.

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

The forward paths return the MoE router's load-balance loss summed over
the layers as the reference sums it (each unit's layers from zero, then
the units in order, then the tail).

The audio frontend takes frame embeddings (``Batch.embeds``), puts the
learned mask embedding in the masked frames and adds the convolutional
position embedding; it has no token embedding and no decode step.  The
vision frontend writes patch embeddings over the token embeddings
wherever ``embed_mask`` is set, and its positions are M-RoPE's (3, B, S)
streams.
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (
    attention_decode,
    attention_forward,
    init_attention,
)
from repro_torch.models.cache import attn_cache_len
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.config import (
    MLP_DENSE,
    MLP_MOE,
    MLP_NONE,
    MLP_RWKV,
    LayerSpec,
    ModelConfig,
)
from repro_torch.models.layers import (
    apply_conv_pos,
    apply_mlp,
    apply_norm,
    embed_init,
    init_conv_pos,
    init_mlp,
    init_norm,
    normal,
    torch_dtype,
)
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.models.shardctx import (
    as_dtensor,
    is_dtensor,
    keep_dims,
    local_part,
    shard_range,
    vocab_lookup,
)
from repro_torch.tree import tree_leaves, tree_map, tree_stack


class Batch(NamedTuple):
    """Model inputs.  Any of tokens/embeds may be None depending on frontend."""

    tokens: Optional[torch.Tensor] = None        # (B,S) int
    embeds: Optional[torch.Tensor] = None        # (B,S,D)
    embed_mask: Optional[torch.Tensor] = None    # (B,S) bool: use embeds here
    positions: Optional[torch.Tensor] = None     # (B,S) or (3,B,S) int
    targets: Optional[torch.Tensor] = None       # (B,S) int
    loss_mask: Optional[torch.Tensor] = None     # (B,S) float32


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------


def init_layer(gen: torch.Generator, spec: LayerSpec, cfg: ModelConfig, dtype,
               virtual_r: int = 1):
    p = {"norm1": init_norm(cfg, dtype, gen.device)}
    if spec.mixer.startswith("attn"):
        p["mixer"] = init_attention(gen, cfg, dtype)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba_mod.init_mamba(gen, cfg, dtype)
    elif spec.mixer == "rwkv6":
        p["mixer"] = rwkv_mod.init_rwkv_time_mix(gen, cfg, dtype)
    else:
        raise ValueError(spec.mixer)
    if spec.mlp != MLP_NONE:
        p["norm2"] = init_norm(cfg, dtype, gen.device)
    if spec.mlp == MLP_DENSE:
        p["mlp"] = init_mlp(gen, cfg, dtype)
    elif spec.mlp == MLP_MOE:
        p["mlp"] = init_moe(gen, cfg, dtype, virtual_r=virtual_r)
    elif spec.mlp == MLP_RWKV:
        p["mlp"] = rwkv_mod.init_rwkv_channel_mix(gen, cfg, dtype)
    return p


def init_model(gen: torch.Generator, cfg: ModelConfig, *,
               virtual_r: int = 1) -> dict:
    """The full parameter tree, drawn from ``gen`` on ``gen.device``.
    ``virtual_r`` splits each MoE expert into r slices of its d_ff
    (``moe.virtual_factor``: fewer experts than the model axis).

    The reference's ``jax.random`` stream cannot be reproduced: parity runs
    carry the reference's params across (``repro_torch.convert``)."""
    dtype = torch_dtype(cfg.dtype)
    params: dict = {}
    if cfg.frontend == "audio":
        params["mask_emb"] = normal(gen, (cfg.d_model,), 0.02).to(dtype)
        params["conv_pos"] = init_conv_pos(gen, cfg, dtype)
    else:
        params["embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                     dtype=dtype)
    if cfg.num_units == 1:
        # one unit: its leaves with a unit axis of 1, no copy
        params["units"] = tree_map(lambda t: t[None], tuple(
            init_layer(gen, spec, cfg, dtype, virtual_r) for spec in cfg.unit))
    elif cfg.num_units:
        # each unit drawn in turn and copied into its row of the stacked
        # leaves: the peak is the model and one unit, not the model twice
        units = None
        for u in range(cfg.num_units):
            unit = tuple(init_layer(gen, spec, cfg, dtype, virtual_r)
                         for spec in cfg.unit)
            if units is None:
                units = tree_map(lambda t: t.new_empty(
                    (cfg.num_units,) + tuple(t.shape)), unit)
            tree_map(lambda dst, src: dst[u].copy_(src), units, unit)
        params["units"] = units
    params["tail"] = tuple(init_layer(gen, spec, cfg, dtype, virtual_r)
                           for spec in cfg.tail)
    params["final_norm"] = init_norm(cfg, dtype, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(
            gen, cfg.vocab_size, cfg.d_model, dtype=dtype).T.contiguous()
    return params


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the ``meta`` device."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(cfg: ModelConfig) -> dict:
    """``init_model``'s tree as ``meta`` tensors: shapes and dtypes with no
    storage (the reference's ``jax.eval_shape(init_model)``), for
    ``param_pspecs`` of a full-size config."""
    return init_model(_MetaGenerator(), cfg)


# ----------------------------------------------------------------------------
# embedding / head
# ----------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]
    # on a mesh, each rank looks up its own vocabulary block
    x = (vocab_lookup(table, tokens) if is_dtensor(table)
         else table[tokens.long()])                      # (B,S,D)
    if cfg.scale_embeddings:
        # the reference rounds sqrt(d) to the activation dtype first; a
        # float32 tensor times a Python float does the same
        x = x * float(cfg.d_model ** 0.5)
    return x


def embed_inputs(params, cfg: ModelConfig, batch: Batch) -> torch.Tensor:
    if cfg.frontend == "audio":
        x = batch.embeds
        if batch.embed_mask is not None:
            # masked prediction: masked frames take the mask embedding
            x = torch.where(batch.embed_mask[..., None],
                            params["mask_emb"][None, None], x)
        return x + apply_conv_pos(params["conv_pos"], x)
    x = _embed_tokens(params, cfg, batch.tokens)
    if batch.embeds is not None and batch.embed_mask is not None:
        # VLM: image-pad slots take the projected patch embeddings
        x = torch.where(batch.embed_mask[..., None], batch.embeds, x)
    return x


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(params["final_norm"], x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ----------------------------------------------------------------------------
# layer application
# ----------------------------------------------------------------------------


def apply_layer_forward(lp: dict, spec: LayerSpec, x: torch.Tensor,
                        positions: torch.Tensor, cfg: ModelConfig, ctx,
                        collect_cache: bool, max_len: int):
    """Returns (x, aux_loss, cache_entry_or_None).  ``ctx`` is a
    ``ShardCtx``, a bare ``MoEShardingCtx`` or None."""
    h = apply_norm(lp["norm1"], x, cfg)
    cache_entry = None
    if spec.mixer.startswith("attn"):
        if collect_cache:
            mixed, krot, vrot = attention_forward(
                lp["mixer"], h, positions, cfg, spec.mixer, return_kv=True,
                ctx=ctx)
            cache_entry = _kv_to_cache(cfg, spec, krot, vrot, positions,
                                       max_len, ctx)
        else:
            mixed = attention_forward(lp["mixer"], h, positions, cfg,
                                      spec.mixer, ctx=ctx)
    elif spec.mixer == "mamba":
        mixed, state = mamba_mod.mamba_forward(
            lp["mixer"], h, cfg,
            layout=_state_layout(ctx, h, ("conv", "ssm"))
            if collect_cache else None)
        if collect_cache:
            cache_entry = _state_to_cache(ctx, state)
    elif spec.mixer == "rwkv6":
        mixed, tm_state = rwkv_mod.rwkv_time_mix_forward(lp["mixer"], h, cfg)
        if collect_cache:
            cache_entry = {"tm": _state_to_cache(ctx, tm_state)}
    else:
        raise ValueError(spec.mixer)
    # the mixer's output projection leaves a Partial sum over the model
    # axis; reduced here, or DTensor would carry it through the norm and
    # run the whole MLP on every model rank
    x = _pin_act(ctx, x + mixed)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.mlp != MLP_NONE:
        h2 = apply_norm(lp["norm2"], x, cfg)
        if spec.mlp == MLP_DENSE:
            x = x + apply_mlp(lp["mlp"], h2, cfg)
        elif spec.mlp == MLP_MOE:
            y, aux = apply_moe(lp["mlp"], h2, cfg, getattr(ctx, "moe", ctx))
            x = x + y
        elif spec.mlp == MLP_RWKV:
            y, cm_state = rwkv_mod.rwkv_channel_mix_forward(lp["mlp"], h2, cfg)
            x = x + y
            if cache_entry is not None:
                cache_entry["cm"] = _state_to_cache(ctx, cm_state)
    return x, aux, cache_entry


def _kv_to_cache(cfg, spec, k, v, positions, max_len, ctx=None):
    """Pack prefill K/V (B,S,Kv,hd) into a decode cache entry.  DTensor
    K / V (a DeviceMesh) are packed as the context's cache layout says
    (``_kv_to_cache_local``)."""
    if is_dtensor(k) and getattr(ctx, "cache_specs", None) is not None:
        return _kv_to_cache_local(cfg, spec, k, v, positions, max_len, ctx)
    B, S = k.shape[0], k.shape[1]
    L = attn_cache_len(cfg, spec.mixer, max_len)
    pos2d = positions[0] if positions.dim() == 3 else positions
    ck = k.new_zeros((B, L) + tuple(k.shape[2:]))
    cv = v.new_zeros((B, L) + tuple(v.shape[2:]))
    cp = pos2d.new_full((B, L), -1, dtype=torch.int32)
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


def _kv_to_cache_local(cfg, spec, k, v, positions, max_len, ctx):
    """``_kv_to_cache`` as a local map: each rank builds its own block of
    the cache (its rows, KV heads and slots, by ``ctx.cache_specs``) from
    its rows and heads of K / V, and the blocks make the DTensor cache.
    A token whose ring slot lies in another rank's block is written to a
    spare row that is dropped."""
    from repro_torch.launch.shardings import placements

    mesh = ctx.mesh
    kpl = placements(mesh, ctx.cache_specs["k"])
    ppl = placements(mesh, ctx.cache_specs["pos"])
    B, S, Kv, hd = k.shape
    L = attn_cache_len(cfg, spec.mixer, max_len)
    rows_heads = keep_dims(kpl, {0: 0, 2: 2})
    k_l, v_l = local_part(k, mesh, rows_heads), local_part(v, mesh, rows_heads)
    pos2d = positions[0] if positions.dim() == 3 else positions
    p_l = local_part(pos2d, mesh, keep_dims(kpl, {0: 0}))
    s0, n = shard_range(mesh, kpl, 1, L)
    Bl = k_l.shape[0]
    if S >= L:
        k_keep, v_keep, p_keep = k_l[:, S - L:], v_l[:, S - L:], p_l[:, S - L:]
        local = (p_keep % L).long() - s0
        slots = torch.where((local >= 0) & (local < n), local,
                            torch.full_like(local, n))
        ck = k_l.new_zeros((Bl, n + 1) + tuple(k_l.shape[2:]))
        cv = v_l.new_zeros((Bl, n + 1) + tuple(v_l.shape[2:]))
        cp = p_l.new_full((Bl, n + 1), -1, dtype=torch.int32)
        b_idx = torch.arange(Bl, device=k_l.device)[:, None]
        ck[b_idx, slots] = k_keep
        cv[b_idx, slots] = v_keep
        cp[b_idx, slots] = p_keep.to(torch.int32)
        ck, cv, cp = (t[:, :n].contiguous() for t in (ck, cv, cp))
    else:
        # token j sits in slot j: this rank's slots [s0, s0 + n)
        m = max(0, min(S, s0 + n) - s0)
        ck = k_l.new_zeros((Bl, n) + tuple(k_l.shape[2:]))
        cv = v_l.new_zeros((Bl, n) + tuple(v_l.shape[2:]))
        cp = p_l.new_full((Bl, n), -1, dtype=torch.int32)
        ck[:, :m] = k_l[:, s0:s0 + m]
        cv[:, :m] = v_l[:, s0:s0 + m]
        cp[:, :m] = p_l[:, s0:s0 + m].to(torch.int32)
    return {"k": as_dtensor(ck, mesh, kpl, (B, L, Kv, hd)),
            "v": as_dtensor(cv, mesh, kpl, (B, L, Kv, hd)),
            "pos": as_dtensor(cp, mesh, ppl, (B, L))}


def _state_layout(ctx, x, names):
    """(mesh, placements of each named state leaf) of the context's cache
    layout when ``x`` is a DTensor (a prefill on a DeviceMesh), else
    None."""
    specs = getattr(ctx, "cache_specs", None)
    if specs is None or not is_dtensor(x):
        return None
    from repro_torch.launch.shardings import placements

    return (ctx.mesh,) + tuple(placements(ctx.mesh, specs[n]) for n in names)


def _state_to_cache(ctx, state: dict) -> dict:
    """A recurrent state's leaves as cache leaves: DTensors in the
    context's cache layout (the Mamba / RWKV mixers compute them there;
    a leaf that is not is redistributed)."""
    specs = getattr(ctx, "cache_specs", None)
    if specs is None:
        return state
    from repro_torch.launch.shardings import placements

    return {key: leaf.redistribute(leaf.device_mesh,
                                   placements(leaf.device_mesh, specs[key]))
            if is_dtensor(leaf) else leaf for key, leaf in state.items()}


def _write_state(cache: dict, new: dict) -> None:
    """Copy a recurrent state's new leaves into the cache's, in place; on
    a mesh each rank copies its own block (the new leaf redistributed to
    the cache leaf's layout first, where it is not already in it)."""
    for key, leaf in new.items():
        dst = cache[key]
        if is_dtensor(dst):
            dst.to_local().copy_(leaf.redistribute(
                dst.device_mesh, dst.placements).to_local())
        else:
            dst.copy_(leaf)


def apply_layer_decode(lp: dict, spec: LayerSpec, x: torch.Tensor,
                       position: torch.Tensor, cache: dict, cfg: ModelConfig,
                       ctx=None, mrope_position: Optional[torch.Tensor] = None):
    """One token through one layer; ``cache`` is written in place."""
    h = apply_norm(lp["norm1"], x, cfg)
    if spec.mixer.startswith("attn"):
        mixed, _, _, _ = attention_decode(
            lp["mixer"], h, position, cache["k"], cache["v"], cache["pos"],
            cfg, spec.mixer, mrope_position=mrope_position,
        )
    elif spec.mixer == "mamba":
        mixed, state = mamba_mod.mamba_step(lp["mixer"], h, cfg, cache)
        _write_state(cache, state)
    elif spec.mixer == "rwkv6":
        mixed, tm = rwkv_mod.rwkv_time_mix_step(lp["mixer"], h, cfg, cache["tm"])
        _write_state(cache["tm"], tm)
    else:
        raise ValueError(spec.mixer)
    # the output projection's Partial sum reduced here, as in the forward
    x = _pin_act(ctx, x + mixed)
    if spec.mlp != MLP_NONE:
        h2 = apply_norm(lp["norm2"], x, cfg)
        if spec.mlp == MLP_DENSE:
            x = x + apply_mlp(lp["mlp"], h2, cfg)
        elif spec.mlp == MLP_MOE:
            x = x + apply_moe(lp["mlp"], h2, cfg, getattr(ctx, "moe", ctx))[0]
        elif spec.mlp == MLP_RWKV:
            y, cm = rwkv_mod.rwkv_channel_mix_forward(lp["mlp"], h2, cfg,
                                                      state=cache["cm"])
            _write_state(cache["cm"], cm)
            x = x + y
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


def _pin_act(ctx, x):
    return ctx.act(x) if hasattr(ctx, "act") else x


def _unit_forward(unit_params, x, positions, cfg, ctx, collect_cache, max_len):
    """One unit's layers in order, each output pinned to the context's
    activation layout: returns (x, aux, caches)."""
    remat_layers = (cfg.remat == "layer" and not collect_cache
                    and torch.is_grad_enabled())
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for i, spec in enumerate(cfg.unit):
        if remat_layers:
            # per-layer checkpoint: the unit's backward re-materializes one
            # layer's internals at a time instead of the whole unit's
            x, aux = checkpoint(lambda lp, xin, _s=spec: apply_layer_forward(
                lp, _s, xin, positions, cfg, ctx, False, 0)[:2],
                unit_params[i], x, use_reentrant=False)
            ce = None
        else:
            x, aux, ce = apply_layer_forward(unit_params[i], spec, x, positions,
                                             cfg, ctx, collect_cache, max_len)
        x = _pin_act(ctx, x)
        aux_total = aux_total + aux
        caches.append(ce)
    return x, aux_total, tuple(caches)


def _stack_forward(params, cfg, x, positions, ctx, collect_cache, max_len):
    """The units in order, then the tail layers: (x, aux, unit caches,
    tail caches)."""
    per_unit: List[Tuple] = []
    remat = bool(cfg.remat) and not collect_cache and torch.is_grad_enabled()
    units = unbind_units(params["units"], cfg.num_units) if cfg.num_units else []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for unit_params in units:
        if remat:
            # the unit's checkpoint; with remat == "layer" the inner
            # per-layer checkpoints bound the re-backward's working set
            x, aux = checkpoint(lambda up, xin: _unit_forward(
                up, xin, positions, cfg, ctx, False, 0)[:2],
                unit_params, x, use_reentrant=False)
        else:
            x, aux, caches = _unit_forward(unit_params, x, positions, cfg,
                                           ctx, collect_cache, max_len)
            per_unit.append(caches)
        aux_total = aux_total + aux
    unit_caches = ()
    if collect_cache and cfg.num_units:
        unit_caches = tuple(
            tree_stack([per_unit[u][i] for u in range(cfg.num_units)])
            for i in range(len(cfg.unit))
        )
    tail_caches = []
    for i, spec in enumerate(cfg.tail):
        x, aux, ce = apply_layer_forward(params["tail"][i], spec, x, positions,
                                         cfg, ctx, collect_cache, max_len)
        aux_total = aux_total + aux
        tail_caches.append(ce)
    return x, aux_total, unit_caches, tuple(tail_caches)


def _scope(ctx):
    return ctx.scope() if hasattr(ctx, "scope") else contextlib.nullcontext()


def forward(params, cfg: ModelConfig, batch: Batch, ctx=None):
    """Full-sequence forward: returns (logits, aux_loss); the aux loss is
    the MoE routers' load-balance loss (0 without MoE layers).  ``ctx`` (a
    ``ShardCtx`` from ``launch.steps.make_moe_ctx``) pins activations and
    logits to its layout and gives the MoE layers their mesh; without one
    an MoE layer under ``moe_impl="auto"`` takes the dense path."""
    with _scope(ctx):
        x = _pin_act(ctx, embed_inputs(params, cfg, batch))
        positions = batch.positions
        if positions is None:
            positions = _default_positions(x)
        x, aux, _, _ = _stack_forward(params, cfg, x, positions, ctx, False, 0)
        logits = lm_logits(params, cfg, x)
        if hasattr(ctx, "logits"):
            logits = ctx.logits(logits)
        return logits, aux


def prefill(params, cfg: ModelConfig, batch: Batch, max_len: int, ctx=None):
    """Prefill: returns (logits_last (B,1,V), cache) with the cache filled."""
    with _scope(ctx):
        x = embed_inputs(params, cfg, batch)
        positions = batch.positions
        if positions is None:
            positions = _default_positions(x)
        x = _pin_act(ctx, x)
        x, _, unit_caches, tail_caches = _stack_forward(
            params, cfg, x, positions, ctx, True, max_len)
        logits = lm_logits(params, cfg, x[:, -1:])
        if hasattr(ctx, "logits"):
            logits = ctx.logits(logits)
        return logits, {"units": unit_caches, "tail": tail_caches}


def decode_step(
    params,
    cfg: ModelConfig,
    tokens: torch.Tensor,        # (B,1) int
    position: torch.Tensor,      # (B,) int32
    cache: dict,
    ctx=None,
    mrope_position: Optional[torch.Tensor] = None,   # (3,B,1)
    embeds: Optional[torch.Tensor] = None,           # (B,1,D) frontend decode
):
    """One decode step: returns (logits (B,1,V), cache), the cache updated
    in place.  ``embeds``, when given, replace the token embeddings."""
    if cfg.frontend == "audio":
        raise ValueError("encoder-only architectures have no decode step")
    with _scope(ctx):
        x = _pin_act(ctx, embeds if embeds is not None
                     else _embed_tokens(params, cfg, tokens))
        for u in range(cfg.num_units):
            unit_params = unit_slice(params["units"], u)
            unit_cache = unit_slice(cache["units"], u)
            for i, spec in enumerate(cfg.unit):
                x = apply_layer_decode(unit_params[i], spec, x, position,
                                       unit_cache[i], cfg, ctx, mrope_position)
                x = _pin_act(ctx, x)
        for i, spec in enumerate(cfg.tail):
            x = apply_layer_decode(params["tail"][i], spec, x, position,
                                   cache["tail"][i], cfg, ctx, mrope_position)
        logits = lm_logits(params, cfg, x)
        if hasattr(ctx, "logits"):
            logits = ctx.logits(logits)
        return logits, cache
