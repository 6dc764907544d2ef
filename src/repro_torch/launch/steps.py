"""Sharded train / prefill / decode steps.

Port of ``repro/launch/steps.py``.  Every step takes the reference's
``mesh`` and ``ShardingPolicy``; ``mesh=None, pol=None`` is the 1 x 1
``LocalMesh`` and the reference's one-device policy (the reference's
``make_host_mesh(1, 1)`` default of its engine and trainer).  Each builds
the reference's ``ShardCtx`` (``make_moe_ctx``), so an MoE model under
``moe_impl="auto"`` takes the expert-parallel path with its capacity
dispatch on every mesh, the 1 x 1 one included.

On a ``DeviceMesh`` the parameters are DTensors
(``launch.shardings.distribute`` by ``param_pspecs``) and the batch may
be one too (by ``batch_pspecs``); the model runs its plain PyTorch code
on them under DTensor's sharding propagation (``ShardCtx.scope``), the
counterpart of the reference's GSPMD.  The train step redistributes
each gradient to its parameter's own placements before the optimizer
step, so no ``Partial`` reaches the update.

Two training flavours:

* ``standard`` — plain token-mean cross-entropy (the Basic-FL /
  centralized baseline at scale).
* ``bflc``     — the paper's technique in-graph: the batch is split into
  **cohorts** (the production analogue of FL trainer nodes) and a
  **committee of validation shards** scores each cohort; member j scores
  cohort c by -|loss_c - val_loss_j|, the median over j, softmaxed over
  cohorts, weights each cohort's loss, so the gradient is the
  committee-weighted FedAvg of per-cohort gradients.  Poisoned cohorts
  show anomalous loss and are downweighted.

Where the reference stops gradients (the cohort losses in the scores,
the weights, the validation params), the port detaches and runs the
validation forward under ``torch.no_grad()``: the values are the same and
no graph is kept for it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.launch.mesh import LocalMesh
from repro_torch.launch.shardings import ShardingPolicy, cache_leaf_specs
from repro_torch.models import decode_step as model_decode_step
from repro_torch.models import forward
from repro_torch.models import prefill as model_prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoEShardingCtx
from repro_torch.models.shardctx import (
    ShardCtx,
    is_dtensor,
    make_shard_ctx,
    replicate,
    vocab_argmax,
    whole,
)
from repro_torch.models.transformer import Batch
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_map


def one_device_policy() -> ShardingPolicy:
    """The reference engine's policy for its 1 x 1 mesh."""
    return ShardingPolicy(dp_axes=("data",), dp_sizes=(1,),
                          model_axis_size=1, fsdp=False)


def _mesh_pol(mesh, pol):
    return (LocalMesh() if mesh is None else mesh,
            one_device_policy() if pol is None else pol)


def make_moe_ctx(cfg: ModelConfig, mesh, pol: ShardingPolicy,
                 *, batch_sharded: bool) -> ShardCtx:
    """Builds the ShardCtx (activation constraints + MoE mesh context)."""
    moe = None
    if cfg.num_experts:
        moe = MoEShardingCtx(
            mesh=mesh,
            dp_axes=pol.dp_axes,
            model_axis=pol.model_axis,
            batch_sharded=batch_sharded,
            tp_over_dp=pol.moe_tp_over_dp,
        )
    return make_shard_ctx(
        mesh, pol.dp_axes, pol.model_axis,
        batch_sharded=batch_sharded, moe=moe,
        num_kv_heads=cfg.num_kv_heads, num_heads=cfg.num_heads,
        seq_parallel=pol.seq_parallel_acts and batch_sharded,
        act_shard_d=pol.act_shard_d and batch_sharded,
        cache_specs=cache_leaf_specs(cfg, pol, batch_sharded=batch_sharded),
    )


# ----------------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------------


def token_ce(logits, targets, loss_mask):
    """Per-token NLL, ``lse - z[target]`` with a constant max shift, as the
    reference writes it.  The reference takes ``z[target]`` as
    ``one_hot · z`` (so a model-sharded vocab reduces with psums); on one
    card a gather gives the same value (every other term is 0 · z) without
    a (B, S, V) one-hot.  Logits compute in at least float32.  On a mesh
    the vocabulary is sharded over model: there the reference's one-hot
    product reduces each rank's slice (a ``gather`` along a sharded
    dimension has no sharding rule, and would all-gather the logits)."""
    z = logits.to(torch.promote_types(logits.dtype, torch.float32))
    m = torch.amax(z, dim=-1, keepdim=True).detach()
    z = z - m
    lse = torch.log(torch.sum(torch.exp(z), dim=-1))
    if is_dtensor(z):
        if not is_dtensor(targets):
            from torch.distributed.tensor import DTensor, Replicate

            targets = DTensor.from_local(
                targets, z.device_mesh, (Replicate(),) * z.device_mesh.ndim,
                run_check=False)
        onehot = torch.nn.functional.one_hot(targets.long(), z.shape[-1])
        tgt = torch.einsum("...v,...v->...", z, onehot.to(z.dtype))
    else:
        tgt = torch.gather(z, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    mask = loss_mask.to(nll.dtype)
    return nll * mask, mask


def standard_loss(params, cfg, batch: Batch, ctx=None):
    logits, aux = forward(params, cfg, batch, ctx)
    nll, mask = token_ce(logits, batch.targets, batch.loss_mask)
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux, loss


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the mean of the two middle values
    when the count is even (``torch.median`` would take the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def bflc_loss(params, cfg, batch: Batch, val_batch: Batch, ctx=None,
              num_cohorts: int = 16, committee_size: int = 8):
    """Committee-weighted cohort loss (the paper's technique, in-graph)."""
    logits, aux = forward(params, cfg, batch, ctx)
    nll, mask = token_ce(logits, batch.targets, batch.loss_mask)
    # on a mesh the (B, S) losses are gathered before the cohort split: a
    # batch split over both mesh axes does not view as (cohorts, B / C, S)
    nll, mask = replicate(nll), replicate(mask)
    B = nll.shape[0]
    nll_c = nll.reshape(num_cohorts, B // num_cohorts, -1)
    mask_c = mask.reshape(num_cohorts, B // num_cohorts, -1)
    cohort_loss = nll_c.sum(dim=(1, 2)) / torch.clamp(
        mask_c.sum(dim=(1, 2)), min=1.0)                   # (C,)

    # committee validation shards: per-member mean loss, no gradient
    with torch.no_grad():
        vlogits, _ = forward(params, cfg, val_batch, ctx)
        vnll, vmask = token_ce(vlogits, val_batch.targets,
                               val_batch.loss_mask)
        del vlogits
        member_loss = vnll.sum(dim=-1) / torch.clamp(vmask.sum(dim=-1),
                                                     min=1.0)
        member_loss = member_loss[:committee_size]          # (Q,)

        weights = committee_weights(cohort_loss.detach(), member_loss)

    loss = torch.sum(weights * cohort_loss)
    return loss + aux, loss


def committee_weights(cohort_loss, member_loss):
    """(C,) cohort losses, (Q,) member losses -> (C,) cohort weights.

    Member j's score for cohort c is -|loss_c - val_loss_j|; the median
    over j, softmaxed over cohorts and scaled by the medians' std (ddof 0,
    as jnp's), weights each cohort."""
    scores = -torch.abs(cohort_loss[:, None] - member_loss[None, :])
    med = _median_last(scores)
    return torch.softmax(
        med / torch.clamp(med.std(correction=0), min=1e-6), dim=0)


# ----------------------------------------------------------------------------
# train step
# ----------------------------------------------------------------------------


class TrainState(NamedTuple):
    params: dict
    opt_state: dict
    step: torch.Tensor


def _split_microbatches(batch: Batch, mb: int) -> Batch:
    """Reshape every field's batch dim B -> (mb, B/mb); M-RoPE positions
    (3,B,S) split on axis 1."""

    def split(name, x):
        if x is None:
            return None
        if name == "positions" and x.dim() == 3:
            return torch.movedim(
                x.reshape(x.shape[0], mb, -1, x.shape[2]), 1, 0)
        return x.reshape(mb, -1, *x.shape[1:])

    return Batch(**{k: split(k, v) for k, v in batch._asdict().items()})


def _microbatch(batch: Batch, i: int) -> Batch:
    return Batch(**{k: None if v is None else v[i]
                    for k, v in batch._asdict().items()})


def _as_param(g, p):
    """The gradient in its parameter's placements: a ``Partial`` sum from
    sharding propagation is reduced here, before the optimizer sees it."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_grad_fn(
    cfg: ModelConfig,
    mesh=None,
    pol: Optional[ShardingPolicy] = None,
    *,
    mode: str = "bflc",
    num_cohorts: int = 16,
    committee_size: int = 8,
    num_microbatches: int = 1,
) -> Callable:
    """``grad_fn(params, batch, val_batch) -> (grads, total, ce)``: the
    loss's gradients as a tree like ``params`` (each in its parameter's
    placements) and both losses (0-d tensors, no graph).  With
    ``num_microbatches > 1`` the gradients of the microbatches are
    accumulated as ``acc + g / mb`` from zeros, the reference's scan, and
    the losses are their means."""
    if mode not in ("standard", "bflc"):
        raise ValueError(f"unknown mode {mode!r}")
    mesh, pol = _mesh_pol(mesh, pol)
    ctx = make_moe_ctx(cfg, mesh, pol, batch_sharded=True)

    def loss_for(p, b: Batch, val_batch):
        if mode == "bflc":
            return bflc_loss(p, cfg, b, val_batch, ctx, num_cohorts,
                             committee_size)
        return standard_loss(p, cfg, b, ctx)

    def value_and_grad(params, b: Batch, val_batch):
        with ctx.scope(), torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            leaves = tree_leaves(p)
            total, ce = loss_for(p, b, val_batch)
            grads = iter([_as_param(g, t) for g, t in
                          zip(torch.autograd.grad(total, leaves), leaves)])
        return (tree_map(lambda _: next(grads), params),
                whole(total.detach()), whole(ce.detach()))

    def grad_fn(params, batch: Batch, val_batch: Optional[Batch] = None):
        if num_microbatches == 1:
            return value_and_grad(params, batch, val_batch)
        mbs = _split_microbatches(batch, num_microbatches)
        gacc = tree_map(torch.zeros_like, params)
        totals, ces = [], []
        for i in range(num_microbatches):
            g, tot, ce_mb = value_and_grad(params, _microbatch(mbs, i),
                                           val_batch)
            with ctx.scope():
                gacc = tree_map(
                    lambda a, gg: a + (gg / num_microbatches).to(a.dtype),
                    gacc, g)
            del g
            totals.append(tot)
            ces.append(ce_mb)
        return gacc, torch.stack(totals).mean(), torch.stack(ces).mean()

    grad_fn.ctx = ctx
    return grad_fn


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    mesh=None,
    pol: Optional[ShardingPolicy] = None,
    *,
    mode: str = "bflc",
    num_cohorts: int = 16,
    committee_size: int = 8,
    num_microbatches: int = 1,
):
    """``train_step(state, batch, val_batch=None) -> (state, metrics)``:
    one optimizer step on the gradients of ``mode``'s loss.  ``metrics``
    holds ``loss`` (the cross-entropy) and ``total_loss`` as 0-d tensors
    on the state's device; nothing in the step waits for the device.  On
    a ``DeviceMesh`` the state's params and moments are DTensors
    (``distribute``), updated in their own placements."""
    grad_fn = make_grad_fn(cfg, mesh, pol, mode=mode, num_cohorts=num_cohorts,
                           committee_size=committee_size,
                           num_microbatches=num_microbatches)

    def train_step(state: TrainState, batch: Batch,
                   val_batch: Optional[Batch] = None):
        grads, total, ce = grad_fn(state.params, batch, val_batch)
        with grad_fn.ctx.scope():
            new_params, new_opt = optimizer.update(
                grads, state.opt_state, state.params, state.step)
        return TrainState(new_params, new_opt, state.step + 1), {
            "loss": ce,
            "total_loss": total,
        }

    return train_step


# ----------------------------------------------------------------------------
# serving steps
# ----------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      pol: Optional[ShardingPolicy] = None,
                      max_len: Optional[int] = None, *,
                      batch_sharded: bool = True):
    """``prefill_step(params, batch) -> (logits (B, 1, V), cache)``.  On a
    DeviceMesh the cache is DTensors laid out by ``cache_pspecs(...,
    batch_sharded=batch_sharded)``, each rank holding its own blocks."""
    if max_len is None:
        raise TypeError("make_prefill_step needs max_len")
    mesh, pol = _mesh_pol(mesh, pol)
    ctx = make_moe_ctx(cfg, mesh, pol, batch_sharded=batch_sharded)

    def prefill_step(params, batch: Batch):
        return model_prefill(params, cfg, batch, max_len, ctx)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None,
                     pol: Optional[ShardingPolicy] = None, *,
                     batch_sharded: bool = True,
                     return_logits: bool = True):
    """One greedy decode step.

    ``return_logits=False`` drops the (B, 1, V) logits from the outputs:
    the serving hot loop only needs the argmax token.  The cache is
    updated in place and returned.  An M-RoPE model takes its (3, B, 1)
    positions as ``mrope_position`` (default: ``position`` on all three
    streams).  On a DeviceMesh the cache is taken and returned laid out by
    ``cache_pspecs(..., batch_sharded=batch_sharded)`` (``init_cache``
    with the mesh, or the prefill step's); tokens and positions may be
    plain tensors every rank holds or DTensors by ``decode_pspecs``, and
    the next token comes back by ``decode_pspecs`` (batch over the data
    axes), the logits vocabulary-split over model."""
    mesh, pol = _mesh_pol(mesh, pol)
    ctx = make_moe_ctx(cfg, mesh, pol, batch_sharded=batch_sharded)

    def serve_step(params, tokens, position, cache, mrope_position=None):
        logits, new_cache = model_decode_step(
            params, cfg, tokens, position, cache, ctx,
            mrope_position=mrope_position)
        with ctx.scope():
            # on a mesh, each vocabulary shard's max and index, the pairs
            # gathered (DTensor's own argmax over a split dimension fails
            # on a batch of one)
            next_token = vocab_argmax(logits[:, -1, :])
        if return_logits:
            return next_token[:, None], logits, new_cache
        return next_token[:, None], new_cache

    return serve_step
