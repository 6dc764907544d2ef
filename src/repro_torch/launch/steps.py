"""Train, prefill and decode steps on one card.

Port of ``repro/launch/steps.py``.  The reference's steps take a mesh and
a ``ShardingPolicy``; on one card there is nothing to shard, so the
port's take neither (the sharded train step and the MoE sharding
context are ROADMAP.md Queue 1 item 11).

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

from repro_torch.models import decode_step as model_decode_step
from repro_torch.models import forward
from repro_torch.models import prefill as model_prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Batch
from repro_torch.optim import Optimizer
from repro_torch.tree import tree_leaves, tree_map


# ----------------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------------


def token_ce(logits, targets, loss_mask):
    """Per-token NLL, ``lse - z[target]`` with a constant max shift, as the
    reference writes it.  The reference takes ``z[target]`` as
    ``one_hot · z`` (so a model-sharded vocab reduces with psums); on one
    card a gather gives the same value (every other term is 0 · z) without
    a (B, S, V) one-hot.  Logits compute in at least float32."""
    z = logits.to(torch.promote_types(logits.dtype, torch.float32))
    m = torch.amax(z, dim=-1, keepdim=True).detach()
    z = z - m
    lse = torch.log(torch.sum(torch.exp(z), dim=-1))
    tgt = torch.gather(z, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    mask = loss_mask.to(nll.dtype)
    return nll * mask, mask


def standard_loss(params, cfg, batch: Batch):
    logits, aux = forward(params, cfg, batch)
    nll, mask = token_ce(logits, batch.targets, batch.loss_mask)
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux, loss


def _median_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the mean of the two middle values
    when the count is even (``torch.median`` would take the lower one)."""
    s = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


def bflc_loss(params, cfg, batch: Batch, val_batch: Batch,
              num_cohorts: int, committee_size: int):
    """Committee-weighted cohort loss (the paper's technique, in-graph)."""
    logits, aux = forward(params, cfg, batch)
    nll, mask = token_ce(logits, batch.targets, batch.loss_mask)
    B = nll.shape[0]
    nll_c = nll.reshape(num_cohorts, B // num_cohorts, -1)
    mask_c = mask.reshape(num_cohorts, B // num_cohorts, -1)
    cohort_loss = nll_c.sum(dim=(1, 2)) / torch.clamp(
        mask_c.sum(dim=(1, 2)), min=1.0)                   # (C,)

    # committee validation shards: per-member mean loss, no gradient
    with torch.no_grad():
        vlogits, _ = forward(params, cfg, val_batch)
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


def make_grad_fn(
    cfg: ModelConfig,
    *,
    mode: str = "bflc",
    num_cohorts: int = 16,
    committee_size: int = 8,
    num_microbatches: int = 1,
) -> Callable:
    """``grad_fn(params, batch, val_batch) -> (grads, total, ce)``: the
    loss's gradients as a tree like ``params`` and both losses (0-d
    tensors, no graph).  With ``num_microbatches > 1`` the gradients of
    the microbatches are accumulated as ``acc + g / mb`` from zeros, the
    reference's scan, and the losses are their means."""
    if mode not in ("standard", "bflc"):
        raise ValueError(f"unknown mode {mode!r}")

    def loss_for(p, b: Batch, val_batch):
        if mode == "bflc":
            return bflc_loss(p, cfg, b, val_batch, num_cohorts, committee_size)
        return standard_loss(p, cfg, b)

    def value_and_grad(params, b: Batch, val_batch):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            leaves = tree_leaves(p)
            total, ce = loss_for(p, b, val_batch)
            grads = iter(torch.autograd.grad(total, leaves))
        return (tree_map(lambda _: next(grads), params), total.detach(),
                ce.detach())

    def grad_fn(params, batch: Batch, val_batch: Optional[Batch] = None):
        if num_microbatches == 1:
            return value_and_grad(params, batch, val_batch)
        mbs = _split_microbatches(batch, num_microbatches)
        gacc = tree_map(torch.zeros_like, params)
        totals, ces = [], []
        for i in range(num_microbatches):
            g, tot, ce_mb = value_and_grad(params, _microbatch(mbs, i),
                                           val_batch)
            gacc = tree_map(lambda a, gg: a + (gg / num_microbatches).to(a.dtype),
                            gacc, g)
            del g
            totals.append(tot)
            ces.append(ce_mb)
        return gacc, torch.stack(totals).mean(), torch.stack(ces).mean()

    return grad_fn


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    mode: str = "bflc",
    num_cohorts: int = 16,
    committee_size: int = 8,
    num_microbatches: int = 1,
):
    """``train_step(state, batch, val_batch=None) -> (state, metrics)``:
    one optimizer step on the gradients of ``mode``'s loss.  ``metrics``
    holds ``loss`` (the cross-entropy) and ``total_loss`` as 0-d tensors
    on the state's device; nothing in the step waits for the device."""
    grad_fn = make_grad_fn(cfg, mode=mode, num_cohorts=num_cohorts,
                           committee_size=committee_size,
                           num_microbatches=num_microbatches)

    def train_step(state: TrainState, batch: Batch,
                   val_batch: Optional[Batch] = None):
        grads, total, ce = grad_fn(state.params, batch, val_batch)
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
