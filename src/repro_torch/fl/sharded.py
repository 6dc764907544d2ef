"""The sharded round engine: the BFLC stages over a ``torch.distributed``
data mesh.

Port of ``repro/fl/sharded.py``.  The reference drives every device of a
1-D ``("data",)`` mesh from one process with ``shard_map``; here each rank
is a process (``repro_torch.launch.mesh.make_round_mesh``) that runs the
round's whole host pipeline from the same seed — numpy rng draws,
consensus, election, rewards and the chain — so the host state is
replicated and every rank's chain is the same.  Only device work is split
across ranks, and explicit collectives gather it at the points where the
reference's arrays reach the host or a replicated use:

* ``local_trainer = "local_sgd_sharded"`` — each rank trains its block of
  the P clients (``make_sharded_local_train_fn``); ``finalize`` gathers the
  update stack.  Batch sampling and attack injection are ``local_sgd``'s,
  so a seed gives the same rng stream.
* ``validator = "committee_sharded"`` — each rank scores its P-block of
  candidates against the whole params and member batches; the (P, Q)
  score matrix is gathered.  The rank's block comes straight from the
  trainer (``ctx.cohort_stacked``) when no row was poisoned.
* ``validator = "committee_int8_sharded"`` (opt-in) — each rank flattens
  and quantizes its P-block with the chain codec and scores the fused
  candidates; the scores and the (q, scales) rows are gathered, and the
  rows are cached for the packer.
* ``packer = "top_k_int8_sharded"`` — the packed (K, D) stack is
  quantized D-slice by D-slice (``make_quantize_stack_sharded``; tiles are
  2048-lane aligned, so each slice's scales are the single-device codec's),
  the (K, Dpad) int8 stack and scales are gathered, and the blobs land on
  the chain in the ``{"q", "scales", "d"}`` schema, ``padded_dim_sharded``
  lanes wide.
* ``aggregator = "fused_int8_sharded"`` — each rank runs the fused int8
  aggregation on its D-slice; the (Dpad,) model block is gathered.

The stages read their programs from ``RoundContext`` (``sharded_*_fn``,
built once per runtime by ``BFLCRuntime(..., mesh=...)``; see
``repro_torch.api.build_runtime``).  On the CPU,
``repro_torch.hostdevices.spawn_world`` runs N gloo ranks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.aggregation import flatten_updates, normalize_weights
from repro_torch.fl.pipeline import (
    CommitteeValidator,
    LocalSGDTrainer,
    RoundContext,
    _commit_aggregate,
    _select_top_k,
    _set_packed,
    cache_row_quant,
    cached_row_stack,
    poison_cohort_updates,
    register,
    sample_cohort_batches,
)
from repro_torch.kernels.ops import padded_dim_sharded
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.launch.shardings import round_engine_pspecs, score_matrix_pspecs
from repro_torch.tree import tree_leaves, tree_map, tree_stack, tree_unstack

CLIENTS = round_engine_pspecs()["clients"]
DSHARD = round_engine_pspecs()["dshard"]
DVEC = round_engine_pspecs()["dvec"]
UPDATES = score_matrix_pspecs()["updates"]
INT8_ROWS = score_matrix_pspecs()["int8_rows"]
SCORES = score_matrix_pspecs()["scores"]


def _require(ctx: RoundContext, field: str, stage: str):
    fn = getattr(ctx, field)
    if fn is None:
        raise RuntimeError(
            f"{stage} needs ctx.{field} — build the runtime with a mesh "
            "(build_runtime(..., mesh=make_round_mesh(n)))"
        )
    return fn


def _pad_rows(tree, n: int, ndev: int):
    """Pad the leading (client) axis of a stacked tree of tensors or numpy
    arrays to a multiple of the mesh size by repeating the last row.
    Per-row programs (local SGD, committee scoring) are independent rows
    of a batched program, so padded rows never touch real clients and
    their results are sliced off."""
    pad = (-n) % ndev
    if pad == 0:
        return tree

    def grow(x):
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
        return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])

    return tree_map(grow, tree)


def _pad_clients(xs, ys, ndev: int):
    """The trainer's batch padding: one ``_pad_rows`` over the (xs, ys)
    pair (tensors or numpy arrays)."""
    P = xs.shape[0]
    xs, ys = _pad_rows((xs, ys), P, ndev)
    return xs, ys, P


def _shard_rows(mesh, stacked, n: int):
    """This rank's block of a P-stacked tree every rank holds, padded first."""
    return tree_map(lambda x: mesh.shard(x, UPDATES),
                    _pad_rows(stacked, n, mesh.size))


def score_rows(ctx: RoundContext, score_fn, stacked, n: int, vx, vy):
    """The (n, Q) scores of n stacked candidates, each rank scoring its
    block (the tier-2 round's sub-aggregates use this too)."""
    mesh = ctx.mesh
    block = score_fn(ctx.params, _shard_rows(mesh, stacked, n), vx, vy)
    return mesh.gather(block, SCORES)[:n]


class ShardedLocalSGDTrainer(LocalSGDTrainer):
    """(2, sharded) cohort-batched local SGD, the clients split over the
    mesh's ranks.  ``dispatch`` draws the batches (every rank draws all of
    them from its own device's copy of the community, so the rng stream is
    the sequential one), pads them to the mesh and launches the rank's
    block, which stays on the rank as ``ctx.cohort_stacked`` for the
    sharded validator; ``finalize`` gathers the update stack, drops the
    padded rows and injects the attacks."""

    def dispatch(self, ctx: RoundContext) -> None:
        train_fn = _require(ctx, "sharded_train_fn", "local_sgd_sharded")
        mesh = _require(ctx, "mesh", "local_sgd_sharded")
        xs, ys = sample_cohort_batches(ctx)
        xs, ys, _ = _pad_clients(xs, ys, mesh.size)
        block = train_fn(ctx.params, xs, ys)
        ctx.cohort_stacked = block
        ctx.train_inflight = block

    def finalize(self, ctx: RoundContext) -> None:
        # the whole stack is needed on every rank: poisoning, per-uploader
        # bookkeeping (ctx.updates) and packing are replicated host work
        stacked = tree_map(lambda x: ctx.mesh.gather(x, CLIENTS),
                           ctx.train_inflight)
        ctx.train_inflight = None
        updates = tree_unstack(stacked, len(ctx.trainers))  # padding dropped
        poison_cohort_updates(ctx, updates)
        ctx.cohort_updates = updates


train_local_sgd_sharded = register("local_trainer", "local_sgd_sharded")(
    ShardedLocalSGDTrainer()
)


def _cohort_block(ctx: RoundContext):
    """The rank's P-block of the cohort's updates: the trainer's own block
    while it still equals the host-side update list (no row poisoned),
    else the rank's block of the restacked updates."""
    if ctx.cohort_stacked is not None and not ctx.cohort_poisoned:
        return ctx.cohort_stacked
    return _shard_rows(ctx.mesh, tree_stack(ctx.cohort_updates),
                       len(ctx.cohort_updates))


class ShardedCommitteeValidator(CommitteeValidator):
    """(3, sharded) the P x Q committee score matrix, each rank scoring its
    P-block of candidates; only the (P, Q) matrix is gathered.  Consensus
    bookkeeping (collusion overlay, median acceptance, trigger) is
    ``CommitteeValidator``'s."""

    def _scores_device(self, ctx: RoundContext) -> torch.Tensor:
        score_fn = _require(ctx, "sharded_score_fn", "committee_sharded")
        mesh = _require(ctx, "mesh", "committee_sharded")
        block = score_fn(ctx.params, _cohort_block(ctx), ctx.val_x, ctx.val_y)
        return mesh.gather(block, SCORES)[:len(ctx.cohort_updates)]


register("validator", "committee_sharded")(ShardedCommitteeValidator())


class Int8ShardedCommitteeValidator(CommitteeValidator):
    """(3, sharded, opt-in) fused score-from-int8: each rank quantizes its
    P-block of update rows with the chain codec and scores the candidates
    the fused kernel rebuilds from them, so the committee scores exactly
    the blobs a quantizing packer stores.  The scores and the (q, scales)
    rows are gathered; the rows go to the row-quant cache."""

    def _scores_device(self, ctx: RoundContext) -> torch.Tensor:
        score_fn = _require(ctx, "sharded_int8_score_fn",
                            "committee_int8_sharded")
        mesh = _require(ctx, "mesh", "committee_int8_sharded")
        block = _cohort_block(ctx)
        scores, q, s = score_fn(ctx.params, block, ctx.val_x, ctx.val_y)
        d = sum(leaf[0].numel() for leaf in tree_leaves(block))
        cache_row_quant(ctx, mesh.gather(q, INT8_ROWS),
                        mesh.gather(s, INT8_ROWS), d)
        return mesh.gather(scores, SCORES)[:len(ctx.cohort_updates)]


register("validator", "committee_int8_sharded")(Int8ShardedCommitteeValidator())


def _pad_cached_to_shards(q: torch.Tensor, s: torch.Tensor, d: int,
                          ndev: int):
    """Widen cached rows from the single-device width ``padded_dim(d)`` to
    the sharded width ``padded_dim_sharded(d, ndev)``.  The extra tiles are
    all-zero, and the codec maps an all-zero tile to q = 0 and scale = 1.0,
    so appending exactly that equals quantizing the wider stack."""
    pad = padded_dim_sharded(d, ndev) - q.shape[1]
    if pad:
        q = F.pad(q, (0, pad))
        s = F.pad(s, (0, pad // BLOCK_D), value=1.0)
    return q, s


@register("packer", "top_k_int8_sharded")
def pack_top_k_int8_sharded(ctx: RoundContext) -> None:
    """Sharding-aware quantized packing: flatten the packed updates once,
    quantize each rank's D-slice of the (K, D) stack, gather the int8
    stack and scales, store the int8 rows as update blocks and hand the
    stack to the sharded aggregator.  Rows the int8 validator already
    quantized come from the row-quant cache, zero-padded to the shard
    boundary, instead."""
    quantize_fn = _require(ctx, "sharded_quantize_fn", "top_k_int8_sharded")
    mesh = _require(ctx, "mesh", "top_k_int8_sharded")
    _set_packed(ctx, _select_top_k(ctx))
    cached = cached_row_stack(ctx)
    if cached is not None:
        q, s, d = cached
        q, s = _pad_cached_to_shards(q, s, d, mesh.size)
        unravel = ctx.chain.codec.unravel
    else:
        stack, unravel = flatten_updates(ctx.packed_updates)
        d = int(stack.shape[1])
        q, s = (mesh.gather(x, DSHARD) for x in quantize_fn(stack))
    for i, (u, sc) in enumerate(zip(ctx.packed_ids, ctx.packed_scores)):
        ctx.chain.append_update(
            {"q": q[i], "scales": s[i], "d": d}, u, sc, encoded=True
        )
        ctx.manager.nodes[u].score_history.append(sc)
    ctx.packed_quantized = (q, s, d, unravel)


@register("aggregator", "fused_int8_sharded")
def aggregate_fused_int8_sharded(ctx: RoundContext) -> None:
    """(4, sharded) fused one-pass aggregation of each rank's D-slice of
    the chain's int8 stack; the reduced slices are gathered into the
    model block every rank commits."""
    agg_fn = _require(ctx, "sharded_agg_fn", "fused_int8_sharded")
    if ctx.packed_quantized is None:
        raise RuntimeError(
            "fused_int8_sharded aggregator needs a quantizing packer (e.g. "
            "'top_k_int8_sharded') to stage the int8 stack in "
            "ctx.packed_quantized"
        )
    q, s, d, unravel = ctx.packed_quantized
    w = normalize_weights(q.shape[0], ctx.weights, q.device)
    flat = ctx.mesh.gather(agg_fn(q, s, w), DVEC)[:d]
    _commit_aggregate(ctx, unravel(flat))
