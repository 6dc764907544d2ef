"""Hierarchical committee rounds (paper §V's network-sharding scale-out).

Port of ``repro/fl/hier.py`` for one device.  A tiered round splits the
round's active non-committee nodes into S sub-communities, runs committee
consensus inside each, and lets the round committee judge the S
sub-results.  Three registered stages build it over the flat pipeline:

* ``sampler = "tiered"`` — partitions the round's active non-committee
  nodes into S slices, each with its own sub-committee (the slice's
  top-reputation members) and trainer set.  Slice s IS cohort s: the
  pipeline's cohort loop becomes the streaming ingest loop.
* ``validator = "hier"`` — per slice, swaps the round committee for the
  slice's sub-committee and delegates to an INNER validator (any
  registered one: ``committee``, ``committee_int8``, ``accept_all``, ...).
  After each slice it reduces the accepted updates to one sub-aggregate
  (on an int8 chain the fused kernel emits the chain-ready blob in one
  pass, ``aggregate_quantized(..., quantize_out=True)``) and then drops the
  slice's update stack, so the peak update-stack memory is bounded by the
  largest slice, never the whole round's.
* ``packer = "hier"`` — the tier-2 committee round: the round committee
  scores the S sub-aggregates with the tier-1 score program, runs
  committee consensus over them (best first, so a poisoned sub-aggregate
  fails the relative threshold against the honest ones), packs the
  accepted sub-aggregates as the round's update blocks and appends the
  tier-2 committee block (members, score matrix, accept mask) that the
  tiered chain layout requires.

``BFLCRuntime`` wires this up from ``cfg.tiers > 1``
(``build_runtime(..., tiers=S)``); ``tiers=1`` is the flat pipeline.  The
reference's multi-device branches (``ctx.mesh``) belong to the sharded
rounds, which this port does not have yet (ROADMAP.md Queue 1 item 11).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import aggregate_pytrees, flatten_updates
from repro_torch.core.consensus import CommitteeConsensus
from repro_torch.fl.client import sample_client_batches
from repro_torch.fl.pipeline import (
    RoundContext,
    build_pipeline,
    cached_row_stack,
    default_stage_names,
    register,
    resolve,
)
from repro_torch.tree import tree_leaves, tree_stack


@dataclass
class HierSlice:
    """One tier-1 sub-community: its trainers and its sub-committee."""

    index: int
    trainers: List[int]
    committee: List[int]


@dataclass
class HierState:
    """Per-round state of a tiered round, threaded via ``ctx.hier``.

    The runtime builds one per round (``cfg.tiers > 1``); stages fill it
    in.  ``peak_stack_bytes`` is the high-water mark of update stacks held
    at once, against the whole round's stack (``flat_stack_bytes``)."""

    tiers: int
    inner_validator: Any
    dim: int = 0                           # flat update dimension D
    slices: List[HierSlice] = field(default_factory=list)
    # tier-1 products, one entry per processed slice
    sub_aggregates: List[Any] = field(default_factory=list)
    sub_blobs: List[Optional[dict]] = field(default_factory=list)
    sub_uploaders: List[int] = field(default_factory=list)
    sub_contributors: List[List[int]] = field(default_factory=list)
    t1_validations: int = 0
    # tier-2 inputs/outputs
    val_x2: Any = None
    val_y2: Any = None
    tier2_scores: Any = None               # (S, Q2) after pack
    # memory accounting
    peak_stack_bytes: int = 0
    flat_stack_bytes: int = 0
    max_slice_rows: int = 0
    # hier-validator slice bookkeeping between dispatch and finalize
    saved_committee: Any = None
    inner_split: bool = False

    def note_stack(self, nbytes: int) -> None:
        self.peak_stack_bytes = max(self.peak_stack_bytes, int(nbytes))


def _require_hier(ctx: RoundContext, stage: str) -> HierState:
    if ctx.hier is None:
        raise RuntimeError(
            f"{stage} needs ctx.hier — build the runtime with tiers >= 2 "
            "(build_runtime(..., tiers=S))"
        )
    return ctx.hier


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    # scalar leaves (a blob's "d") count as the reference counts them
    return int(np.asarray(leaf).nbytes)


def _tree_nbytes(tree) -> int:
    return sum(_leaf_nbytes(l) for l in tree_leaves(tree))


def _slice_stack_nbytes(ctx: RoundContext) -> int:
    """Bytes of the update stack currently buffered for this slice."""
    if not ctx.cohort_updates:
        return 0
    return len(ctx.cohort_updates) * _tree_nbytes(ctx.cohort_updates[0])


# ----------------------------------------------------------------------
# tier-1 sampler: slice the round into sub-communities
# ----------------------------------------------------------------------
def _partition_round(ctx: RoundContext, st: HierState) -> None:
    cfg, rng = ctx.cfg, ctx.rng
    S = st.tiers
    active = ctx.manager.sample_active(rng, cfg.active_proportion)
    committee = set(ctx.round_committee)
    pool = [i for i in active if i not in committee]
    # each slice needs a >= 3-member sub-committee (median robustness, the
    # runtime's q_committee floor) plus at least one trainer
    if len(pool) < 4 * S:
        raise ValueError(
            f"tiers={S} needs at least {4 * S} active non-committee nodes "
            f"for 3-member sub-committees + trainers, have {len(pool)}"
        )
    order = [int(x) for x in rng.permutation(np.asarray(pool, dtype=np.int64))]
    base = len(order) // S
    q_sub = min(max(3, int(round(base * cfg.committee_fraction))), base - 1)
    bounds = np.linspace(0, len(order), S + 1).astype(int)
    slices = []
    for s in range(S):
        members = order[bounds[s]:bounds[s + 1]]
        # slice sub-committee: the slice's top-reputation members (a stable
        # sort, so ties keep permutation order, as fill_committee ranks)
        ranked = sorted(members,
                        key=lambda i: -ctx.manager.nodes[i].latest_score)
        sub_committee = sorted(ranked[:q_sub])
        trainers = [i for i in members if i not in set(sub_committee)]
        slices.append(HierSlice(s, trainers, sub_committee))
        st.max_slice_rows = max(st.max_slice_rows, len(trainers))
    st.slices = slices


@register("sampler", "tiered")
def sample_tiered(ctx: RoundContext) -> None:
    """(1, tiered) cohort s = slice s: the active set is partitioned into S
    sub-communities once per round (cohort 0), then each cohort trains
    exactly one slice."""
    st = _require_hier(ctx, "tiered sampler")
    if ctx.cohort == 0:
        _partition_round(ctx, st)
    ctx.trainers = (st.slices[ctx.cohort].trainers
                    if ctx.cohort < len(st.slices) else [])


# scheduling contract for an asynchronous runner: the partition is frozen
# at cohort 0, so slice s+1's trainers depend only on the sampler having
# run for slice s, not on slice s's validation; rng is drawn at cohort 0
# only
sample_tiered.prefetch_safe = True
sample_tiered.rng_first_only = True


# ----------------------------------------------------------------------
# tier-1 validator: per-slice committee consensus + sub-aggregation
# ----------------------------------------------------------------------
def _aggregate_slice(ctx: RoundContext, ids: List[int],
                     weights: Optional[List[float]]):
    """Reduce one slice's accepted updates to a sub-aggregate.

    Quantized chains: the fused int8 kernel emits the chain-ready blob
    directly (``quantize_out=True``), from the validator's cached per-row
    (q, scales) when the inner validator was an int8 one.  Returns
    (sub_aggregate tree, blob or None)."""
    cfg = ctx.cfg
    # slices are smaller than the flat round's k_updates; clamp the trim so
    # the trimmed mean stays defined per slice
    trim = min(getattr(cfg, "trim", 1), (len(ids) - 1) // 2)
    if getattr(cfg, "quantize_chain", False):
        from repro_torch.kernels.ops import aggregate_quantized, quantize_stack

        cached = cached_row_stack(ctx, ids)
        if cached is not None:
            q, s, d = cached
        else:
            stack, _ = flatten_updates([ctx.updates[u] for u in ids])
            q, s, d = quantize_stack(stack)
        bq, bs, _ = aggregate_quantized(
            q, s, d, method=cfg.aggregation, weights=weights, trim=trim,
            quantize_out=True,
        )
        blob = {"q": bq, "scales": bs, "d": d}
        # tier 2 scores (and the chain stores) exactly this blob: decode it
        # so downstream consumers see the stored content, bit for bit
        return ctx.chain.codec.decode(blob), blob
    sub = aggregate_pytrees(
        [ctx.updates[u] for u in ids], method=cfg.aggregation,
        weights=weights, trim=trim,
        use_kernels=getattr(cfg, "use_kernels", False),
    )
    return sub, None


class HierValidator:
    """(3, tiered) the tier-1 stage: per slice, swap in the slice's
    sub-committee, delegate scoring + consensus to the INNER validator,
    reduce the accepted updates to one sub-aggregate, then free the slice
    buffer.  Only one slice's update stack is alive at a time.

    ``dispatch`` / ``finalize`` split the slice where an inner validator
    with its own split would wait for its score program; ``__call__`` runs
    both back to back."""

    def prepare(self, ctx: RoundContext) -> None:
        st = _require_hier(ctx, "hier validator")
        cfg, rng = ctx.cfg, ctx.rng
        # tier-2 validation data: one batch per round-committee member,
        # drawn before any slice, so the draw order does not depend on how
        # many slices ran
        vpairs = [
            sample_client_batches(
                rng, ctx.data.client_images[j], ctx.data.client_labels[j],
                1, cfg.val_batch,
            )
            for j in ctx.round_committee
        ]
        st.val_x2 = torch.from_numpy(
            np.stack([p[0][0] for p in vpairs])).to(ctx.device)
        st.val_y2 = torch.from_numpy(
            np.stack([p[1][0] for p in vpairs])).to(ctx.device)

    # dispatch runs the inner validator's prepare, which draws the slice's
    # validation batches from the host rng
    dispatch_uses_rng = True

    def dispatch(self, ctx: RoundContext) -> None:
        """Open slice ``ctx.cohort``: swap in its sub-committee, reset the
        slice-scoped state, run the inner validator's prepare and its
        dispatch (or the whole inner validator when it has no split)."""
        st = _require_hier(ctx, "hier validator")
        sl = st.slices[ctx.cohort]
        st.note_stack(_slice_stack_nbytes(ctx))
        st.saved_committee = ctx.round_committee
        ctx.round_committee = sl.committee
        ctx.score_table = {}
        ctx.updates = {}
        ctx.row_quant = {}
        ctx.consensus = None
        try:
            inner = st.inner_validator
            prep = getattr(inner, "prepare", None)
            if prep is not None:
                prep(ctx)
            inner_dispatch = getattr(inner, "dispatch", None)
            st.inner_split = inner_dispatch is not None
            if st.inner_split:
                inner_dispatch(ctx)
            else:
                inner(ctx)                  # monolithic inner validator
        except BaseException:
            self._close_slice(ctx, st)
            raise

    def finalize(self, ctx: RoundContext) -> None:
        st = _require_hier(ctx, "hier validator")
        try:
            if st.inner_split:
                st.inner_validator.finalize(ctx)
            # before _close_slice: the slice's cached int8 rows must reach
            # the sub-aggregation
            self._finish_slice(ctx, st)
        finally:
            self._close_slice(ctx, st)
        # the inner validator's k-updates trigger does not apply: a tiered
        # round ingests every slice exactly once
        ctx.collected = ctx.cohort >= len(st.slices) - 1

    @staticmethod
    def _close_slice(ctx: RoundContext, st: HierState) -> None:
        ctx.round_committee = st.saved_committee
        # streaming ingest: drop every reference to this slice's update
        # stack before the next slice lands (the memory bound)
        ctx.updates = {}
        ctx.cohort_updates = []
        ctx.row_quant = {}
        ctx.score_table = {}

    def __call__(self, ctx: RoundContext) -> None:
        self.dispatch(ctx)
        self.finalize(ctx)

    def _finish_slice(self, ctx: RoundContext, st: HierState) -> None:
        cfg = ctx.cfg
        if ctx.consensus is not None:
            recs = sorted(ctx.consensus.accepted_records(),
                          key=lambda r: -r.median_score)
            if not recs:  # nothing qualified: best available (layout holds)
                recs = sorted(ctx.consensus.records,
                              key=lambda r: -r.median_score)[:1]
            ids = [r.uploader for r in recs]
            weights = ([r.median_score for r in recs]
                       if cfg.weight_by_score else None)
            st.t1_validations += ctx.consensus.stats.validations
        else:  # consensus-free inner validator (e.g. accept_all)
            ids = list(ctx.updates)
            weights = None
        sub, blob = _aggregate_slice(ctx, ids, weights)
        st.sub_aggregates.append(sub)
        st.sub_blobs.append(blob)
        st.sub_uploaders.append(ids[0])    # top-scored contributor = rep
        st.sub_contributors.append(ids)


register("validator", "hier")(HierValidator())


# ----------------------------------------------------------------------
# tier-2 packer: committee consensus over the S sub-aggregates
# ----------------------------------------------------------------------
def _tier2_scores(ctx: RoundContext, st: HierState) -> np.ndarray:
    """(S, Q2) accuracy matrix of the sub-aggregates on the round
    committee's validation batches, by the tier-1 score program."""
    n = len(st.sub_aggregates)
    scores = ctx.score_matrix_fn(ctx.params, tree_stack(st.sub_aggregates),
                                 st.val_x2, st.val_y2)
    return scores.cpu().numpy()[:n]


@register("packer", "hier")
def pack_hier(ctx: RoundContext) -> None:
    """(3b, tier 2) second-level committee round over the sub-aggregates,
    then the tiered chain commit: S update blocks (the sub-aggregates,
    int8 blobs on quantized chains) and the committee block.

    Sub-aggregates are validated in descending-median order, so the
    consensus threshold anchors on the best one: a poisoned sub-aggregate
    (a whole slice colluding at tier 1) scores far below the honest ones
    and fails the relative threshold."""
    st = _require_hier(ctx, "hier packer")
    cfg, rng = ctx.cfg, ctx.rng
    S = len(st.sub_aggregates)
    honest = _tier2_scores(ctx, st)                     # (S, Q2)
    st.tier2_scores = honest
    st.note_stack(S * st.dim * 4 + sum(
        _tree_nbytes(b) for b in st.sub_blobs if b is not None
    ))
    st.flat_stack_bytes = len(ctx.trainers_total) * st.dim * 4

    t2 = CommitteeConsensus(ctx.round_committee,
                            accept_threshold=cfg.accept_threshold)
    table: Dict[int, Dict[int, float]] = {}
    t2.bind_score_table(table)
    rep_slice: Dict[int, int] = {}
    medians = []
    for s_idx in range(S):
        rep = st.sub_uploaders[s_idx]
        rep_slice[rep] = s_idx
        row = {}
        for j, member in enumerate(ctx.round_committee):
            sc = float(honest[s_idx, j])
            if cfg.collusion:
                sc = ctx.collusion.score(
                    rng,
                    ctx.is_malicious(member),
                    ctx.is_malicious(rep),
                    sc,
                )
            row[member] = sc
        table[rep] = row
        medians.append(float(np.median(list(row.values()))))
    for s_idx in sorted(range(S), key=lambda i: -medians[i]):
        t2.validate(st.sub_uploaders[s_idx], st.sub_uploaders[s_idx])
    # the round's message cost: P*q_sub at tier 1 + S*Q2 here (RoundLog
    # reads it off this consensus object)
    t2.stats.validations += st.t1_validations

    recs = sorted(t2.accepted_records(), key=lambda r: -r.median_score)
    if not recs:
        recs = sorted(t2.records, key=lambda r: -r.median_score)[:1]
    recs = recs[:S]
    while len(recs) < S:                   # duplicate-fill: layout needs S
        recs.append(recs[0])

    ctx.consensus = t2
    ctx.packed_ids = [r.uploader for r in recs]
    ctx.packed_scores = [r.median_score for r in recs]
    packed_slices = [rep_slice[r.uploader] for r in recs]
    ctx.packed_updates = [st.sub_aggregates[i] for i in packed_slices]
    ctx.weights = ctx.packed_scores if cfg.weight_by_score else None

    quantized = bool(getattr(cfg, "quantize_chain", False))
    for r, s_idx in zip(recs, packed_slices):
        if quantized:
            ctx.chain.append_update(st.sub_blobs[s_idx], r.uploader,
                                    r.median_score, encoded=True)
        else:
            ctx.chain.append_update(st.sub_aggregates[s_idx], r.uploader,
                                    r.median_score)
        ctx.manager.nodes[r.uploader].score_history.append(r.median_score)
    ctx.chain.append_committee({
        "members": np.asarray(ctx.round_committee, np.int64),
        "uploaders": np.asarray(st.sub_uploaders, np.int64),
        "scores": np.asarray(honest, np.float32),
        "medians": np.asarray(medians, np.float32),
        "accepted": np.asarray(
            [any(r.uploader == st.sub_uploaders[i] and r.accepted
                 for r in t2.records) for i in range(S)]
        ),
    })
    if quantized:
        # stage the packed blobs for the fused aggregator: the same
        # (q, scales, d, unravel) contract as the flat int8 packers
        q = torch.stack([st.sub_blobs[i]["q"] for i in packed_slices])
        s = torch.stack([st.sub_blobs[i]["scales"] for i in packed_slices])
        d = int(st.sub_blobs[packed_slices[0]]["d"])
        ctx.packed_quantized = (q, s, d, ctx.chain.codec.unravel)


def build_hier_pipeline(cfg, overrides=None):
    """The tiered stage set for a config: tiered sampler + hier validator
    + hier packer over the flat defaults, with the config's trainer and
    aggregator untouched.  A ``validator`` override selects the INNER
    (tier-1, per-slice) validator; other overrides replace stages as
    usual.  Returns (pipeline, inner_validator): the runtime threads the
    inner validator to the hier stages through ``HierState``."""
    overrides = dict(overrides or {})
    names = default_stage_names(cfg)
    inner_name = overrides.pop("validator", names["validator"])
    names.update({"sampler": "tiered", "validator": "hier",
                  "packer": "hier"})
    pipeline = build_pipeline(names, overrides, max_cohorts=cfg.tiers)
    return pipeline, resolve("validator", inner_name)
