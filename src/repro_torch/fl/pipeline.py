"""Composable BFLC round pipeline (paper Fig. 1 as pluggable stages).

Port of ``repro/fl/pipeline.py`` for the single-device round:

* ``RoundContext`` threads one round's state (params, cohort, score table,
  packed records, chain, host rng, per-stage timings) through the stages.
* Seven stage kinds — sampler, local_trainer, validator, packer,
  aggregator, elector, rewarder — each a callable ``(ctx) -> None`` in a
  string-keyed registry; ``@register(kind, name)`` adds one.
* ``RoundPipeline`` loops sample -> train -> validate over cohorts until k
  qualified updates are collected, then runs pack -> aggregate -> elect ->
  reward once, timing every stage into ``ctx.timings``.  After each stage
  it waits for the device (``torch.cuda.synchronize`` on CUDA), so each
  bucket holds its own work.

Registered here: the BFLC stages ``active``, ``local_sgd``,
``committee``, ``committee_int8``, ``top_k``, ``top_k_int8``, ``pytree``,
``fused_int8``, ``by_candidates``, ``proportional``, and the baselines'
no-op stages ``uniform``, ``accept_all``, ``all``, ``none`` (elector and
rewarder).  ``repro_torch.fl.hier`` registers the two-tier round's
``tiered`` sampler and ``hier`` validator and packer.  The reference's
sharded stages are listed in ``NOT_PORTED`` and raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Set

import numpy as np
import torch

from repro_torch.core import election as election_mod
from repro_torch.core.aggregation import (
    aggregate_pytrees,
    apply_update,
    flatten_updates,
)
from repro_torch.core.attacks import ATTACKS
from repro_torch.core.consensus import CommitteeConsensus, ValidationRecord
from repro_torch.core.incentive import distribute_rewards
from repro_torch.device import synchronize
from repro_torch.fl.client import sample_client_batches
from repro_torch.tree import tree_stack, tree_unstack


# ----------------------------------------------------------------------
# round state
# ----------------------------------------------------------------------
@dataclass
class RoundContext:
    """State threaded through one round's stage pipeline.  ``manager`` and
    ``chain`` stay None for the committee-free baselines."""

    # round inputs
    cfg: Any                               # BFLCConfig or FLConfig
    rng: np.random.Generator
    adapter: Any
    data: Any                              # FederatedDataset (host numpy)
    params: Any                            # latest global model (tensors)
    round: int
    device: torch.device = torch.device("cpu")
    manager: Any = None                    # NodeManager
    chain: Any = None                      # Chain
    round_committee: List[int] = field(default_factory=list)  # frozen at round start
    committee: List[int] = field(default_factory=list)        # elector's output
    q_committee: int = 0
    p_trainers: int = 0
    # batched helpers (built once by the runtime, shared across rounds)
    local_train_fn: Any = None
    score_matrix_fn: Any = None
    int8_score_fn: Any = None              # fused int8 scorer
    collusion: Any = None                  # CollusionPolicy
    malicious: Optional[Set[int]] = None   # baseline ground truth (no manager)
    # two-tier round state: a HierState, built per round by the runtime
    # when cfg.tiers > 1 (see repro_torch.fl.hier)
    hier: Any = None
    # uploader -> (q, scales, row, d): the int8 validator's per-row
    # chain-codec quantization, cached so the packer reuses the rows
    # instead of re-quantizing the packed stack
    row_quant: Dict[int, Any] = field(default_factory=dict)
    # per-cohort state (overwritten each cohort)
    cohort: int = 0
    trainers: List[int] = field(default_factory=list)
    cohort_updates: List[Any] = field(default_factory=list)
    # accumulated collection state
    trainers_total: List[int] = field(default_factory=list)
    updates: Dict[int, Any] = field(default_factory=dict)     # uploader -> update
    score_table: Dict[int, Dict[int, float]] = field(default_factory=dict)
    consensus: Optional[CommitteeConsensus] = None
    val_x: Any = None
    val_y: Any = None
    collected: bool = False                # k qualified updates reached
    # packed round output (packer products)
    packed_ids: List[int] = field(default_factory=list)
    packed_scores: List[float] = field(default_factory=list)
    packed_updates: List[Any] = field(default_factory=list)
    packed_quantized: Any = None           # (q, scales, d, unravel) int8 stack
    weights: Any = None                    # aggregation weights (or None)
    # aggregation output
    aggregate: Any = None
    new_params: Any = None
    # incentive output
    rewards: Dict[int, float] = field(default_factory=dict)
    # per-stage wall-clock seconds (cumulative over cohorts)
    timings: Dict[str, float] = field(default_factory=dict)

    def is_malicious(self, node_id: int) -> bool:
        if self.manager is not None:
            return self.manager.nodes[node_id].is_malicious
        return self.malicious is not None and int(node_id) in self.malicious


# ----------------------------------------------------------------------
# stage protocols + registries
# ----------------------------------------------------------------------
class Stage(Protocol):
    def __call__(self, ctx: RoundContext) -> None: ...


SAMPLERS: Dict[str, Stage] = {}
LOCAL_TRAINERS: Dict[str, Stage] = {}
VALIDATORS: Dict[str, Stage] = {}
PACKERS: Dict[str, Stage] = {}
AGGREGATORS: Dict[str, Stage] = {}
ELECTORS: Dict[str, Stage] = {}
REWARDERS: Dict[str, Stage] = {}

REGISTRIES: Dict[str, Dict[str, Stage]] = {
    "sampler": SAMPLERS,
    "local_trainer": LOCAL_TRAINERS,
    "validator": VALIDATORS,
    "packer": PACKERS,
    "aggregator": AGGREGATORS,
    "elector": ELECTORS,
    "rewarder": REWARDERS,
}

STAGE_KINDS = tuple(REGISTRIES)

# keys under which RoundPipeline.run records wall clock in ctx.timings
STAGE_TIMING_KEYS = (
    "sample", "train", "validate", "pack", "aggregate", "elect", "reward",
)

# the reference's other registered stages, with the ROADMAP.md item that
# ports them
NOT_PORTED = {
    "local_sgd_sharded": "Queue 1 item 11 (sharded rounds)",
    "committee_sharded": "Queue 1 item 11 (sharded rounds)",
    "committee_int8_sharded": "Queue 1 item 11 (sharded rounds)",
    "top_k_int8_sharded": "Queue 1 item 11 (sharded rounds)",
    "fused_int8_sharded": "Queue 1 item 11 (sharded rounds)",
}


def register(kind: str, name: str) -> Callable[[Stage], Stage]:
    """Decorator: ``@register("aggregator", "mine")`` adds a stage to its
    registry (re-registering a name overwrites)."""
    if kind not in REGISTRIES:
        raise ValueError(f"unknown stage kind {kind!r} (want one of {STAGE_KINDS})")

    def deco(obj: Stage) -> Stage:
        REGISTRIES[kind][name] = obj
        return obj

    return deco


def resolve(kind: str, impl) -> Stage:
    """Name -> registered stage; callables pass through unchanged."""
    if callable(impl):
        return impl
    registry = REGISTRIES[kind]
    if impl in registry:
        return registry[impl]
    if impl in NOT_PORTED:
        raise NotImplementedError(
            f"{kind} {impl!r} is not ported yet: ROADMAP.md {NOT_PORTED[impl]}"
        )
    raise KeyError(f"no {kind} named {impl!r}; registered: {sorted(registry)}")


# ----------------------------------------------------------------------
# the round loop
# ----------------------------------------------------------------------
@dataclass
class RoundPipeline:
    """Ordered stage set for one round (see the module docstring)."""

    sampler: Stage
    local_trainer: Stage
    validator: Stage
    packer: Stage
    aggregator: Stage
    elector: Stage
    rewarder: Stage
    max_cohorts: int = 3

    def _timed(self, key: str, fn: Callable, ctx: RoundContext) -> None:
        t0 = time.perf_counter()
        fn(ctx)
        # kernels and PyTorch ops return before the device finishes: wait,
        # so each stage's device work lands in its own bucket
        synchronize(ctx.device)
        ctx.timings[key] = ctx.timings.get(key, 0.0) + (time.perf_counter() - t0)

    def run(self, ctx: RoundContext) -> RoundContext:
        prepare = getattr(self.validator, "prepare", None)
        if prepare is not None:
            self._timed("validate", prepare, ctx)
        for cohort in range(self.max_cohorts):
            ctx.cohort = cohort
            # rows quantized for an earlier cohort describe that cohort's
            # updates; an uploader re-drawn later trains a new update, so a
            # surviving cache entry would put a stale blob on the chain
            ctx.row_quant.clear()
            self._timed("sample", self.sampler, ctx)
            if not ctx.trainers:
                break
            self._timed("train", self.local_trainer, ctx)
            self._timed("validate", self.validator, ctx)
            if ctx.collected:
                break
        self._timed("pack", self.packer, ctx)
        self._timed("aggregate", self.aggregator, ctx)
        self._timed("elect", self.elector, ctx)
        self._timed("reward", self.rewarder, ctx)
        return ctx


def default_stage_names(cfg) -> Dict[str, str]:
    """The BFLC wiring for a config: quantize_chain flips the packer +
    aggregator pair to the fused int8 engine."""
    quantized = bool(getattr(cfg, "quantize_chain", False))
    return {
        "sampler": "active",
        "local_trainer": "local_sgd",
        "validator": "committee",
        "packer": "top_k_int8" if quantized else "top_k",
        "aggregator": "fused_int8" if quantized else "pytree",
        "elector": "by_candidates",
        "rewarder": "proportional",
    }


def baseline_stage_names() -> Dict[str, str]:
    """Basic FL / CwMed: the same pipeline with every committee stage a
    no-op, so one central aggregation over an unvalidated cohort."""
    return {
        "sampler": "uniform",
        "local_trainer": "local_sgd",
        "validator": "accept_all",
        "packer": "all",
        "aggregator": "pytree",
        "elector": "none",
        "rewarder": "none",
    }


def build_pipeline(
    names: Dict[str, str],
    overrides: Optional[Dict[str, Any]] = None,
    max_cohorts: int = 3,
) -> RoundPipeline:
    """Stage names (+ optional per-kind overrides: a registered name or a
    bare callable) -> RoundPipeline."""
    merged = dict(names)
    if overrides:
        unknown = set(overrides) - set(STAGE_KINDS)
        if unknown:
            raise ValueError(
                f"unknown stage kinds {sorted(unknown)} (want {STAGE_KINDS})"
            )
        merged.update(overrides)
    return RoundPipeline(
        **{kind: resolve(kind, merged[kind]) for kind in STAGE_KINDS},
        max_cohorts=max_cohorts,
    )


# ----------------------------------------------------------------------
# default BFLC stages (paper Fig. 1)
# ----------------------------------------------------------------------
@register("sampler", "active")
def sample_active(ctx: RoundContext) -> None:
    """(1) k%-active sampling, committee excluded, topped up from the
    full membership when the draw comes in short."""
    cfg, rng = ctx.cfg, ctx.rng
    active = ctx.manager.sample_active(rng, cfg.active_proportion)
    trainers = [
        i for i in active
        if i not in ctx.round_committee and i not in ctx.updates
    ][: ctx.p_trainers]
    if len(trainers) < ctx.p_trainers:
        extra = [
            i for i in ctx.manager.active_ids()
            if i not in ctx.round_committee and i not in ctx.updates
            and i not in trainers
        ]
        need = min(ctx.p_trainers - len(trainers), len(extra))
        if need > 0:
            trainers += rng.choice(extra, size=need, replace=False).tolist()
    ctx.trainers = trainers


@register("sampler", "uniform")
def sample_uniform(ctx: RoundContext) -> None:
    """Baseline sampling: a uniform draw over all clients, no committee to
    exclude; one cohort (a second call yields no trainers)."""
    if ctx.updates:
        ctx.trainers = []
        return
    n = ctx.data.num_clients
    m = max(2, int(round(n * ctx.cfg.active_proportion)))
    ctx.trainers = ctx.rng.choice(n, m, replace=False).tolist()


def sample_cohort_batches(ctx: RoundContext):
    """The cohort's stacked local batches on the device: (P, steps, b, ...),
    (P, steps, b) — one host rng draw per trainer, in ``ctx.trainers``
    order, as the reference draws them."""
    cfg, rng = ctx.cfg, ctx.rng
    pairs = [
        sample_client_batches(
            rng, ctx.data.client_images[i], ctx.data.client_labels[i],
            cfg.local_steps, cfg.local_batch,
        )
        for i in ctx.trainers
    ]
    xs = np.stack([p[0] for p in pairs])
    ys = np.stack([p[1] for p in pairs])
    return (torch.from_numpy(xs).to(ctx.device),
            torch.from_numpy(ys).to(ctx.device))


def poison_cohort_updates(ctx: RoundContext, updates: List[Any]) -> None:
    """Per-node attack injection for malicious trainers (in place)."""
    cfg, rng = ctx.cfg, ctx.rng
    attack = ATTACKS[cfg.attack]
    for idx, node_id in enumerate(ctx.trainers):
        if ctx.is_malicious(node_id):
            updates[idx] = attack(
                rng, updates[idx], cfg.attack_sigma, ref=ctx.params
            ) if cfg.attack == "gaussian" else attack(rng, updates[idx])


@register("local_trainer", "local_sgd")
def train_local_sgd(ctx: RoundContext) -> None:
    """(2) cohort-batched local SGD + attack injection for malicious
    trainers."""
    xs, ys = sample_cohort_batches(ctx)
    stacked = ctx.local_train_fn(ctx.params, xs, ys)
    updates = tree_unstack(stacked, len(ctx.trainers))
    poison_cohort_updates(ctx, updates)
    ctx.cohort_updates = updates


class CommitteeValidator:
    """(3) committee scoring: the P x Q accuracy matrix in one batched
    call, collusion overlay, median acceptance via CommitteeConsensus.

    ``prepare`` runs once per round: it samples each member's validation
    batch and binds the (live) score table to the consensus object."""

    def prepare(self, ctx: RoundContext) -> None:
        cfg, rng = ctx.cfg, ctx.rng
        vpairs = [
            sample_client_batches(
                rng, ctx.data.client_images[j], ctx.data.client_labels[j],
                1, cfg.val_batch,
            )
            for j in ctx.round_committee
        ]
        ctx.val_x = torch.from_numpy(
            np.stack([p[0][0] for p in vpairs])).to(ctx.device)
        ctx.val_y = torch.from_numpy(
            np.stack([p[1][0] for p in vpairs])).to(ctx.device)
        ctx.consensus = CommitteeConsensus(
            ctx.round_committee, accept_threshold=cfg.accept_threshold
        )
        ctx.consensus.bind_score_table(ctx.score_table)

    def _scores(self, ctx: RoundContext) -> torch.Tensor:
        """The cohort's (P, Q) accuracy matrix (subclasses swap the
        score program)."""
        return ctx.score_matrix_fn(
            ctx.params, tree_stack(ctx.cohort_updates), ctx.val_x, ctx.val_y
        )

    def __call__(self, ctx: RoundContext) -> None:
        cfg, rng = ctx.cfg, ctx.rng
        honest_scores = self._scores(ctx).cpu().numpy()    # (P, Q)
        for i, uploader in enumerate(ctx.trainers):
            row = {}
            for j, member in enumerate(ctx.round_committee):
                s = float(honest_scores[i, j])
                if cfg.collusion:
                    s = ctx.collusion.score(
                        rng,
                        ctx.manager.nodes[member].is_malicious,
                        ctx.manager.nodes[uploader].is_malicious,
                        s,
                    )
                row[member] = s
            ctx.score_table[uploader] = row
        for idx, uploader in enumerate(ctx.trainers):
            ctx.consensus.validate(uploader, uploader)
            ctx.updates[uploader] = ctx.cohort_updates[idx]
        ctx.trainers_total += ctx.trainers
        # the paper's aggregation trigger: k QUALIFIED updates
        if len(ctx.consensus.accepted_records()) >= cfg.k_updates:
            ctx.collected = True


register("validator", "committee")(CommitteeValidator())


def cache_row_quant(ctx: RoundContext, q, s, d: int) -> None:
    """Record the cohort's per-row chain-codec quantization: the int8
    scorer's (rows, Dpad) q and (rows, nblk) scales ARE the blobs a
    quantizing packer would store (same tiling), so the packer stacks the
    cached rows instead of quantizing again."""
    for i, uploader in enumerate(ctx.trainers):
        ctx.row_quant[uploader] = (q, s, i, d)


def cached_row_stack(ctx: RoundContext, ids: Optional[List[int]] = None):
    """(q, s, d) stacked from the row-quant cache for the given uploaders
    (default: the packed set), or None when any row is missing (e.g. the
    f32 validator ran, so nothing was quantized yet)."""
    ids = ctx.packed_ids if ids is None else ids
    cache = ctx.row_quant
    if not cache or any(u not in cache for u in ids):
        return None
    entries = [cache[u] for u in ids]
    q = torch.stack([e[0][e[2]] for e in entries])
    s = torch.stack([e[1][e[2]] for e in entries])
    return q, s, entries[0][3]


class Int8CommitteeValidator(CommitteeValidator):
    """Committee scoring straight from the chain-codec int8 view of each
    update (``stages={"validator": "committee_int8"}``, with
    ``quantize_chain=True``): the fused candidates kernel rebuilds every
    candidate from its quantized row in one read, so the committee scores
    exactly the blob the packer stores, and the packer reuses the rows."""

    def _scores(self, ctx: RoundContext) -> torch.Tensor:
        if ctx.int8_score_fn is None:
            raise RuntimeError(
                "committee_int8 needs ctx.int8_score_fn: build the runtime "
                "with quantize_chain=True (the scorer shares the chain "
                "codec's unravel structure)"
            )
        stack, _ = flatten_updates(ctx.cohort_updates)
        scores, q, s = ctx.int8_score_fn(ctx.params, stack, ctx.val_x,
                                         ctx.val_y)
        cache_row_quant(ctx, q, s, int(stack.shape[1]))
        return scores


register("validator", "committee_int8")(Int8CommitteeValidator())


@register("validator", "accept_all")
def validate_accept_all(ctx: RoundContext) -> None:
    """Committee-free admission (Basic FL / CwMed): every update enters the
    round set unscored; one cohort satisfies the trigger."""
    for idx, uploader in enumerate(ctx.trainers):
        ctx.updates[int(uploader)] = ctx.cohort_updates[idx]
    ctx.trainers_total += [int(t) for t in ctx.trainers]
    ctx.collected = True


def _select_top_k(ctx: RoundContext) -> List[ValidationRecord]:
    """(3b) top-k qualified records; if fewer than k qualified, the best
    one fills the remaining slots so the chain layout holds."""
    cfg = ctx.cfg
    if ctx.consensus is None:
        raise RuntimeError(
            "top-k packers select from committee validation records — pair "
            "them with a consensus-producing validator (e.g. 'committee'), "
            "or swap in a score-free packer (e.g. 'all')"
        )
    records = sorted(
        ctx.consensus.accepted_records(), key=lambda r: -r.median_score
    )[: cfg.k_updates]
    if not records:  # nothing qualified: fall back to best available
        records = sorted(
            ctx.consensus.records, key=lambda r: -r.median_score
        )[:1]
    while len(records) < cfg.k_updates:
        records.append(records[0])
    return records


def _set_packed(ctx: RoundContext, records: List[ValidationRecord]) -> None:
    ctx.packed_ids = [r.uploader for r in records]
    ctx.packed_scores = [r.median_score for r in records]
    ctx.packed_updates = [ctx.updates[u] for u in ctx.packed_ids]
    ctx.weights = ctx.packed_scores if ctx.cfg.weight_by_score else None


@register("packer", "top_k")
def pack_top_k(ctx: RoundContext) -> None:
    """Packs the top-k qualified updates as f32 update blocks."""
    _set_packed(ctx, _select_top_k(ctx))
    for i, (u, sc) in enumerate(zip(ctx.packed_ids, ctx.packed_scores)):
        ctx.chain.append_update(ctx.packed_updates[i], u, sc)
        ctx.manager.nodes[u].score_history.append(sc)


@register("packer", "top_k_int8")
def pack_top_k_int8(ctx: RoundContext) -> None:
    """Quantized chain packing (§IV.D): flatten the packed updates once,
    quantize the whole (K, D) stack in one kernel launch, store the int8
    rows as update blocks, and hand the quantized stack to the fused
    aggregator.  When the int8 validator already quantized the round's
    rows, the cached rows are stacked instead (nothing is quantized
    again)."""
    from repro_torch.kernels.ops import quantize_stack

    _set_packed(ctx, _select_top_k(ctx))
    cached = cached_row_stack(ctx)
    if cached is not None:
        q, s, d = cached
        unravel = ctx.chain.codec.unravel
    else:
        stack, unravel = flatten_updates(ctx.packed_updates)
        q, s, d = quantize_stack(stack)
    for i, (u, sc) in enumerate(zip(ctx.packed_ids, ctx.packed_scores)):
        ctx.chain.append_update(
            {"q": q[i], "scales": s[i], "d": d}, u, sc, encoded=True
        )
        ctx.manager.nodes[u].score_history.append(sc)
    ctx.packed_quantized = (q, s, d, unravel)


@register("packer", "all")
def pack_all(ctx: RoundContext) -> None:
    """Baseline packing: every collected update, size-weighted for fedavg
    when the config asks (classic FedAvg weighting); no chain, no scores."""
    cfg = ctx.cfg
    ctx.packed_ids = list(ctx.updates)
    ctx.packed_updates = [ctx.updates[u] for u in ctx.packed_ids]
    ctx.packed_scores = []
    weights = None
    if getattr(cfg, "size_weighted", False) and cfg.aggregation == "fedavg":
        weights = [len(ctx.data.client_labels[i]) for i in ctx.packed_ids]
    ctx.weights = weights


def _commit_aggregate(ctx: RoundContext, agg) -> None:
    ctx.aggregate = agg
    ctx.new_params = apply_update(ctx.params, agg)
    if ctx.chain is not None:
        ctx.chain.append_model(ctx.new_params, ctx.round + 1)


@register("aggregator", "pytree")
def aggregate_dense(ctx: RoundContext) -> None:
    """(4) dense aggregation over f32 update trees (plain PyTorch, or the
    f32 kernels when ``cfg.use_kernels``)."""
    cfg = ctx.cfg
    agg = aggregate_pytrees(
        ctx.packed_updates, method=cfg.aggregation, weights=ctx.weights,
        trim=getattr(cfg, "trim", 1),
        use_kernels=getattr(cfg, "use_kernels", False),
    )
    _commit_aggregate(ctx, agg)


@register("aggregator", "fused_int8")
def aggregate_fused_int8(ctx: RoundContext) -> None:
    """(4) fused one-pass aggregation straight from the chain's int8
    representation (one int8 read of the stack, dequantized in registers)."""
    from repro_torch.kernels.ops import aggregate_quantized

    cfg = ctx.cfg
    if ctx.packed_quantized is None:
        raise RuntimeError(
            "fused_int8 aggregator needs a quantizing packer (e.g. "
            "'top_k_int8') to stage the int8 stack in ctx.packed_quantized"
        )
    q, s, d, unravel = ctx.packed_quantized
    agg = unravel(aggregate_quantized(
        q, s, d, method=cfg.aggregation, weights=ctx.weights, trim=cfg.trim,
    ))
    _commit_aggregate(ctx, agg)


def fill_committee(manager, committee: List[int], q_committee: int) -> List[int]:
    """Keep committee size exactly q_committee; backfill prefers nodes with
    the best score history."""
    pool = [i for i in manager.active_ids() if i not in committee]
    pool.sort(key=lambda i: -manager.nodes[i].latest_score)
    committee = list(committee)
    while len(committee) < q_committee and pool:
        committee.append(pool.pop(0))
    return sorted(committee[:q_committee])


@register("elector", "by_candidates")
def elect_by_candidates(ctx: RoundContext) -> None:
    """(5) next committee from this round's validated providers (§IV.B);
    falls back to the sitting committee when no candidates packed."""
    cfg = ctx.cfg
    cand = dict(zip(ctx.packed_ids, ctx.packed_scores))
    elected = election_mod.elect(
        cfg.election_method, ctx.rng, cand, ctx.q_committee
    ) or list(ctx.round_committee)
    ctx.committee = fill_committee(ctx.manager, elected, ctx.q_committee)


@register("elector", "none")
def elect_none(ctx: RoundContext) -> None:
    """No election (baselines)."""


@register("rewarder", "proportional")
def reward_proportional(ctx: RoundContext) -> None:
    """(5) profit sharing by contribution (§IV.A) + end-of-round
    housekeeping: blacklist kicks and chain pruning."""
    cfg = ctx.cfg
    cand = dict(zip(ctx.packed_ids, ctx.packed_scores))
    ctx.rewards = distribute_rewards(ctx.manager, cand, cfg.reward_pool)
    if cfg.kick_below >= 0 and ctx.consensus is not None:
        for r in ctx.consensus.records:
            if r.median_score < cfg.kick_below:
                ctx.manager.kick(r.uploader)
    if cfg.prune_keep_rounds > 0:
        ctx.chain.prune(cfg.prune_keep_rounds)


@register("rewarder", "none")
def reward_none(ctx: RoundContext) -> None:
    """No incentive layer (baselines)."""
