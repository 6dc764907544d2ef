"""Composable BFLC round pipeline (paper Fig. 1 as pluggable stages).

Port of ``repro/fl/pipeline.py``:

* ``RoundContext`` threads one round's state (params, cohort, score table,
  packed records, chain, host rng, per-stage timings) through the stages.
* Seven stage kinds — sampler, local_trainer, validator, packer,
  aggregator, elector, rewarder — each a callable ``(ctx) -> None`` in a
  string-keyed registry; ``@register(kind, name)`` adds one.
* ``RoundPipeline`` loops sample -> train -> validate over cohorts until k
  qualified updates are collected, then runs pack -> aggregate -> elect ->
  reward once, timing every stage into ``ctx.timings``.  After each stage
  it waits for the device (``torch.cuda.synchronize`` on CUDA), so each
  bucket holds its own work.  Each stage's timing is its span
  (``repro_torch.spans.stage``); inside it the batch draw, the local
  steps and the consensus are spans of their own.
* The trainer and the committee validators are split into ``dispatch``
  (host rng draws and device launches) and ``finalize`` (the host work
  that reads the results); ``__call__`` runs both back to back.
  ``repro_torch.fl.async_engine`` schedules the halves so that one
  cohort's training runs on the card while the host finishes the
  previous cohort's committee work.

Registered here: the BFLC stages ``active``, ``local_sgd``,
``committee``, ``committee_int8``, ``top_k``, ``top_k_int8``, ``pytree``,
``fused_int8``, ``by_candidates``, ``proportional``, and the baselines'
no-op stages ``uniform``, ``accept_all``, ``all``, ``none`` (elector and
rewarder).  ``repro_torch.fl.hier`` registers the two-tier round's
``tiered`` sampler and ``hier`` validator and packer, and
``repro_torch.fl.sharded`` the sharded engine's ``local_sgd_sharded``,
``committee_sharded``, ``committee_int8_sharded``, ``top_k_int8_sharded``
and ``fused_int8_sharded`` (``repro_torch.fl`` imports both).
"""
from __future__ import annotations

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
from repro_torch.device import HostCopy, synchronize, to_device
from repro_torch.spans import span, stage
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
    community: Any = None                  # DeviceCommunity: data's shards
    local_train_fn: Any = None
    score_matrix_fn: Any = None
    int8_score_fn: Any = None              # fused int8 scorer
    collusion: Any = None                  # CollusionPolicy
    malicious: Optional[Set[int]] = None   # baseline ground truth (no manager)
    # sharded round engine (set when the runtime was built with a mesh;
    # repro_torch.fl.sharded's stages consume these)
    mesh: Any = None                       # RoundMesh (repro_torch.launch.mesh)
    sharded_train_fn: Any = None           # local SGD on the rank's clients
    sharded_quantize_fn: Any = None        # codec on the rank's D-slice
    sharded_agg_fn: Any = None             # fused int8 reduction of the D-slice
    sharded_score_fn: Any = None           # score rows of the rank's P-block
    sharded_int8_score_fn: Any = None      # fused int8 scorer on the P-block
    # two-tier round state: a HierState, built per round by the runtime
    # when cfg.tiers > 1 (see repro_torch.fl.hier)
    hier: Any = None
    # uploader -> (q, scales, row, d): the int8 validator's per-row
    # chain-codec quantization, cached so the packer reuses the rows
    # instead of re-quantizing the packed stack
    row_quant: Dict[int, Any] = field(default_factory=dict)
    # per-cohort state (overwritten each cohort; the async engine stages
    # these between its cohort ring slots and the shared context)
    cohort: int = 0
    trainers: List[int] = field(default_factory=list)
    cohort_updates: List[Any] = field(default_factory=list)
    cohort_stacked: Any = None             # sharded trainer: the rank's P-block
    cohort_poisoned: List[int] = field(default_factory=list)
    cohort_scores: Any = None              # validator's (P, Q) scores, in flight
    train_inflight: Any = None             # trainer's dispatched update stack
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


class Sampler(Stage, Protocol):
    """Chooses ``ctx.trainers`` for the current cohort (empty = stop)."""


class LocalTrainer(Stage, Protocol):
    """Trains the cohort locally -> ``ctx.cohort_updates`` (may poison)."""


class Validator(Stage, Protocol):
    """Scores/admits the cohort's updates into ``ctx.updates`` and sets
    ``ctx.collected`` once the round's trigger condition is met.  May
    additionally define ``prepare(ctx)``, run once before cohort 0
    (e.g. to sample committee validation data)."""


class Packer(Stage, Protocol):
    """Selects the round's update set -> ``ctx.packed_*`` (+ chain update
    blocks, when a chain is present)."""


class Aggregator(Stage, Protocol):
    """Reduces the packed updates -> ``ctx.aggregate`` / ``ctx.new_params``
    (+ chain model block, when a chain is present)."""


class Elector(Stage, Protocol):
    """Seats the next committee -> ``ctx.committee``."""


class Rewarder(Stage, Protocol):
    """Distributes incentives and does end-of-round housekeeping."""


SAMPLERS: Dict[str, Sampler] = {}
LOCAL_TRAINERS: Dict[str, LocalTrainer] = {}
VALIDATORS: Dict[str, Validator] = {}
PACKERS: Dict[str, Packer] = {}
AGGREGATORS: Dict[str, Aggregator] = {}
ELECTORS: Dict[str, Elector] = {}
REWARDERS: Dict[str, Rewarder] = {}

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
        with stage(key, ctx.timings):
            fn(ctx)
            # kernels and PyTorch ops return before the device finishes:
            # wait, so each stage's device work lands in its own bucket
            synchronize(ctx.device)

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


def default_stage_names(cfg, mesh=None) -> Dict[str, str]:
    """The BFLC wiring for a config: quantize_chain flips the packer +
    aggregator pair to the fused int8 engine; a mesh flips local training
    and committee validation (and, on an int8 chain, the packer +
    aggregator) to the sharded engine (``repro_torch.fl.sharded``).  The
    sharded validator scores f32 in every config; the int8-view scorers
    (``committee_int8`` / ``committee_int8_sharded``) are opt-in through
    ``stages=``, because int8 scoring noise moves median scores."""
    quantized = bool(getattr(cfg, "quantize_chain", False))
    sharded = mesh is not None
    names = {
        "sampler": "active",
        "local_trainer": "local_sgd_sharded" if sharded else "local_sgd",
        "validator": "committee_sharded" if sharded else "committee",
        "packer": "top_k_int8" if quantized else "top_k",
        "aggregator": "fused_int8" if quantized else "pytree",
        "elector": "by_candidates",
        "rewarder": "proportional",
    }
    if sharded and quantized:
        names["packer"] = "top_k_int8_sharded"
        names["aggregator"] = "fused_int8_sharded"
    return names


def baseline_stage_names(mesh=None) -> Dict[str, str]:
    """Basic FL / CwMed: the same pipeline with every committee stage a
    no-op, so one central aggregation over an unvalidated cohort (trained
    by the sharded trainer when a mesh is given)."""
    return {
        "sampler": "uniform",
        "local_trainer": "local_sgd_sharded" if mesh is not None
        else "local_sgd",
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


def _community(ctx: RoundContext):
    if ctx.community is None:
        raise RuntimeError(
            "the batch draw needs ctx.community, the training shards on the "
            "device (repro_torch.fl.client.DeviceCommunity), which the "
            "runtime builds")
    return ctx.community


def sample_cohort_batches(ctx: RoundContext):
    """The cohort's stacked local batches on the device: (P, steps, b, ...),
    (P, steps, b).  One host rng draw of indices per trainer, in
    ``ctx.trainers`` order, as the reference draws its batches; only the
    indices are copied over (the span ``h2d``), and the rows are gathered
    on the device from ``ctx.community``; the draw and the gather are the
    span ``train.draw``."""
    cfg, store = ctx.cfg, _community(ctx)
    with span("train.draw"):
        idx = store.draw(ctx.rng, ctx.trainers, cfg.local_steps,
                         cfg.local_batch)
    idx = to_device(idx, ctx.device)
    with span("train.draw"):
        return store.gather(idx)


def sample_member_batches(ctx: RoundContext, members: List[int]):
    """Each member's validation batch on the device: (Q, val_batch, ...),
    (Q, val_batch), one host rng draw of indices per member in order,
    gathered from ``ctx.community`` as the cohort's batches are."""
    store = _community(ctx)
    idx = store.draw(ctx.rng, members, 1, ctx.cfg.val_batch)[:, 0]
    return store.gather(to_device(idx, ctx.device))


def poison_cohort_updates(ctx: RoundContext, updates: List[Any]) -> List[int]:
    """Per-node attack injection for malicious trainers (in place).
    Returns the poisoned indices, also recorded in ``ctx.cohort_poisoned``."""
    cfg, rng = ctx.cfg, ctx.rng
    attack = ATTACKS[cfg.attack]
    poisoned = []
    for idx, node_id in enumerate(ctx.trainers):
        if ctx.is_malicious(node_id):
            updates[idx] = attack(
                rng, updates[idx], cfg.attack_sigma, ref=ctx.params
            ) if cfg.attack == "gaussian" else attack(rng, updates[idx])
            poisoned.append(idx)
    ctx.cohort_poisoned = poisoned
    return poisoned


class LocalSGDTrainer:
    """(2) cohort-batched local SGD + attack injection for malicious
    trainers.

    ``dispatch`` draws the cohort's batches from the host rng and launches
    the cohort's training into ``ctx.train_inflight`` without waiting for
    it; ``finalize`` unstacks the updates and poisons the malicious
    trainers' (the attacks go through host numpy, so a poisoned cohort
    waits for its training there)."""

    def dispatch(self, ctx: RoundContext) -> None:
        xs, ys = sample_cohort_batches(ctx)
        with span("train.steps", device=True):
            ctx.train_inflight = ctx.local_train_fn(ctx.params, xs, ys)
        ctx.cohort_stacked = None          # one device: no sharded stack

    def finalize(self, ctx: RoundContext) -> None:
        stacked = ctx.train_inflight
        ctx.train_inflight = None
        updates = tree_unstack(stacked, len(ctx.trainers))
        poison_cohort_updates(ctx, updates)
        ctx.cohort_updates = updates

    def __call__(self, ctx: RoundContext) -> None:
        self.dispatch(ctx)
        self.finalize(ctx)


train_local_sgd = register("local_trainer", "local_sgd")(LocalSGDTrainer())


class CommitteeValidator:
    """(3) committee scoring: the P x Q accuracy matrix in one batched
    call, collusion overlay, median acceptance via CommitteeConsensus.

    ``prepare`` runs once per round: it samples each member's validation
    batch and binds the (live) score table to the consensus object.
    ``_scores_device`` is the score program (subclasses swap it).
    ``dispatch`` launches it and starts the copy of the (P, Q) matrix to
    the host (``ctx.cohort_scores``), drawing no host rng; ``finalize``
    waits for that copy alone, then runs the collusion overlay and the
    consensus admissions."""

    # dispatch draws no host rng: the async engine's rng edges read this
    dispatch_uses_rng = False

    def prepare(self, ctx: RoundContext) -> None:
        ctx.val_x, ctx.val_y = sample_member_batches(ctx, ctx.round_committee)
        ctx.consensus = CommitteeConsensus(
            ctx.round_committee, accept_threshold=ctx.cfg.accept_threshold
        )
        ctx.consensus.bind_score_table(ctx.score_table)

    def _scores_device(self, ctx: RoundContext) -> torch.Tensor:
        """The cohort's (P, Q) accuracy matrix, still in flight."""
        return ctx.score_matrix_fn(
            ctx.params, tree_stack(ctx.cohort_updates), ctx.val_x, ctx.val_y
        )

    def dispatch(self, ctx: RoundContext) -> None:
        ctx.cohort_scores = HostCopy(self._scores_device(ctx))

    def finalize(self, ctx: RoundContext) -> None:
        cfg, rng = ctx.cfg, ctx.rng
        honest_scores = ctx.cohort_scores.wait().numpy()   # (P, Q)
        with span("validate.consensus"):
            ctx.cohort_scores = honest_scores
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

    def __call__(self, ctx: RoundContext) -> None:
        self.dispatch(ctx)
        self.finalize(ctx)


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

    def _scores_device(self, ctx: RoundContext) -> torch.Tensor:
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
