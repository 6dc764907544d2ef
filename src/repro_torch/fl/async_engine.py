"""Asynchronous pipelined round engine.

Port of ``repro/fl/async_engine.py``.  The sequential engine
(``repro_torch.fl.pipeline.RoundPipeline``) runs sample -> train ->
validate strictly in cohort order and waits for the device after every
stage.  Everything the committee does after a cohort trains (the score
matrix's read-back, consensus bookkeeping, a slice's sub-aggregation) is
host work during which the card would sit idle.  This module replaces the
*schedule*, not the stages: the same registered stage set runs as a
dependency graph whose nodes are the stages' ``dispatch`` / ``finalize``
halves, so cohort t+1's local SGD is already queued on the card while the
host finishes cohort t's committee work.

Design
------
* **Cohort ring.**  Per-cohort context fields (``SLOT_FIELDS``) live in
  ``CohortSlot``s and are staged slot <-> ctx around every node, so two
  cohorts can be in flight without clobbering each other.  The ring is
  two deep: cohort t+1 starts only once cohort t-1 is finalized (edge
  ``sample[t+1] <- validate_finalize[t-1]``), so at most two update
  stacks are alive, which keeps a tiered round's memory bound at two
  slices.
* **Dependency graph.**  Each cohort adds sample -> train_dispatch ->
  train_finalize -> validate_dispatch -> validate_finalize nodes (a stage
  without the split runs as one node: a serialization point, never an
  error).  Validator nodes are serialized across cohorts (the trigger and
  the sampler's ``i not in ctx.updates`` exclusion read their products);
  the tail pack -> aggregate -> elect -> reward runs once after the last
  finalize, so chain appends happen in the sequential engine's order.
  Rounds never overlap: round t+1 trains from round t's model block.
* **rng edges.**  Bit-identical results need the host
  ``np.random.Generator`` drawn in the sequential order.  Every node that
  may draw host rng (sampling, batch draws, attack injection when the
  cohort holds malicious trainers, the collusion overlay when the scoring
  committee holds malicious members, a tiered slice's inner prepare) is
  chained in creation order, which is the sequential order.  With no
  malicious nodes the chain is sample -> train_dispatch ->
  validate_dispatch -> ..., which still lets training and validation
  overlap; with malicious nodes it runs through the finalize nodes and the
  graph falls back to the sequential order.
* **Sampler prefetch.**  A sampler with ``prefetch_safe = True`` (the
  tiered sampler: the partition is frozen at cohort 0) lets cohort t+1 be
  sampled and its training dispatched while cohort t still validates:
  slice s+1 trains while slice s sub-aggregates.  The flat samplers read
  the validator's admissions, so flat multi-cohort rounds wait for
  validate_finalize[t] before sample[t+1]; the engine never speculates a
  draw it might have to undo.
* **Sync points.**  No blanket device synchronize: the stages copy host
  data in with non-blocking copies (``repro_torch.device.to_device``) and
  results out through ``HostCopy``, whose wait is on one event.  The host
  waits where a stage half consumes device work: ``train_finalize`` of a
  poisoned cohort (the attacks run in numpy), ``validate_finalize``'s
  score event, the tail's chain digests, and one final synchronize in
  the reward node.  Each node's host time goes into ``ctx.timings``
  under the sequential engine's ``STAGE_TIMING_KEYS`` as a stage span of
  that key (``repro_torch.spans.stage``), so the stages' own spans nest
  in it as in the sequential engine; device time that overlaps lands in
  whichever bucket waited for it.
* **Ranks.**  With a mesh (``repro_torch.fl.sharded``) the sharded
  trainer's dispatch / finalize are ring nodes like any other, and its
  finalize and the sharded validators' dispatch gather over the ranks.
  The node order depends on the graph alone, never on timing, and every
  rank builds the same graph from the same seed, so the ranks' collectives
  pair up in order.
* **Failure.**  A node that raises aborts the run at once: no tail node
  has run, so nothing was appended to the chain, and the next cohort's
  queued device work is abandoned.

``BFLCRuntime`` and ``FLTrainer`` select this engine with
``schedule="async"``; ``AsyncRoundPipeline.run`` takes and returns the
same ``RoundContext`` as ``RoundPipeline.run`` and is bit-identical to it
for every stage set shipped here (``tests/test_torch_async_round.py``).
``last_order`` holds the keys of the nodes the last run executed, in
order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.device import synchronize
from repro_torch.fl.pipeline import RoundContext, RoundPipeline, STAGE_TIMING_KEYS
from repro_torch.spans import stage

# per-cohort RoundContext fields staged between ring slots and the shared
# context around every node
SLOT_FIELDS = (
    "cohort", "trainers", "cohort_updates", "cohort_stacked",
    "cohort_poisoned", "cohort_scores", "train_inflight", "row_quant",
)

RING_DEPTH = 2


@dataclass
class CohortSlot:
    """One ring slot: the per-cohort slice of RoundContext."""

    cohort: int
    trainers: List[int] = field(default_factory=list)
    cohort_updates: List[Any] = field(default_factory=list)
    cohort_stacked: Any = None
    cohort_poisoned: List[int] = field(default_factory=list)
    cohort_scores: Any = None
    train_inflight: Any = None
    row_quant: Dict[int, Any] = field(default_factory=dict)


@dataclass
class StageNode:
    """One schedulable unit: a stage (or stage half) bound to a cohort."""

    key: str                               # e.g. "train_dispatch[2]"
    kind: str                              # scheduler event class
    bucket: str                            # STAGE_TIMING_KEYS entry
    fn: Callable[[RoundContext], None]
    deps: List["StageNode"] = field(default_factory=list)
    slot: Optional[CohortSlot] = None
    cohort: Optional[int] = None
    rng: bool = False                      # consumes host rng
    priority: int = 1                      # 0 = dispatch-class (run first)
    order: int = 0                         # creation = sequential order
    done: bool = False
    skipped: bool = False


@dataclass
class AsyncRoundPipeline:
    """Drop-in replacement for ``RoundPipeline`` running the async
    schedule.  Same stage fields; ``run(ctx)`` mutates and returns the
    same ``RoundContext``."""

    sampler: Any
    local_trainer: Any
    validator: Any
    packer: Any
    aggregator: Any
    elector: Any
    rewarder: Any
    max_cohorts: int = 3
    last_order: List[str] = field(default_factory=list)

    @classmethod
    def from_pipeline(cls, p: RoundPipeline) -> "AsyncRoundPipeline":
        return cls(p.sampler, p.local_trainer, p.validator, p.packer,
                   p.aggregator, p.elector, p.rewarder, p.max_cohorts)

    def run(self, ctx: RoundContext) -> RoundContext:
        run = _AsyncRoundRun(self, ctx)
        self.last_order = run.executed
        run.run()
        return ctx


def _split(stage) -> bool:
    return hasattr(stage, "dispatch") and hasattr(stage, "finalize")


class _AsyncRoundRun:
    """One round's node graph and executor, grown cohort by cohort: a
    cohort's trainer / validator nodes and rng hazards depend on the
    sampled trainer list, so they are created when its sample runs."""

    def __init__(self, pipe: AsyncRoundPipeline, ctx: RoundContext):
        self.pipe = pipe
        self.ctx = ctx
        self.nodes: List[StageNode] = []
        self.executed: List[str] = []
        self.slots: Dict[int, CohortSlot] = {}
        self._order = 0
        self._rng_tail: Optional[StageNode] = None   # last rng-consuming node
        self._last_v: Optional[StageNode] = None     # validator serialization
        self._vf: Dict[int, StageNode] = {}          # cohort -> final V node
        self._samples: Dict[int, StageNode] = {}
        self._tail_made = False

    # ------------------------------------------------------------------
    # graph construction
    # ------------------------------------------------------------------
    def _add(self, key: str, kind: str, bucket: str, fn, *, deps=(),
             slot=None, cohort=None, rng=False, priority=1) -> StageNode:
        node = StageNode(key=key, kind=kind, bucket=bucket, fn=fn,
                         deps=[d for d in deps if d is not None],
                         slot=slot, cohort=cohort, rng=rng,
                         priority=priority, order=self._order)
        self._order += 1
        if rng:
            # chain host-rng consumers in creation (= sequential) order so
            # a fixed seed replays the sequential engine's exact stream
            if self._rng_tail is not None:
                node.deps.append(self._rng_tail)
            self._rng_tail = node
        self.nodes.append(node)
        return node

    def _cohort_committee(self, c: int) -> List[int]:
        """The committee whose members score cohort c (the collusion-rng
        hazard set): the slice's sub-committee in a tiered round, the
        round committee otherwise."""
        hier = self.ctx.hier
        if hier is not None and hier.slices:
            return (hier.slices[c].committee
                    if c < len(hier.slices) else [])
        return self.ctx.round_committee

    def _add_sample(self, c: int) -> StageNode:
        sampler = self.pipe.sampler
        prefetch = bool(getattr(sampler, "prefetch_safe", False))
        rng = not (c > 0 and getattr(sampler, "rng_first_only", False))
        if c == 0:
            deps = [self._last_v]          # the prepare node, when present
        elif prefetch:
            deps = [self._samples[c - 1], self._vf.get(c - RING_DEPTH)]
        else:
            # flat samplers read the validator's admissions (the collected
            # trigger, the `i not in ctx.updates` exclusion): no speculation
            deps = [self._vf[c - 1]]
        slot = CohortSlot(cohort=c)
        self.slots[c] = slot
        node = self._add(f"sample[{c}]", "sample", "sample", sampler,
                         deps=deps, slot=slot, cohort=c, rng=rng, priority=0)
        self._samples[c] = node
        return node

    def _add_cohort_body(self, c: int) -> None:
        """Trainer and validator nodes for a sampled, non-empty cohort."""
        ctx, pipe = self.ctx, self.pipe
        slot = self.slots[c]
        snode = self._samples[c]
        poisoned = any(ctx.is_malicious(i) for i in slot.trainers)
        collusion = bool(getattr(ctx.cfg, "collusion", False)) and any(
            ctx.is_malicious(m) for m in self._cohort_committee(c)
        )

        trainer, validator = pipe.local_trainer, pipe.validator
        if _split(trainer):
            td = self._add(f"train_dispatch[{c}]", "train", "train",
                           trainer.dispatch, deps=[snode], slot=slot,
                           cohort=c, rng=True, priority=0)
            tf = self._add(f"train_finalize[{c}]", "train", "train",
                           trainer.finalize, deps=[td], slot=slot,
                           cohort=c, rng=poisoned)
        else:
            tf = self._add(f"train[{c}]", "train", "train", trainer,
                           deps=[snode], slot=slot, cohort=c, rng=True)

        if _split(validator):
            vd = self._add(f"validate_dispatch[{c}]", "validate",
                           "validate", validator.dispatch,
                           deps=[tf, self._last_v], slot=slot, cohort=c,
                           rng=bool(getattr(validator, "dispatch_uses_rng",
                                            False)),
                           priority=0)
            vf = self._add(f"validate_finalize[{c}]", "validate_finalize",
                           "validate", validator.finalize, deps=[vd],
                           slot=slot, cohort=c, rng=collusion)
        else:
            # a validator without the split: conservatively an rng consumer
            vf = self._add(f"validate[{c}]", "validate_finalize",
                           "validate", validator,
                           deps=[tf, self._last_v], slot=slot, cohort=c,
                           rng=True)
        self._vf[c] = vf
        self._last_v = vf

        if c + 1 < pipe.max_cohorts:
            self._add_sample(c + 1)

    def _make_tail(self, trigger: Optional[StageNode], slot: CohortSlot) -> None:
        """pack -> aggregate -> elect -> reward, serialized after the last
        cohort node: every chain append happens here, in order."""
        if self._tail_made:
            return
        self._tail_made = True
        pipe = self.pipe
        dep = [trigger, self._last_v]

        def _reward_and_sync(ctx: RoundContext) -> None:
            pipe.rewarder(ctx)
            # the round's one final sync: nothing a caller observes (new
            # params, chain, logs) may still be in flight
            synchronize(ctx.device)

        for key, fn in (("pack", pipe.packer),
                        ("aggregate", pipe.aggregator),
                        ("elect", pipe.elector),
                        ("reward", _reward_and_sync)):
            node = self._add(key, "tail", key, fn, deps=dep, slot=slot,
                             rng=True)
            dep = [node]

    # ------------------------------------------------------------------
    # scheduler events
    # ------------------------------------------------------------------
    def _after_sample(self, node: StageNode) -> None:
        if self._tail_made:
            return
        if not node.slot.trainers:
            # an empty cohort: the sequential loop's break
            self._make_tail(node, node.slot)
            return
        self._add_cohort_body(node.cohort)

    def _after_validate(self, node: StageNode) -> None:
        if self._tail_made:
            return
        c = node.cohort
        if self.ctx.collected:
            nxt = self._samples.get(c + 1)
            if nxt is not None and not nxt.done:
                nxt.skipped = True
            live = [n for n in self.nodes
                    if n.cohort is not None and n.cohort > c
                    and (n.done or n.kind != "sample") and not n.skipped]
            if live:
                # a prefetch_safe sampler promised that `collected` fires
                # only on the last cohort; it fired early with cohort c+1's
                # work (and its rng draws) already issued: refuse a stream
                # the sequential engine would not have drawn
                raise RuntimeError(
                    "async schedule: `collected` fired at cohort "
                    f"{c} with cohort {c + 1} already prefetched; the "
                    "sampler's prefetch_safe contract requires the "
                    "trigger to fire on the last cohort only"
                )
            self._make_tail(node, node.slot)
        elif c + 1 >= self.pipe.max_cohorts:
            self._make_tail(node, node.slot)   # max_cohorts exhausted

    # ------------------------------------------------------------------
    # executor
    # ------------------------------------------------------------------
    def _pick(self) -> Optional[StageNode]:
        best = None
        best_k = None
        for n in self.nodes:
            if n.done or n.skipped:
                continue
            # a skipped dep (a cancelled prefetch sample) counts as met: it
            # never ran and never will, and everything it waited on was
            # done when it was skipped
            if any(not (d.done or d.skipped) for d in n.deps):
                continue
            k = (n.priority, n.order)
            if best is None or k < best_k:
                best, best_k = n, k
        return best

    def _exec(self, node: StageNode) -> None:
        ctx = self.ctx
        slot = node.slot
        with stage(node.bucket, ctx.timings):
            if slot is not None:
                for f in SLOT_FIELDS:
                    setattr(ctx, f, getattr(slot, f))
            try:
                node.fn(ctx)
            finally:
                if slot is not None:
                    for f in SLOT_FIELDS:
                        setattr(slot, f, getattr(ctx, f))
            node.done = True
            self.executed.append(node.key)
        if node.kind == "sample":
            self._after_sample(node)
        elif node.kind == "validate_finalize":
            self._after_validate(node)

    def run(self) -> None:
        ctx, pipe = self.ctx, self.pipe
        for key in STAGE_TIMING_KEYS:
            ctx.timings.setdefault(key, 0.0)
        prepare = getattr(pipe.validator, "prepare", None)
        if prepare is not None:
            self._last_v = self._add("prepare", "prepare", "validate",
                                     prepare, rng=True)
        if pipe.max_cohorts < 1:
            self._make_tail(self._last_v, CohortSlot(cohort=0))
        else:
            self._add_sample(0)
        while True:
            node = self._pick()
            if node is None:
                break
            self._exec(node)
        stuck = [n.key for n in self.nodes if not n.done and not n.skipped]
        if stuck:
            raise RuntimeError(
                f"async schedule deadlock: unrunnable nodes {stuck}"
            )
