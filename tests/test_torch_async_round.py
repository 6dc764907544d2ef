"""The port's asynchronous round engine (``repro_torch.fl.async_engine``).

The async engine replaces the round's schedule, not its stages, so the
same community and seed through ``schedule="sequential"`` and
``schedule="async"`` must give bit-identical products: every chain block
(hash, payload leaves, uploader, score), ``RoundLog``s, committees,
params and ``hier_logs``.  Config: the reference's own async suite
(``tests/test_async_round.py``: 24 clients, width 8, ``CFG`` / ``FAST``),
2 rounds.  Cases, the port against itself:

  flat_f32_clean       rng edges leave training and validation free to
                       overlap
  flat_f32_malicious   attack and collusion draws chain the graph into the
                       sequential order
  flat_int8_committee  the int8 chain scored by ``committee_int8`` (the
                       scorer's cached rows reach the packer)
  tiered_int8          tiers=2, int8 chain (the prefetch-safe sampler:
                       slice s+1 trains while slice s sub-aggregates)
  tiered_f32           tiers=3, f32 chain, clean
  baseline             the committee-free ``FLTrainer``

The port's async engine also runs against the reference's
``schedule="async"`` runtime (flat int8, tiered int8) from the reference's
init, held to ``tests/test_torch_round.py``'s tolerances: RoundLogs,
committees and ``hier_logs`` equal, params within 1e-5 (tiered: plus one
quantization step a lane, as ``tests/test_torch_hier_round.py`` holds
them), blob q within +-1.

Failure edges: a mid-ring raise leaves the chain untouched under both
schedules; ``max_cohorts`` exhaustion drains the ring and runs one tail;
``row_quant`` is per ring slot (the stale-cache regression); a
``prefetch_safe`` sampler whose trigger fires early is refused; the ring's
fields exist on ``RoundContext``; the timing schema; and the node order of
a clean tiered round puts ``train_dispatch[1]`` before
``validate_finalize[0]``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import build_runtime as jax_build_runtime
from repro.data import make_femnist_like as jax_make_femnist_like
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro_torch.api import build_runtime
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.aggregation import flatten_updates
from repro_torch.core.blockchain import COMMITTEE, UPDATE
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.async_engine import SLOT_FIELDS, AsyncRoundPipeline
from repro_torch.fl.pipeline import (
    STAGE_TIMING_KEYS,
    CommitteeValidator,
    RoundContext,
    cache_row_quant,
    pack_top_k_int8,
    resolve,
    sample_active,
)
from repro_torch.kernels.ops import quantize_stack
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
CFG = dict(active_proportion=0.5, committee_fraction=0.3, k_updates=4,
           local_steps=3, local_batch=8, malicious_fraction=0.25,
           attack_sigma=1.5, seed=0)
# small/fast variant for the failure-edge tests
FAST = dict(CFG, local_steps=2)
INT8 = dict(quantize_chain=True, use_kernels=True)
ROUNDS = 2
# run -> (config, stages, tiers)
PAIRS = {
    "flat_f32_clean": (dict(CFG, malicious_fraction=0.0), None, None),
    "flat_f32_malicious": (CFG, None, None),
    "flat_int8_committee": (dict(CFG, **INT8), {"validator": "committee_int8"},
                            None),
    "tiered_int8": (dict(CFG, active_proportion=1.0, **INT8), None, 2),
    "tiered_f32": (dict(CFG, active_proportion=1.0, malicious_fraction=0.0),
                   None, 3),
}


@pytest.fixture(scope="module")
def datasets():
    jd, td = jax_make_femnist_like(**DATA), make_femnist_like(**DATA)
    for a, b in zip(jd.client_images, td.client_images):
        np.testing.assert_array_equal(a, b)
    return jd, td


@pytest.fixture(scope="module")
def td(datasets):
    return datasets[1]


def _build(td, cfg, schedule="sequential", **kw):
    return build_runtime(femnist_adapter(8), td, dict(cfg), schedule=schedule,
                         device="cpu", **kw)


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def _assert_bit_identical(seq, asy):
    assert [dataclasses.asdict(l) for l in seq.logs] == \
           [dataclasses.asdict(l) for l in asy.logs]
    assert seq.committee == asy.committee
    assert seq.chain.verify() and asy.chain.verify()
    assert seq.chain.height == asy.chain.height
    for bs, ba in zip(seq.chain.blocks, asy.chain.blocks):
        assert (bs.kind, bs.round, bs.uploader, bs.score, bs.hash) == \
               (ba.kind, ba.round, ba.uploader, ba.score, ba.hash)
        if bs.kind != COMMITTEE:
            _leaves_equal(seq.chain.raw_payload(bs), asy.chain.raw_payload(ba))
    _leaves_equal(seq.global_params(), asy.global_params())
    assert seq.hier_logs == asy.hier_logs


@pytest.fixture(scope="module", params=sorted(PAIRS))
def pair(request, td):
    cfg, stages, tiers = PAIRS[request.param]
    seq = _build(td, cfg, stages=stages, tiers=tiers)
    asy = _build(td, cfg, "async", stages=stages, tiers=tiers)
    seq.run(ROUNDS, eval_every=ROUNDS)
    asy.run(ROUNDS, eval_every=ROUNDS)
    return request.param, seq, asy


# ----------------------------------------------------------------------
# the port's async engine against the port's sequential engine
# ----------------------------------------------------------------------
def test_async_is_bit_identical_to_sequential(pair):
    run, seq, asy = pair
    assert isinstance(asy.pipeline, AsyncRoundPipeline)
    _assert_bit_identical(seq, asy)
    if run.startswith("tiered"):
        assert len(asy.hier_logs) == ROUNDS


def test_async_round_ran_every_cohort_node(pair):
    """Every cohort's split halves ran, in the sequential engine's cohort
    order, and the tail ran once after them."""
    _, _, asy = pair
    order = asy.pipeline.last_order
    assert order[-4:] == ["pack", "aggregate", "elect", "reward"]
    cohorts = sorted({int(k[k.index("[") + 1:-1]) for k in order if "[" in k})
    assert cohorts == list(range(len(cohorts)))
    for c in cohorts:
        keys = [f"sample[{c}]", f"train_dispatch[{c}]", f"train_finalize[{c}]",
                f"validate_dispatch[{c}]", f"validate_finalize[{c}]"]
        idx = [order.index(k) for k in keys]
        assert idx == sorted(idx)


def test_async_baseline_is_bit_identical(td):
    """FLTrainer (committee-free) under the async schedule: the same params
    and accuracies."""
    cfg = dict(active_proportion=0.5, local_steps=2, local_batch=8,
               malicious_fraction=0.25, seed=0)
    seq = build_runtime(femnist_adapter(8), td, dict(cfg), baseline=True,
                        device="cpu")
    asy = build_runtime(femnist_adapter(8), td, dict(cfg), baseline=True,
                        schedule="async", device="cpu")
    assert isinstance(asy.pipeline, AsyncRoundPipeline)
    seq.run(ROUNDS)
    asy.run(ROUNDS)
    assert seq.accuracies == asy.accuracies
    _leaves_equal(seq.params, asy.params)


# ----------------------------------------------------------------------
# the port's async engine against the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tiers", (None, 2), ids=("flat_int8", "tiered_int8"))
def test_async_matches_the_reference_async_runtime(datasets, tiers):
    jd, td = datasets
    cfg = dict(CFG, **INT8)
    if tiers:
        cfg["active_proportion"] = 1.0
    init = jax_femnist_adapter(8).init(jax.random.PRNGKey(cfg["seed"]))
    jrt = jax_build_runtime(jax_femnist_adapter(8), jd, dict(cfg),
                            initial_params=init, tiers=tiers,
                            schedule="async")
    trt = build_runtime(femnist_adapter(8), td, dict(cfg),
                        initial_params=from_numpy_tree(
                            jax.tree.map(np.asarray, init)),
                        tiers=tiers, schedule="async", device="cpu")
    for _ in range(ROUNDS):
        jrt.run_round()
        trt.run_round()
        assert trt.committee == jrt.committee
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    assert trt.hier_logs == jrt.hier_logs
    assert jrt.chain.verify() and trt.chain.verify()
    assert trt.chain.height == jrt.chain.height
    for jb, tb in zip(jrt.chain.blocks, trt.chain.blocks):
        assert (tb.kind, tb.round, tb.uploader, tb.score) == \
               (jb.kind, jb.round, jb.uploader, jb.score)
        if tb.kind == UPDATE:
            assert tb.payload["d"] == jb.payload["d"]
            dq = (tb.payload["q"].numpy().astype(np.int32)
                  - np.asarray(jb.payload["q"]).astype(np.int32))
            assert np.abs(dq).max() <= 1
    want = _flat(jax.tree.map(np.asarray, jrt.global_params()))
    got = _flat(to_numpy_tree(trt.global_params()))
    # a tiered round's sub-blob whose q rounds one step apart from the
    # reference's passes that step into the next model through the tier-2
    # reduction, so tiered params are held as tests/test_torch_hier_round.py
    # holds them: 1e-5 plus one quantization step of the round's blocks
    step = (_lane_steps(trt.chain.updates_at_round(ROUNDS - 1), got.size)
            if tiers else 0.0)
    assert np.all(np.abs(got - want) <= 1e-5 + step)


def _flat(tree):
    return np.concatenate([np.asarray(l).ravel() for l in tree_leaves(tree)])


def _lane_steps(blocks, d):
    """Per-lane quantization step of a round's int8 blocks: the largest
    scale over the blocks of each lane's 2048-lane tile, cut to D."""
    scales = np.max([b.payload["scales"].numpy() for b in blocks], axis=0)
    return np.repeat(scales, BLOCK_D)[:d]


# ----------------------------------------------------------------------
# wiring
# ----------------------------------------------------------------------
def test_async_wraps_the_same_stage_set(td):
    seq, asy = _build(td, CFG), _build(td, CFG, "async")
    assert asy.schedule == "async" and seq.schedule == "sequential"
    for kind in ("sampler", "local_trainer", "validator", "packer",
                 "aggregator", "elector", "rewarder"):
        assert getattr(asy.pipeline, kind) is getattr(seq.pipeline, kind)
    assert asy.pipeline.max_cohorts == seq.pipeline.max_cohorts


@pytest.mark.parametrize("baseline", (False, True))
def test_schedule_validation_and_mesh_refusal(td, baseline):
    cfg = dict(seed=0) if baseline else dict(CFG)
    with pytest.raises(ValueError, match="schedule"):
        build_runtime(femnist_adapter(8), td, cfg, baseline=baseline,
                      schedule="overlapped", device="cpu")
    with pytest.raises(TypeError, match="make_round_mesh"):
        build_runtime(femnist_adapter(8), td, cfg, baseline=baseline,
                      schedule="async", mesh=object(), device="cpu")


def test_slot_fields_exist_on_the_context():
    ctx = RoundContext(cfg=None, rng=np.random.default_rng(0), adapter=None,
                       data=None, params=None, round=0)
    for f in SLOT_FIELDS:
        assert hasattr(ctx, f)


def test_async_timing_schema(td):
    rt = _build(td, FAST, "async")
    rt.run_round()
    timings = rt.stage_timings[0]
    assert set(timings) == set(STAGE_TIMING_KEYS)
    assert timings["train"] > 0 and timings["validate"] > 0


def test_clean_tiered_round_trains_slice_one_before_finalizing_slice_zero(td):
    """The headline overlap: with no malicious node the rng edges leave
    slice 1's training free to be dispatched before slice 0's validation
    finalizes (and sub-aggregates)."""
    cfg = dict(FAST, active_proportion=1.0, malicious_fraction=0.0, **INT8)
    rt = _build(td, cfg, "async", tiers=2,
                stages={"validator": "committee_int8"})
    rt.run_round()
    order = rt.pipeline.last_order
    assert order.index("train_dispatch[1]") < order.index("validate_finalize[0]")
    assert order.index("validate_dispatch[0]") < order.index("train_dispatch[1]")


# ----------------------------------------------------------------------
# failure edges
# ----------------------------------------------------------------------
class _Boom(Exception):
    pass


class _RaisingValidator:
    """Delegates to the committee validator, forces a second cohort and
    raises mid-ring (cohort 1's validation, with cohort work in flight)."""

    def __init__(self):
        self.inner = resolve("validator", "committee")
        self.cohorts_seen = []

    def prepare(self, ctx):
        self.inner.prepare(ctx)

    def __call__(self, ctx):
        self.cohorts_seen.append(ctx.cohort)
        if ctx.cohort >= 1:
            raise _Boom("mid-ring failure")
        self.inner(ctx)
        ctx.collected = False      # force the ring past cohort 0


@pytest.mark.parametrize("schedule", ("sequential", "async"))
def test_midring_failure_leaves_chain_untouched(td, schedule):
    """Every chain append lives in the tail, so a stage raising with a
    later cohort in flight commits nothing."""
    val = _RaisingValidator()
    rt = _build(td, FAST, schedule, stages={"validator": val})
    h0, blocks0 = rt.chain.height, [b.hash for b in rt.chain.blocks]
    with pytest.raises(_Boom):
        rt.run_round()
    assert val.cohorts_seen == [0, 1]
    assert rt.chain.height == h0
    assert [b.hash for b in rt.chain.blocks] == blocks0
    assert rt.chain.verify()
    assert rt.logs == []


class _NeverCollect:
    """The committee validator with its trigger never fired: the ring runs
    to max_cohorts."""

    def __init__(self):
        self.inner = resolve("validator", "committee")

    def prepare(self, ctx):
        self.inner.prepare(ctx)

    def __call__(self, ctx):
        self.inner(ctx)
        ctx.collected = False


def test_max_cohorts_exhaustion_drains_ring(td):
    seq = _build(td, FAST, stages={"validator": _NeverCollect()})
    asy = _build(td, FAST, "async", stages={"validator": _NeverCollect()})
    log_seq, log_asy = seq.run_round(), asy.run_round()
    assert log_seq == log_asy
    assert log_asy.trainers > asy.p_trainers        # more than one cohort ran
    assert [b.hash for b in seq.chain.blocks] == [b.hash for b in asy.chain.blocks]
    assert asy.chain.verify()
    # exactly one tail: k update blocks and one model block over genesis
    assert asy.chain.height == 1 + FAST["k_updates"] + 1
    assert asy.pipeline.last_order.count("pack") == 1
    assert asy.pipeline.last_order[-5] == \
        f"validate[{asy.pipeline.max_cohorts - 1}]"


class _StaleCacheValidator(CommitteeValidator):
    """Cohort 0: int8-scores the cohort (caching its rows in the cohort's
    ``row_quant``) but admits nothing, so cohort 1 re-draws the same
    uploaders with new updates.  A row cache shared across cohorts would
    put cohort 0's rows on the chain for cohort 1's updates."""

    def _scores_device(self, ctx):
        stack, _ = flatten_updates(ctx.cohort_updates)
        scores, q, s = ctx.int8_score_fn(ctx.params, stack, ctx.val_x, ctx.val_y)
        if ctx.cohort == 0:
            cache_row_quant(ctx, q, s, int(stack.shape[1]))
        return scores

    def finalize(self, ctx):
        if ctx.cohort == 0:
            ctx.cohort_scores.wait()
            ctx.trainers_total += list(ctx.trainers)
            return
        super().finalize(ctx)


@pytest.mark.parametrize("schedule", ("sequential", "async"))
def test_row_quant_is_per_cohort(td, schedule):
    captured = {}

    def spy_packer(ctx):
        pack_top_k_int8(ctx)
        captured["q"], captured["s"] = ctx.packed_quantized[:2]
        captured["updates"] = list(ctx.packed_updates)

    cfg = dict(active_proportion=1.0, committee_fraction=0.3, k_updates=4,
               local_steps=2, local_batch=8, seed=0, **INT8)
    rt = _build(td, cfg, schedule, stages={"validator": _StaleCacheValidator(),
                                           "packer": spy_packer})
    rt.run_round()
    assert rt.logs[0].trainers > rt.p_trainers       # cohort 1 ran
    q, s, _ = quantize_stack(flatten_updates(captured["updates"])[0])
    assert torch.equal(captured["q"], q)
    assert torch.equal(captured["s"], s)


def test_prefetch_safe_sampler_with_an_early_trigger_is_refused(td):
    """A sampler that claims prefetch safety but whose trigger fires before
    the last cohort: the engine has already drawn cohort 1's rng, which the
    sequential engine would not, so it raises instead of diverging."""

    def sampler(ctx):
        sample_active(ctx)

    sampler.prefetch_safe = True
    cfg = dict(FAST, malicious_fraction=0.0, active_proportion=1.0)
    seq = _build(td, cfg, stages={"sampler": sampler})
    seq.run_round()
    assert seq.logs[0].trainers == seq.p_trainers    # collected at cohort 0
    asy = _build(td, cfg, "async", stages={"sampler": sampler})
    with pytest.raises(RuntimeError, match="prefetch_safe"):
        asy.run_round()
    assert "sample[1]" in asy.pipeline.last_order
    assert asy.chain.height == 1
