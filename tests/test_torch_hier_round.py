"""The tiered (two-tier) BFLC round of the port against the reference's.

Both ``build_runtime(..., tiers=S)``s run on the same synthetic community
(the two generators' arrays are asserted bit-equal) from the reference's
init, converted through ``from_numpy_tree``, with the same host seed, on
one device.  Config: the reference's own tiered test config (24 clients,
width 8, everyone active, committee_fraction 0.25, k_updates 4, 3 local
steps of batch 8, a quarter of the clients malicious at sigma 1.5): round
committee 6, pool 18, 2 slices of 9 (3-member sub-committee, 6 trainers).

Runs, 2 rounds each (so tier 2's collusion draws run):
  int8             int8 fedavg chain, f32 inner validator
  int8_committee   int8 chain, ``committee_int8`` inner validator (the
                   scorer's cached rows feed each slice's aggregation)
  int8_cwmed       int8 chain aggregated by the fused median
  f32_cwmed        f32 chain, ``use_kernels=True``, median
  f32              plain f32 fedavg chain
  accept_all       the consensus-free inner validator
  virtual_int8_trimmed_mean  tiers=3 over 60 virtual clients (3 slices of
                   15: 4-member sub-committees, 11 trainers), int8 chain,
                   trimmed mean trim 1 (S = 3 rows at tier 2)

Held equal: ``RoundLog``s, the committee after each round, every block's
kind, round, uploader and score (the packed uploader ids and scores),
each round's committee-block payload, and ``hier_logs``.  Held close:
params and f32 sub-aggregates (atol 1e-5, convolution sum order), int8
blob q (within +-1) and scales (rtol 1e-5); on int8 chains the model
blocks within 1e-5 plus one quantization step of the blocks they were
aggregated from (``test_blocks_and_params_agree``).  Both chains pass
``verify()``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import build_runtime as jax_build_runtime
from repro.data import VirtualFederatedDataset as JaxVirtualFederatedDataset
from repro.data import make_femnist_like as jax_make_femnist_like
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro_torch.api import build_runtime
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.blockchain import COMMITTEE, MODEL, UPDATE
from repro_torch.data import VirtualFederatedDataset, make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
HCFG = dict(active_proportion=1.0, committee_fraction=0.25, k_updates=4,
            local_steps=3, local_batch=8, malicious_fraction=0.25,
            attack_sigma=1.5, seed=0)
INT8 = dict(quantize_chain=True, use_kernels=True)
# run -> (config fields, stages, tiers, virtual clients or None)
RUNS = {
    "int8": (INT8, None, 2, None),
    "int8_committee": (INT8, {"validator": "committee_int8"}, 2, None),
    "int8_cwmed": ({**INT8, "aggregation": "cwmed"}, None, 2, None),
    "f32_cwmed": (dict(use_kernels=True, aggregation="cwmed"), None, 2, None),
    "f32": (dict(), None, 2, None),
    "accept_all": (dict(), {"validator": "accept_all"}, 2, None),
    "virtual_int8_trimmed_mean": ({**INT8, "aggregation": "trimmed_mean"},
                                  None, 3, 60),
}
ROUNDS = 2


@pytest.fixture(scope="module")
def datasets():
    jd, td = jax_make_femnist_like(**DATA), make_femnist_like(**DATA)
    for name in ("client_images", "client_labels"):
        for a, b in zip(getattr(jd, name), getattr(td, name)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jd.test_images, td.test_images)
    np.testing.assert_array_equal(jd.test_labels, td.test_labels)
    return jd, td


@pytest.fixture(scope="module")
def init():
    return jax_femnist_adapter(8).init(jax.random.PRNGKey(HCFG["seed"]))


def _port_init(init):
    return from_numpy_tree(jax.tree.map(np.asarray, init))


def _run_both(datasets, init, run):
    jd, td = datasets
    extra, stages, tiers, virtual = RUNS[run]
    if virtual:
        jd = JaxVirtualFederatedDataset(jd, virtual)
        td = VirtualFederatedDataset(td, virtual)
    cfg = {**HCFG, **extra}
    jrt = jax_build_runtime(jax_femnist_adapter(8), jd, cfg,
                            initial_params=init, stages=stages, tiers=tiers)
    trt = build_runtime(femnist_adapter(8), td, cfg,
                        initial_params=_port_init(init), stages=stages,
                        tiers=tiers, device="cpu")
    committees = []
    for _ in range(ROUNDS):
        jrt.run_round()
        trt.run_round()
        committees.append((list(jrt.committee), list(trt.committee)))
    return jrt, trt, committees


@pytest.fixture(scope="module", params=sorted(RUNS))
def both(request, datasets, init):
    return (request.param,) + _run_both(datasets, init, request.param)


def test_round_logs_and_committees_equal(both):
    _, jrt, trt, committees = both
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    for jc, tc in committees:
        assert jc == tc


def test_hier_logs_equal_to_the_byte(both):
    _, jrt, trt, _ = both
    assert trt.hier_logs == jrt.hier_logs
    assert len(trt.hier_logs) == ROUNDS
    for log in trt.hier_logs:
        assert 0 < log["peak_stack_bytes"] < log["flat_stack_bytes"]


def test_tiered_layout_and_committee_blocks_equal(both):
    run, jrt, trt, _ = both
    tiers = RUNS[run][2]
    assert jrt.chain.verify() and trt.chain.verify()
    assert trt.chain.tier2 and trt.chain.k == tiers
    assert trt.chain.period == tiers + 2
    kinds = [b.kind for b in trt.chain.blocks]
    assert kinds == ([MODEL] + [UPDATE] * tiers + [COMMITTEE]) * ROUNDS + [MODEL]
    for t in range(ROUNDS):
        jrec, trec = jrt.chain.committee_at_round(t), trt.chain.committee_at_round(t)
        assert sorted(trec) == sorted(jrec)
        for key in ("members", "uploaders", "scores", "medians", "accepted"):
            np.testing.assert_array_equal(trec[key], np.asarray(jrec[key]))
            assert trec[key].dtype == np.asarray(jrec[key]).dtype
        assert len(trec["uploaders"]) == tiers


def _lane_steps(blocks, d):
    """Per-lane quantization step of a round's int8 blocks: the largest
    scale over the blocks of each lane's 2048-lane tile, cut to D."""
    scales = np.max([b.payload["scales"].numpy() for b in blocks], axis=0)
    return np.repeat(scales, BLOCK_D)[:d]


def _flat(tree):
    return np.concatenate([np.asarray(l).ravel() for l in tree_leaves(tree)])


def test_blocks_and_params_agree(both):
    """Blocks within the module docstring's tolerances.  A model block on
    an int8 chain is held to atol 1e-5 plus one quantization step of the
    previous round's blocks at each lane: a blob q that rounds one step
    apart passes into the next model through the tier-2 reduction (a
    trimmed mean over S = 3 picks that blob's value whole)."""
    _, jrt, trt, _ = both
    assert trt.chain.height == jrt.chain.height
    for jb, tb in zip(jrt.chain.blocks, trt.chain.blocks):
        assert (tb.kind, tb.round, tb.uploader, tb.score, tb.encoded) == \
               (jb.kind, jb.round, jb.uploader, jb.score, jb.encoded)
        if tb.kind == COMMITTEE:
            continue
        if tb.kind == MODEL and tb.round > 0 and trt.chain.codec is not None:
            got = _flat(to_numpy_tree(tb.payload))
            want = _flat(jax.tree.map(np.asarray, jb.payload))
            step = _lane_steps(trt.chain.updates_at_round(tb.round - 1),
                               got.size)
            assert np.all(np.abs(got - want) <= 1e-5 + step)
        elif tb.encoded:
            assert tb.payload["d"] == jb.payload["d"]
            dq = (tb.payload["q"].numpy().astype(np.int32)
                  - np.asarray(jb.payload["q"]).astype(np.int32))
            assert np.abs(dq).max() <= 1
            np.testing.assert_allclose(tb.payload["scales"].numpy(),
                                       np.asarray(jb.payload["scales"]),
                                       rtol=1e-5)
        else:
            want = jax.tree.map(np.asarray, jb.payload)
            got = to_numpy_tree(tb.payload)
            for k in want:
                for kk in want[k]:
                    np.testing.assert_allclose(got[k][kk], want[k][kk],
                                               atol=1e-5)


def test_rewards_and_score_history_equal(both):
    _, jrt, trt, _ = both
    for i, jn in jrt.manager.nodes.items():
        tn = trt.manager.nodes[i]
        assert tn.score_history == jn.score_history
        assert tn.tokens == pytest.approx(jn.tokens, abs=1e-12)


# ----------------------------------------------------------------------
# the port on its own
# ----------------------------------------------------------------------
def _port(td, init, cfg=None, **kw):
    return build_runtime(femnist_adapter(8), td, {**HCFG, **(cfg or {})},
                         initial_params=_port_init(init), device="cpu", **kw)


def test_tiers_one_is_the_flat_round(datasets, init):
    _, td = datasets
    flat, one = _port(td, init, INT8), _port(td, init, INT8, tiers=1)
    assert [dataclasses.asdict(l) for l in flat.run(ROUNDS)] == \
           [dataclasses.asdict(l) for l in one.run(ROUNDS)]
    assert one.hier_logs == [] and not one.chain.tier2
    # a block's hash covers its payload's digest: equal hashes, equal
    # payloads
    assert [b.hash for b in one.chain.blocks] == \
           [b.hash for b in flat.chain.blocks]


def test_too_many_tiers_for_the_pool(datasets, init):
    # 24 active, Q = 6: a pool of 18 cannot feed 5 slices of >= 4 nodes
    _, td = datasets
    rt = _port(td, init, tiers=5)
    with pytest.raises(ValueError, match="active non-committee"):
        rt.run_round()


def test_tiers_rejected_for_baselines(datasets):
    _, td = datasets
    with pytest.raises(ValueError, match="committee"):
        build_runtime(femnist_adapter(8), td, dict(active_proportion=0.5),
                      baseline=True, tiers=2, device="cpu")


@pytest.mark.parametrize("tiers", (2, 3))
def test_trim_checked_against_the_tier_two_rows(datasets, init, tiers):
    """trim 1 needs S >= 3 rows at tier 2; the reference refuses S = 2 at
    build time too."""
    jd, td = datasets
    cfg = dict(aggregation="trimmed_mean", trim=1)
    if tiers == 2:
        with pytest.raises(ValueError, match="trim=1 invalid for 2"):
            _port(td, init, cfg, tiers=tiers)
        with pytest.raises(ValueError, match="trim=1 invalid for 2"):
            jax_build_runtime(jax_femnist_adapter(8), jd, {**HCFG, **cfg},
                              initial_params=init, tiers=tiers)
    else:
        assert _port(td, init, cfg, tiers=tiers).chain.k == 3


@pytest.mark.parametrize("stage", (("sampler", "tiered"), ("validator", "hier"),
                                   ("packer", "hier")))
def test_tiered_stages_need_a_tiered_runtime(datasets, init, stage):
    """The tiered stage names resolve in a flat runtime, whose round then
    fails with the stage's own message, not a KeyError."""
    _, td = datasets
    rt = _port(td, init, stages=dict([stage]))
    with pytest.raises(RuntimeError, match="tiers >= 2"):
        rt.run_round()
