"""The slice end to end: the port's BFLC round against the reference's.

Both ``build_runtime``s run on the same synthetic community (the two
generators' arrays are asserted bit-equal) from the same reference init,
converted through ``from_numpy_tree``, with the same host seed.  Config:
width 8, k = 3, local_steps 2, local_batch 8, val_batch 16,
active_proportion 0.5, 24 clients.  Runs: the int8 chain for 2 rounds,
the f32 chain for 1 round, and the int8 chain at malicious_fraction 0.3
for 2 rounds.

Held equal: malicious sets, round-0 committees, each cohort's trainers,
``RoundLog``s, committees, packed uploader ids and scores.  Held close:
global params (atol 1e-5, convolution sum order), int8 blob scales
(rtol 1e-5) and q (within +-1: an update that differs in the last bits
can round across a half step).  Both chains must pass ``verify()``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import build_runtime as jax_build_runtime
from repro.data import make_femnist_like as jax_make_femnist_like
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro.fl.pipeline import sample_active as jax_sample_active
from repro_torch.api import build_runtime
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.pipeline import sample_active

torch.set_num_threads(2)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
CFG = dict(active_proportion=0.5, k_updates=3, local_steps=2, local_batch=8,
           val_batch=16, seed=0)
RUNS = {
    "int8": (dict(quantize_chain=True, use_kernels=True), 2),
    "f32": (dict(quantize_chain=False), 1),
    "int8_malicious": (dict(quantize_chain=True, use_kernels=True,
                            malicious_fraction=0.3), 2),
}


@pytest.fixture(scope="module")
def datasets():
    jd, td = jax_make_femnist_like(**DATA), make_femnist_like(**DATA)
    for name in ("client_images", "client_labels"):
        for a, b in zip(getattr(jd, name), getattr(td, name)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jd.test_images, td.test_images)
    np.testing.assert_array_equal(jd.test_labels, td.test_labels)
    return jd, td


def _recording(sampler, seen):
    def sample(ctx):
        sampler(ctx)
        seen.append(list(ctx.trainers))
    return sample


def _run_both(datasets, run):
    jd, td = datasets
    extra, rounds = RUNS[run]
    cfg = {**CFG, **extra}
    init = jax_femnist_adapter(8).init(jax.random.PRNGKey(cfg["seed"]))
    jax_seen, torch_seen = [], []
    jrt = jax_build_runtime(jax_femnist_adapter(8), jd, cfg, initial_params=init,
                            stages={"sampler": _recording(jax_sample_active, jax_seen)})
    trt = build_runtime(femnist_adapter(8), td, cfg,
                        initial_params=from_numpy_tree(jax.tree.map(np.asarray, init)),
                        stages={"sampler": _recording(sample_active, torch_seen)},
                        device="cpu")
    state = {"committee0": (list(jrt.committee), list(trt.committee)),
             "malicious": tuple({i for i, n in rt.manager.nodes.items()
                                 if n.is_malicious} for rt in (jrt, trt)),
             "committees": []}
    for _ in range(rounds):
        jrt.run_round()
        trt.run_round()
        state["committees"].append((list(jrt.committee), list(trt.committee)))
    state["trainers"] = (jax_seen, torch_seen)
    return jrt, trt, state


@pytest.fixture(scope="module", params=sorted(RUNS))
def both(request, datasets):
    return (request.param,) + _run_both(datasets, request.param)


def test_host_rng_outcomes_equal(both):
    run, jrt, trt, state = both
    jm, tm = state["malicious"]
    assert jm == tm
    assert (len(jm) > 0) == ("malicious" in run)
    j0, t0 = state["committee0"]
    assert j0 == t0
    jt, tt = state["trainers"]
    assert jt == tt and len(jt) >= len(trt.logs)
    for jc, tc in state["committees"]:
        assert jc == tc


def test_round_logs_equal(both):
    _, jrt, trt, _ = both
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]


def test_chain_blocks_and_params_agree(both):
    run, jrt, trt, _ = both
    assert jrt.chain.verify() and trt.chain.verify()
    assert trt.chain.height == jrt.chain.height
    for jb, tb in zip(jrt.chain.blocks, trt.chain.blocks):
        assert (tb.kind, tb.round, tb.uploader, tb.score, tb.encoded) == \
               (jb.kind, jb.round, jb.uploader, jb.score, jb.encoded)
        if tb.kind == "update" and tb.encoded:
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
                    np.testing.assert_allclose(got[k][kk], want[k][kk], atol=1e-5)


def test_test_accuracy_agrees(both):
    _, jrt, trt, _ = both
    np.testing.assert_allclose(trt.evaluate(), jrt.evaluate(), atol=1e-6)


def test_rewards_and_score_history_equal(both):
    _, jrt, trt, _ = both
    for i, jn in jrt.manager.nodes.items():
        tn = trt.manager.nodes[i]
        assert tn.score_history == jn.score_history
        assert tn.tokens == pytest.approx(jn.tokens, abs=1e-12)
