"""The flat BFLC round's other options, the port against the reference.

``tests/test_torch_round.py`` holds three configs.  This file holds the
rest of the flat round's options, one case each: the poison attacks
``sign_flip`` and ``scaled``, ``collusion=False``, ``kick_below`` (the
rewarder's blacklist), ``election_method`` ``random`` and
``multi_factor``, ``weight_by_score=False``, ``honest_bootstrap=False``,
``prune_keep_rounds``, and the plain (``use_kernels=False``) median and
trimmed-mean chains.  The options change which host rng draws happen
where (an attack's draws, the collusion overlay's, a random election's),
so each case also runs under both of the port's schedules: the async
engine's rng edges must replay the sequential stream.

Each case runs 2 rounds of the reference's ``build_runtime``
(``repro.fl.pipeline``, the staged reference, not the legacy monolith)
and of the port's, from the reference's init on the same synthetic
community (width 8, 24 clients, k = 3, 2 local steps of batch 8, val
batch 16, a third of the clients malicious).  Held equal: ``RoundLog``s,
the committee after each round, blacklists, every node's tokens (to
1e-12) and score history, and every block's kind, round, uploader and
score.  Held close: params and f32 update blocks within 6e-8.  Both
chains pass ``verify()``.
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
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
BASE = dict(active_proportion=0.5, k_updates=3, local_steps=2, local_batch=8,
            val_batch=16, malicious_fraction=0.3, seed=0)
OPTIONS = {
    "sign_flip": dict(attack="sign_flip"),
    "scaled": dict(attack="scaled"),
    "no_collusion": dict(collusion=False),
    "kick_below": dict(kick_below=0.05),
    "election_random": dict(election_method="random"),
    "election_multi_factor": dict(election_method="multi_factor"),
    "unweighted": dict(weight_by_score=False),
    "random_bootstrap": dict(honest_bootstrap=False),
    "prune": dict(prune_keep_rounds=1),
    "plain_cwmed": dict(aggregation="cwmed", use_kernels=False),
    "plain_trimmed_mean": dict(aggregation="trimmed_mean", use_kernels=False),
}
ROUNDS = 2
ATOL = 6e-8


@pytest.fixture(scope="module")
def datasets():
    jd, td = jax_make_femnist_like(**DATA), make_femnist_like(**DATA)
    for a, b in zip(jd.client_images, td.client_images):
        np.testing.assert_array_equal(a, b)
    return jd, td


@pytest.fixture(scope="module")
def init():
    return jax_femnist_adapter(8).init(jax.random.PRNGKey(BASE["seed"]))


def _committees(rt):
    out = []
    for _ in range(ROUNDS):
        rt.run_round()
        out.append(list(rt.committee))
    return out


@pytest.fixture(scope="module", params=sorted(OPTIONS))
def reference(request, datasets, init):
    cfg = {**BASE, **OPTIONS[request.param]}
    jrt = jax_build_runtime(jax_femnist_adapter(8), datasets[0], cfg,
                            initial_params=init)
    return request.param, cfg, jrt, _committees(jrt)


def _flat(tree):
    return np.concatenate([np.asarray(l).ravel() for l in tree_leaves(tree)])


@pytest.mark.parametrize("schedule", ("sequential", "async"))
def test_option_matches_the_reference(reference, datasets, init, schedule):
    option, cfg, jrt, jcommittees = reference
    trt = build_runtime(femnist_adapter(8), datasets[1], cfg,
                        initial_params=from_numpy_tree(
                            jax.tree.map(np.asarray, init)),
                        schedule=schedule, device="cpu")
    assert _committees(trt) == jcommittees
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    assert trt.manager.blacklist == jrt.manager.blacklist
    if option == "kick_below":
        assert trt.manager.blacklist                 # the option did kick
    assert sorted(trt.manager.nodes) == sorted(jrt.manager.nodes)
    for i, jn in jrt.manager.nodes.items():
        tn = trt.manager.nodes[i]
        assert tn.score_history == jn.score_history
        assert tn.tokens == pytest.approx(jn.tokens, abs=1e-12)
    assert jrt.chain.verify() and trt.chain.verify()
    assert trt.chain.height == jrt.chain.height
    for jb, tb in zip(jrt.chain.blocks, trt.chain.blocks):
        assert (tb.kind, tb.round, tb.uploader, tb.score) == \
               (jb.kind, jb.round, jb.uploader, jb.score)
        assert (tb.payload is None) == (jb.payload is None)
        if tb.payload is not None:
            got = _flat(to_numpy_tree(tb.payload))
            want = _flat(jax.tree.map(np.asarray, jb.payload))
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_flat(to_numpy_tree(trt.global_params())),
                               _flat(jax.tree.map(np.asarray,
                                                  jrt.global_params())),
                               rtol=0, atol=ATOL)
