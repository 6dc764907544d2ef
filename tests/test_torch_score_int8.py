"""The int8 committee scorer (path A) against the reference: the fused
candidates kernel, the score program, ``committee_int8`` rounds, and the
packer's reuse of the scorer's rows.

Inputs are made with numpy and fed to both packages; the reference runs
its Pallas kernels through ``repro.kernels.ops`` in interpret mode, the
port the plain versions its wrappers take for CPU tensors.

Tolerances: the fused candidates are bit-exact (both round
``fma(q, s, base)`` once).  The score program on identical inputs gives
bit-exact q and scales and equal scores (the candidates are equal, and at
these inputs no logit is near a tie).  The rounds (width 8, k = 3, 24
clients, 2 rounds, clean and 30 % malicious) hold RoundLogs, committees,
packed uploader ids and scores equal; blob q within +-1 and scales to
rtol 1e-5, because the two packages' local updates differ in the last
bits (convolution sum order) and a value can round across a half step;
both chains verify.  The cache tests compare the port with itself and are
bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jax_ravel_pytree

from repro.api import build_runtime as jax_build_runtime
from repro.configs import femnist_cnn as jcnn
from repro.data import make_femnist_like as jax_make_femnist_like
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro.fl.client import make_score_from_int8_fn as jax_score_from_int8
from repro.kernels import ops as jops
from repro_torch.api import build_runtime
from repro_torch.convert import from_numpy_tree
from repro_torch.core.aggregation import flatten_updates
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.client import make_score_from_int8_fn
from repro_torch.fl.pipeline import (
    CommitteeValidator,
    cache_row_quant,
    cached_row_stack,
    pack_top_k_int8,
    resolve,
)
from repro_torch.kernels import ops as tops
from repro_torch.tree import ravel_pytree

torch.set_num_threads(2)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
CFG = dict(active_proportion=0.5, k_updates=3, local_steps=2, local_batch=8,
           val_batch=16, quantize_chain=True, use_kernels=True, seed=0)
INT8 = {"validator": "committee_int8"}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


# ----------------------------------------------------------------------
# the fused candidates kernel
# ----------------------------------------------------------------------
@pytest.mark.parametrize("K", (1, 3, 17))
@pytest.mark.parametrize("D", (2048, 5000, 6145))
def test_candidates_from_quantized_bit_exact(K, D):
    rng = np.random.default_rng(K * 5 + D)
    x = (rng.standard_normal((K, D)) * 1e-2).astype(np.float32)
    base = (rng.standard_normal(D) * 0.05).astype(np.float32)
    q, s, d = jops.quantize_stack(jnp.asarray(x))
    q, s = np.asarray(q), np.asarray(s)
    want = np.asarray(jops.candidates_from_quantized(jnp.asarray(base),
                                                     jnp.asarray(q),
                                                     jnp.asarray(s), d))
    got = tops.candidates_from_quantized(torch.from_numpy(base),
                                         torch.from_numpy(q),
                                         torch.from_numpy(s), d).numpy()
    assert got.shape == (K, D)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ----------------------------------------------------------------------
# the score program
# ----------------------------------------------------------------------
def test_score_from_int8_matches_reference():
    rng = np.random.default_rng(9)
    params = jax.tree.map(np.asarray,
                          jax_femnist_adapter(8).init(jax.random.PRNGKey(1)))
    params["fc2"]["w"] = (rng.standard_normal((128, 62)) * 0.05).astype(np.float32)
    params["fc2"]["b"] = (rng.standard_normal(62) * 0.05).astype(np.float32)
    flat, unravel = jax_ravel_pytree(params)
    P, Q, vb = 4, 3, 16
    stack = (rng.standard_normal((P, flat.shape[0])) * 5e-2).astype(np.float32)
    vx = rng.standard_normal((Q, vb, 28, 28, 1)).astype(np.float32)
    # labels the base model predicts, so the candidates score between 0 and 1
    vy = np.asarray(jnp.argmax(jcnn.apply(params, jnp.asarray(vx.reshape(
        Q * vb, 28, 28, 1))), -1)).reshape(Q, vb).astype(np.int32)

    jscore = jax_score_from_int8(jax_femnist_adapter(8), unravel)
    js, jq, jsc = jscore(jax.tree.map(jnp.asarray, params), jnp.asarray(stack),
                         jnp.asarray(vx), jnp.asarray(vy))
    tparams = from_numpy_tree(params)
    tscore = make_score_from_int8_fn(femnist_adapter(8), ravel_pytree(tparams)[1])
    ts, tq, tsc = tscore(tparams, torch.from_numpy(stack),
                         torch.from_numpy(vx), torch.from_numpy(vy))
    assert ts.shape == (P, Q)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(tsc.numpy()), _bits(jsc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.unique(np.asarray(js)).size > 1          # informative scores


# ----------------------------------------------------------------------
# committee_int8 rounds against the reference
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def datasets():
    return jax_make_femnist_like(**DATA), make_femnist_like(**DATA)


@pytest.fixture(scope="module", params=(0.0, 0.3), ids=("clean", "malicious"))
def both(request, datasets):
    jd, td = datasets
    cfg = dict(CFG, malicious_fraction=request.param)
    init = jax_femnist_adapter(8).init(jax.random.PRNGKey(0))
    jrt = jax_build_runtime(jax_femnist_adapter(8), jd, cfg,
                            initial_params=init, stages=INT8)
    trt = build_runtime(femnist_adapter(8), td, cfg, stages=INT8, device="cpu",
                        initial_params=from_numpy_tree(jax.tree.map(np.asarray, init)))
    committees = []
    for _ in range(2):
        jrt.run_round()
        trt.run_round()
        committees.append((list(jrt.committee), list(trt.committee)))
    return jrt, trt, committees


def test_int8_round_logs_and_committees_equal(both):
    jrt, trt, committees = both
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    for jc, tc in committees:
        assert jc == tc


def test_int8_round_chains_agree(both):
    jrt, trt, _ = both
    assert jrt.chain.verify() and trt.chain.verify()
    assert trt.chain.height == jrt.chain.height
    for jb, tb in zip(jrt.chain.blocks, trt.chain.blocks):
        assert (tb.kind, tb.round, tb.uploader, tb.score, tb.encoded) == \
               (jb.kind, jb.round, jb.uploader, jb.score, jb.encoded)
        if tb.kind == "update":
            assert tb.encoded and tb.payload["d"] == jb.payload["d"]
            dq = (tb.payload["q"].numpy().astype(np.int32)
                  - np.asarray(jb.payload["q"]).astype(np.int32))
            assert np.abs(dq).max() <= 1
            np.testing.assert_allclose(tb.payload["scales"].numpy(),
                                       np.asarray(jb.payload["scales"]),
                                       rtol=1e-5)


# ----------------------------------------------------------------------
# the packer reuses the scorer's rows (the port against itself)
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tds(datasets):
    return datasets[1]


def _fingerprint(chain):
    return chain.height, [b.hash for b in chain.blocks]


def test_cached_rows_give_the_chain_of_a_fresh_quantize(tds):
    """Packing the cached rows or quantizing the packed updates again must
    not change a chain bit: the cached rows ARE the packer's blobs."""
    packer = resolve("packer", "top_k_int8")
    used_cache = []

    def cache_packer(ctx):
        packer(ctx)
        used_cache.append(cached_row_stack(ctx) is not None)

    def no_cache_packer(ctx):
        ctx.row_quant.clear()
        packer(ctx)

    rt_cache = build_runtime(femnist_adapter(8), tds, CFG, device="cpu",
                             stages={**INT8, "packer": cache_packer})
    rt_fresh = build_runtime(femnist_adapter(8), tds, CFG, device="cpu",
                             stages={**INT8, "packer": no_cache_packer})
    logs_c = rt_cache.run(2, eval_every=2)
    logs_f = rt_fresh.run(2, eval_every=2)
    assert used_cache == [True, True]
    assert logs_c == logs_f
    assert _fingerprint(rt_cache.chain) == _fingerprint(rt_fresh.chain)
    assert rt_cache.chain.verify()


class _StaleCacheValidator(CommitteeValidator):
    """Cohort 0: int8-scores the cohort (caching its rows) but admits
    nothing, so a second cohort re-draws the same uploaders with new
    updates.  Without the pipeline's per-cohort clear the packer would
    then store cohort 0's rows for cohort 1's updates."""

    def __call__(self, ctx):
        if ctx.cohort == 0:
            stack, _ = flatten_updates(ctx.cohort_updates)
            _, q, s = ctx.int8_score_fn(ctx.params, stack, ctx.val_x, ctx.val_y)
            cache_row_quant(ctx, q, s, int(stack.shape[1]))
            ctx.trainers_total += list(ctx.trainers)
            return
        super().__call__(ctx)


def test_row_quant_cleared_between_cohorts(tds):
    captured = {}

    def spy_packer(ctx):
        pack_top_k_int8(ctx)
        captured["q"], captured["s"] = ctx.packed_quantized[:2]
        captured["updates"] = list(ctx.packed_updates)

    cfg = dict(active_proportion=1.0, committee_fraction=0.3, k_updates=4,
               local_steps=2, local_batch=8, quantize_chain=True,
               use_kernels=True, seed=0)
    rt = build_runtime(femnist_adapter(8), tds, cfg, device="cpu",
                       stages={"validator": _StaleCacheValidator(),
                               "packer": spy_packer})
    rt.run_round()
    q, s, _ = tops.quantize_stack(flatten_updates(captured["updates"])[0])
    assert torch.equal(captured["q"], q)
    assert torch.equal(captured["s"], s)
