"""The port's f32 aggregation kernels and the f32 kernel path of a round,
against the reference.

Both packages get the same numpy stacks.  The reference runs its Pallas
kernels through ``repro.kernels.ops`` (interpret mode on the CPU, as its
own tests run them); the port runs the plain versions its wrappers take for
CPU tensors, the versions the CUDA kernels are held against on the card.
At K = 90 the reference's median and trimmed mean are its own reductions
(``median_of_sorted``, ``trimmed_mean_of_sorted``) jitted over
``jnp.sort`` in place of its odd-even network, whose 90-phase unrolled
program takes minutes to compile in interpret mode; a sort's order
statistics do not depend on the sorting method.

Tolerances: fedavg is bit-exact given the same normalized weights for
K <= 32 (both are the FMA chain ``acc = fma(x_k, w_k, acc)``); from raw
weights it is held to rtol 1e-6 where K >= 17, because the two packages
sum the weights in another order before normalizing.  For K > 32 XLA's
CPU reduction stops being that chain (it sums in an order no sequential
or interleaved chain reproduces), so K = 90 is held to an absolute error
of 1e-6 * max|result|: the results cancel to about a tenth of the inputs,
so relative error per lane can reach 1e-4.  The trimmed mean is
bit-exact.  The median is held equal by value: with ties of +0.0 and
-0.0, which a sign-flip attack puts in a stack, a sort may return either
zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_runtime as jax_build_runtime
from repro.core.aggregation import normalize_weights as jax_normalize_weights
from repro.data import make_femnist_like as jax_make_femnist_like
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro.kernels.cwmed import median_of_sorted, trimmed_mean_of_sorted
from repro.kernels import ops as jops
from repro_torch.api import build_runtime
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

KS = (1, 2, 3, 8, 17, 90)
DS = (2048, 5000, 6145)
METHODS = ("fedavg", "cwmed", "trimmed_mean")


def make_stack(K: int, D: int, seed: int, signed_zeros: bool = False):
    """(K, D) f32 update-sized normals.  With ``signed_zeros`` the first
    1024 lanes hold ties of +0.0 and -0.0 (half the rows each)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((K, D)) * 1e-3).astype(np.float32)
    if signed_zeros:
        x[:, :1024] = 0.0
        x[K // 2:, :1024] = -0.0
    return x


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _reference(x: np.ndarray, method: str, trim: int) -> np.ndarray:
    K = x.shape[0]
    if method == "fedavg" or K < 90:
        return np.asarray(jops.aggregate(jnp.asarray(x), method, trim=trim))
    rows = list(jnp.sort(jnp.asarray(x), axis=0))
    if method == "cwmed":
        return np.asarray(jax.jit(median_of_sorted)(rows))
    reduce = jax.jit(lambda r: trimmed_mean_of_sorted(r, trim))
    return np.asarray(reduce(rows))


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("method", METHODS)
def test_aggregate_matches_reference(K, D, method):
    x = make_stack(K, D, seed=K * 7 + D)
    trim = (K - 1) // 2
    want = _reference(x, method, trim)
    got = tops.aggregate(torch.from_numpy(x), method, trim=trim).numpy()
    assert got.shape == (D,)
    if method == "trimmed_mean":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    elif method == "cwmed":
        np.testing.assert_array_equal(got, want)
    else:
        _assert_fedavg_close(got, want, exact=K < 17)


def _assert_fedavg_close(got, want, exact: bool) -> None:
    if exact:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("D", DS)
def test_fedavg_agg_bit_exact_given_the_same_weights(K, D):
    x = make_stack(K, D, seed=K + 3 * D)
    raw = np.random.default_rng(K).random(K).astype(np.float32)
    w = np.array(jax_normalize_weights(K, jnp.asarray(raw)))
    want = np.asarray(jops.fedavg_agg(jnp.asarray(x), jnp.asarray(w)))
    got = tops.fedavg_agg(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    _assert_fedavg_close(got, want, exact=K <= 32)


@pytest.mark.parametrize("K", (2, 3, 8))
@pytest.mark.parametrize("method", METHODS)
def test_signed_zero_ties_agree_by_value(K, method):
    x = make_stack(K, 5000, seed=K, signed_zeros=True)
    x[1, 1024:1100] = -x[1, 1024:1100]               # more sign flips
    trim = (K - 1) // 2
    want = _reference(x, method, trim)
    got = tops.aggregate(torch.from_numpy(x), method, trim=trim).numpy()
    np.testing.assert_array_equal(got, want)          # -0.0 == +0.0
    np.testing.assert_array_equal(_bits(got[1024:]), _bits(want[1024:]))


def test_wrappers_refuse_bad_input():
    with pytest.raises(ValueError, match="trim"):
        tops.trimmed_mean(torch.zeros((4, 8)), trim=2)
    with pytest.raises(TypeError):
        tops.cwmed(torch.zeros((2, 3, 8)))               # not 2-D
    with pytest.raises(ValueError, match="weights"):
        tops.fedavg_agg(torch.zeros((3, 8)), torch.ones(2))
    with pytest.raises(ValueError, match="unknown method"):
        tops.aggregate(torch.zeros((3, 8)), "mean")


# ----------------------------------------------------------------------
# path B: use_kernels=True, quantize_chain=False rounds
# ----------------------------------------------------------------------
DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
CFG = dict(active_proportion=0.5, k_updates=3, local_steps=2, local_batch=8,
           val_batch=16, use_kernels=True, quantize_chain=False, seed=0)


@pytest.fixture(scope="module")
def datasets():
    return jax_make_femnist_like(**DATA), make_femnist_like(**DATA)


@pytest.mark.parametrize("method", METHODS)
def test_f32_kernel_round_matches_reference(datasets, method):
    """One round with the f32 kernels aggregating: equal RoundLogs and
    committees, params within atol 1e-5 (training's convolution sum order
    differs), both chains verify."""
    jd, td = datasets
    cfg = dict(CFG, aggregation=method)
    init = jax_femnist_adapter(8).init(jax.random.PRNGKey(0))
    jrt = jax_build_runtime(jax_femnist_adapter(8), jd, cfg, initial_params=init)
    trt = build_runtime(femnist_adapter(8), td, cfg, device="cpu",
                        initial_params=from_numpy_tree(jax.tree.map(np.asarray, init)))
    jrt.run_round()
    trt.run_round()
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    assert trt.committee == jrt.committee
    assert jrt.chain.verify() and trt.chain.verify()
    want = jax.tree.map(np.asarray, jrt.global_params())
    got = to_numpy_tree(trt.global_params())
    for k in want:
        for kk in want[k]:
            np.testing.assert_allclose(got[k][kk], want[k][kk], rtol=0, atol=1e-5)
