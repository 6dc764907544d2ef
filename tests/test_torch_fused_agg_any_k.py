"""The fused int8 aggregation's sort methods above the register network's
K <= 32, against the reference.

The reference's fused kernel takes cwmed and trimmed_mean at any K (its
checks are the tile alignment, the method and the trim); the port's must
too.  Both packages get the same numpy stack, quantized by the reference
(``repro.kernels.ops.quantize_stack``); the port runs
``ops.aggregate_quantized`` on the CPU (its plain version, the one the CUDA
kernel is held against on the card).  The reference value is its own
reductions (``median_of_sorted``, ``trimmed_mean_of_sorted``) jitted over
``jnp.sort`` of its dequantized stack, in place of its odd-even network,
whose unrolled program at such K takes minutes to compile in interpret
mode; a sort's order statistics do not depend on the sorting method.  With
``quantize_out`` the reference requantizes that value with its own
``quantize``.

Tolerances, as ``tests/test_torch_kernels.py`` holds the fused kernel at
small K: the median exact, by value; the trimmed mean to rtol 1e-6 with
atol 1e-6 * max|x|; with quantize_out, q within +-1 and the scales to rtol
1e-6 for the trimmed mean, both exact for the median.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.cwmed import median_of_sorted, trimmed_mean_of_sorted
from repro.kernels.ref import dequantize_stack_ref
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

KS = (33, 64, 65, 90)
DS = (2048, 6145)
# (method, trim): the trim of a trimmed mean is 1 or (K - 1) // 2
FORMS = (("cwmed", "none"), ("trimmed_mean", "one"), ("trimmed_mean", "half"))


def make_stack(K: int, D: int, seed: int) -> np.ndarray:
    """Update-sized normals; row 0 of exact half steps whose tiles have
    amax 127; one all-zero tile in every row where D allows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((K, D)) * 1e-3).astype(np.float32)
    half = (np.arange(D) % 251 - 125.5).astype(np.float32)
    half[::2048] = 127.0
    x[0] = half
    if D > 4096:
        x[:, 2048:4096] = 0.0
    return x


def _trim(K: int, which: str) -> int:
    return {"none": 0, "one": 1, "half": (K - 1) // 2}[which]


@functools.lru_cache(maxsize=None)
def _case(K: int, D: int, method: str, trim: int):
    """The quantized stack and the reference's aggregate over its padded
    width (numpy)."""
    x = make_stack(K, D, seed=K * 131 + D)
    q, s, d = jops.quantize_stack(jnp.asarray(x))
    rows = list(jnp.sort(dequantize_stack_ref(q, s), axis=0))
    if method == "cwmed":
        want = jax.jit(median_of_sorted)(rows)
    else:
        want = jax.jit(lambda r: trimmed_mean_of_sorted(r, trim))(rows)
    return np.asarray(q), np.asarray(s), d, np.asarray(want)


@pytest.mark.parametrize("quantize_out", (False, True), ids=("f32", "qout"))
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("K", KS)
def test_sort_methods_take_any_K(K, D, form, quantize_out):
    method, which = form
    trim = _trim(K, which)
    q, s, d, want = _case(K, D, method, trim)
    tq, ts = torch.from_numpy(q), torch.from_numpy(s)
    exact = method == "cwmed"
    if not quantize_out:
        got = tops.aggregate_quantized(tq, ts, d, method=method,
                                       trim=trim).numpy()
        assert got.shape == (D,)
        if exact:
            np.testing.assert_array_equal(got, want[:D])
        else:
            np.testing.assert_allclose(got, want[:D], rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        return
    qt, st, dt = tops.aggregate_quantized(tq, ts, d, method=method, trim=trim,
                                          quantize_out=True)
    qj, sj, _ = jops.quantize(jnp.asarray(want))
    assert dt == d and qt.shape == (q.shape[1],)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert diff.max() <= (0 if exact else 1)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                               rtol=0 if exact else 1e-6)
