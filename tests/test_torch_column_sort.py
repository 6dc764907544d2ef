"""The sorts' plain versions on columns that stress a merge of sorted runs,
against the reference.

Above K = 32 the card's kernels sort a lane's column as runs of 32 merged
by their heads (33 <= K <= 128) or by insertion (K > 128); each is held on
the card to the plain versions this file holds to the reference:
``fused_agg_ref`` (the fused int8 aggregation, with and without
quantize_out), ``cwmed_ref`` and ``trimmed_mean_ref`` (the f32 kernels).
``tests/test_torch_fused_agg_any_k.py`` covers K = 33, 64, 65 and 90 on
normal columns; here K = 44 and 51 (the tiered path's slices), 96, 127,
128 and 129 (either side of the run merge's largest K) and 200, each on
columns that are ascending, descending, all equal, long runs of one
value, ties of +0.0 and -0.0 among normals, or normals with one huge
outlier.

The reference value is its own reductions (``median_of_sorted``,
``trimmed_mean_of_sorted``) jitted over ``jnp.sort`` of the stack (of its
dequantized stack on the int8 path, quantized by its own
``quantize_stack``), in place of its odd-even network, whose unrolled
program at such K takes minutes to compile in interpret mode; order
statistics do not depend on the sorting method.  With quantize_out it
requantizes that value with its own ``quantize``.

Tolerances, as ``tests/test_torch_fused_agg_any_k.py``: the median exact,
by value (a sort may put either zero of a +0.0 / -0.0 tie first); the
trimmed mean to rtol 1e-6 with atol 1e-6 * max|x|; with quantize_out, q
within +-1 and the scales to rtol 1e-6 for the trimmed mean, both exact for
the median.
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
from repro_torch.kernels.cwmed import cwmed_ref, trimmed_mean_ref
from repro_torch.kernels.fused_agg import fused_agg_ref

torch.set_num_threads(2)

KS = (44, 51, 96, 127, 128, 129, 200)
D = 4096          # two tiles
COLUMNS = ("ascending", "descending", "equal", "duplicate_runs",
           "signed_zeros", "outlier")
# (method, trim): the trim of a trimmed mean is 1 or (K - 1) // 2
FORMS = (("cwmed", "none"), ("trimmed_mean", "one"), ("trimmed_mean", "half"))
PATHS = ("f32", "int8", "int8_qout")


def make_columns(K: int, kind: str, seed: int) -> np.ndarray:
    """(K, D) f32 whose every column is of one kind."""
    rng = np.random.default_rng(seed)
    lane_scale = rng.uniform(0.5, 2.0, D) * 1e-3
    rows = np.arange(K, dtype=np.float64)[:, None]
    if kind in ("ascending", "descending"):
        x = (rows - K / 2) * lane_scale + rng.standard_normal(D) * 1e-3
        if kind == "descending":
            x = x[::-1]
    elif kind == "equal":
        x = np.broadcast_to(rng.standard_normal(D) * 1e-3, (K, D))
    elif kind == "duplicate_runs":
        # three values a lane, each held by a long run of rows, shuffled
        levels = rng.standard_normal((3, D)) * 1e-3
        pick = np.sort(rng.integers(0, 3, (K, D)), axis=0)
        x = np.take_along_axis(levels, pick, axis=0)
        x = rng.permuted(x, axis=0)
    elif kind == "signed_zeros":
        x = rng.standard_normal((K, D)) * 1e-3
        x[rng.random((K, D)) < 0.4] = 0.0
        x = np.where(rng.random((K, D)) < 0.5, -1.0, 1.0) * x
        x[:, :D // 4] = 0.0                       # whole lanes of zeros,
        x[K // 2:, :D // 4] = -0.0                # half of them -0.0
    else:  # outlier: one row a lane 1000 times the rest, of either sign
        x = rng.standard_normal((K, D)) * 1e-3
        at = rng.integers(0, K, D)
        x[at, np.arange(D)] = np.where(rng.random(D) < 0.5, -1.0, 1.0)
    return np.ascontiguousarray(x, dtype=np.float32)


def _trim(K: int, which: str) -> int:
    return {"none": 0, "one": 1, "half": (K - 1) // 2}[which]


@functools.lru_cache(maxsize=None)
def _reduce_fn(K: int, method: str, trim: int):
    if method == "cwmed":
        return jax.jit(lambda x: median_of_sorted(list(jnp.sort(x, axis=0))))
    return jax.jit(lambda x: trimmed_mean_of_sorted(list(jnp.sort(x, axis=0)),
                                                    trim))


@functools.lru_cache(maxsize=None)
def _quantized(K: int, kind: str):
    x = make_columns(K, kind, seed=K * 7 + COLUMNS.index(kind))
    q, s, d = jops.quantize_stack(jnp.asarray(x))
    assert d == D
    return x, np.array(q), np.array(s), dequantize_stack_ref(q, s)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
@pytest.mark.parametrize("kind", COLUMNS)
@pytest.mark.parametrize("K", KS)
def test_column_sorts_match_the_reference(K, kind, form, path):
    method, which = form
    trim = _trim(K, which)
    exact = method == "cwmed"
    x, q, s, deq = _quantized(K, kind)
    reduce = _reduce_fn(K, method, trim)
    if path == "f32":
        want = np.asarray(reduce(jnp.asarray(x)))
        t = torch.from_numpy(x)
        got = (cwmed_ref(t) if exact else trimmed_mean_ref(t, trim)).numpy()
    else:
        want = np.asarray(reduce(deq))
        got = fused_agg_ref(torch.from_numpy(q), torch.from_numpy(s),
                            torch.full((K,), 1.0 / K), method, trim,
                            quantize_out=path == "int8_qout")
    if path != "int8_qout":
        assert got.shape == (D,)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        return
    qt, st = got
    qj, sj, _ = jops.quantize(jnp.asarray(want))
    assert qt.shape == (D,)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert diff.max() <= (0 if exact else 1)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj),
                               rtol=0 if exact else 1e-6)


@pytest.mark.parametrize("code,size,name", [
    (0, 0, "fedavg"), (1, 16, "register network W=16"),
    (2, 3, "run merge R=3"), (3, 0, "insertion sort in shared memory")])
def test_design_names_and_their_counts(code, size, name):
    """The C entries' design codes read as text, and a CPU call (the plain
    version) counts no launch of any design."""
    from repro_torch.kernels import design_counts, reset_launch_counts
    from repro_torch.kernels.cwmed import cwmed_kernel, design_name

    assert design_name(code, size) == name
    reset_launch_counts()
    cwmed_kernel(torch.zeros((3, 5)))
    assert design_counts() == {"fused_agg": {}, "cwmed": {}, "trimmed_mean": {}}
    assert cwmed_kernel.launches == 0
