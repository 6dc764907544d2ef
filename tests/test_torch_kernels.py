"""The port's kernel layer against the reference's Pallas kernels.

Both packages get the same numpy inputs.  The reference runs its Pallas
kernels through ``repro.kernels.ops`` (interpret mode on the CPU, as its
own tests run them); the port runs the plain PyTorch versions its wrappers
take for CPU tensors — the versions the CUDA kernels are held against on
the card.

Tolerances: quantize and dequantize are bit-exact (same IEEE division,
round half to even).  The fused aggregation is bit-exact for cwmed (order
statistics); fedavg and trimmed_mean sum in another order, so they match to
rtol 1e-6 with atol 1e-6 * max|x|; with quantize_out that order difference
can move a value across a rounding boundary, so q is held within +-1 and
the output scales to rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels.fused_agg import fused_agg_kernel, fused_agg_ref
from repro_torch.kernels.quantize import dequantize_kernel, quantize_stack_kernel

torch.set_num_threads(2)

KS = (1, 3, 8, 17)
DS = (2048, 5000, 6145)
METHODS = ("fedavg", "cwmed", "trimmed_mean")


def make_stack(K: int, D: int, seed: int) -> np.ndarray:
    """Update-sized normals; row 0 of exact half steps whose tiles all have
    amax 127 (scale exactly 1.0, so round-half-to-even decides q); one
    all-zero tile in every row where D allows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((K, D)) * 1e-3).astype(np.float32)
    half = (np.arange(D) % 251 - 125.5).astype(np.float32)
    half[::2048] = 127.0
    x[0] = half
    if D > 4096:
        x[:, 2048:4096] = 0.0
    return x


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("D", DS)
def test_quantize_stack_bit_exact(K, D):
    x = make_stack(K, D, seed=K * 31 + D)
    qj, sj, dj = jops.quantize_stack(jnp.asarray(x))
    qt, st, dt = tops.quantize_stack(torch.from_numpy(x))
    assert dj == dt == D
    np.testing.assert_array_equal(_np(qt), _np(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))


@pytest.mark.parametrize("D", DS + (1, 100))
@pytest.mark.parametrize("row", (0, 1))
def test_quantize_dequantize_bit_exact(D, row):
    x = make_stack(2, D, seed=D)[row]
    qj, sj, dj = jops.quantize(jnp.asarray(x))
    qt, st, dt = tops.quantize(torch.from_numpy(x))
    assert dj == dt == D
    np.testing.assert_array_equal(_np(qt), _np(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))
    np.testing.assert_array_equal(
        _np(tops.dequantize(qt, st, dt)), _np(jops.dequantize(qj, sj, dj))
    )


def test_zero_and_half_step_tiles_quantize_as_the_reference():
    x = make_stack(1, 6145, seed=0)[0]
    q, s, _ = tops.quantize(torch.from_numpy(x))
    assert float(s[1]) == 1.0 and not q[2048:4096].any()    # all-zero tile
    assert float(s[0]) == 1.0
    # half steps round to even: -124.5 -> -124, -123.5 -> -124, -122.5 -> -122
    assert q[0] == 127 and q[1] == -124 and q[2] == -124 and q[3] == -122


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("method", METHODS)
def test_aggregate_quantized_matches_reference(K, D, method):
    x = make_stack(K, D, seed=K + 7 * D)
    q, s, d = jops.quantize_stack(jnp.asarray(x))
    q, s = np.asarray(q), np.asarray(s)
    w = np.random.default_rng(K).random(K).astype(np.float32)
    trim = (K - 1) // 2
    kw = dict(method=method, trim=trim)
    tq, ts, tw = torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(w)

    want = np.asarray(jops.aggregate_quantized(
        jnp.asarray(q), jnp.asarray(s), d, weights=jnp.asarray(w), **kw))
    got = _np(tops.aggregate_quantized(tq, ts, d, weights=tw, **kw))
    assert got.shape == (D,)
    if method == "cwmed":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())

    qj, sj, dj = jops.aggregate_quantized(
        jnp.asarray(q), jnp.asarray(s), d, weights=jnp.asarray(w),
        quantize_out=True, **kw)
    qt, st, dt = tops.aggregate_quantized(tq, ts, d, weights=tw,
                                          quantize_out=True, **kw)
    assert dj == dt == d
    diff = np.abs(_np(qt).astype(np.int32) - np.asarray(qj).astype(np.int32))
    assert diff.max() <= (0 if method == "cwmed" else 1)
    np.testing.assert_allclose(_np(st), np.asarray(sj),
                               rtol=0 if method == "cwmed" else 1e-6)


def test_wrappers_refuse_bad_input():
    with pytest.raises(ValueError):
        quantize_stack_kernel(torch.zeros((2, 100)))          # not tile-aligned
    with pytest.raises(TypeError):
        dequantize_kernel(torch.zeros(2048), torch.ones(1))   # not int8
    q = torch.zeros((3, 2048), dtype=torch.int8)
    s = torch.ones((3, 1))
    with pytest.raises(ValueError):
        fused_agg_kernel(q, s, torch.ones(3) / 3, method="trimmed_mean", trim=2)
    # no K cap on the sort methods (the reference has none): K = 65 cwmed
    # is a median, not an error
    q65 = torch.from_numpy(np.random.default_rng(65).integers(
        -127, 128, (65, 2048), dtype=np.int8))
    s65, w65 = torch.full((65, 1), 0.5), torch.ones(65) / 65
    got = fused_agg_kernel(q65, s65, w65, method="cwmed")
    assert torch.equal(got, fused_agg_ref(q65, s65, w65, method="cwmed"))
    np.testing.assert_array_equal(
        got.numpy(), np.median(q65.numpy().astype(np.float32) * 0.5, axis=0))


def test_non_cpu_tensor_launches_or_raises_never_falls_back():
    # a tensor that is neither on the CPU nor on CUDA has no plain-version
    # route and no kernel: the wrapper raises instead of computing anything
    x = torch.zeros((1, 2048), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        quantize_stack_kernel(x)
