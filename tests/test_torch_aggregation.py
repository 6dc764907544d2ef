"""The port's ``core/aggregation.py`` against the reference's.

Update trees are width-8 FEMNIST-shaped dicts made with numpy.  The f32
reductions (``use_kernels=False``) differ from the reference only in sum
order, so they match to atol 1e-7 on updates of about 1e-2; the blob path
runs the fused int8 plain version and is bit-equal for cwmed and
trimmed_mean.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.fl.adapter import femnist_adapter as jax_femnist_adapter
from repro.kernels.ops import Int8UpdateCodec as JaxCodec
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core import aggregation as tagg
from repro_torch.kernels.ops import Int8UpdateCodec

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def updates_np():
    shapes = jax.tree.map(np.asarray,
                          jax_femnist_adapter(8).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    return [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2)
                         .astype(np.float32), shapes) for _ in range(4)]


def _assert_trees_close(got, want, atol):
    for k in want:
        for kk in want[k]:
            np.testing.assert_allclose(got[k][kk], np.asarray(want[k][kk]),
                                       rtol=0, atol=atol)


@pytest.mark.parametrize("method", ("fedavg", "cwmed", "trimmed_mean"))
@pytest.mark.parametrize("K", (3, 4))
def test_aggregate_pytrees_f32_matches_reference(updates_np, method, K):
    ups = updates_np[:K]
    w = [0.5, 0.25, 0.125, 0.9][:K]
    want = jagg.aggregate_pytrees([jax.tree.map(jnp.asarray, u) for u in ups],
                                  method=method, weights=w, trim=1)
    got = tagg.aggregate_pytrees([from_numpy_tree(u) for u in ups],
                                 method=method, weights=w, trim=1)
    _assert_trees_close(to_numpy_tree(got), want, atol=1e-7)


@pytest.mark.parametrize("method", ("fedavg", "cwmed", "trimmed_mean"))
def test_aggregate_quantized_blobs_matches_reference(updates_np, method):
    jcodec = JaxCodec(updates_np[0])
    tcodec = Int8UpdateCodec(from_numpy_tree(updates_np[0]))
    jblobs = [jcodec.encode(u) for u in updates_np]
    tblobs = [tcodec.encode(from_numpy_tree(u)) for u in updates_np]
    w = [0.5, 0.25, 0.125, 0.9]
    want = jagg.aggregate_quantized_blobs(jblobs, jcodec.unravel,
                                          method=method, weights=w, trim=1)
    got = to_numpy_tree(tagg.aggregate_quantized_blobs(
        tblobs, tcodec.unravel, method=method, weights=w, trim=1))
    if method == "fedavg":
        _assert_trees_close(got, want, atol=1e-9)
    else:
        _assert_trees_close(got, want, atol=0)


def test_normalize_weights_and_apply_update(updates_np):
    w = np.asarray([3.0, 1.0, 0.0], np.float32)
    np.testing.assert_array_equal(
        tagg.normalize_weights(3, torch.from_numpy(w)).numpy(),
        np.asarray(jagg.normalize_weights(3, jnp.asarray(w))))
    np.testing.assert_array_equal(tagg.normalize_weights(2, None).numpy(),
                                  [0.5, 0.5])
    p, u = updates_np[0], updates_np[1]
    got = to_numpy_tree(tagg.apply_update(from_numpy_tree(p), from_numpy_tree(u)))
    want = jagg.apply_update(jax.tree.map(jnp.asarray, p),
                             jax.tree.map(jnp.asarray, u))
    _assert_trees_close(got, want, atol=0)


def test_trimmed_mean_rejects_bad_trim():
    with pytest.raises(ValueError):
        tagg.trimmed_mean(torch.zeros((4, 8)), trim=2)
