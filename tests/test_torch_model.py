"""The port's FEMNIST CNN and client programs against the reference.

Same weights (the reference's init, converted through numpy) and the same
numpy batches go to both packages at width 8, batch 16.  Tolerances: the
convolutions sum in another order (the reference lowers conv1 to im2col +
GEMM), so logits match to rtol=atol=1e-5 and a 3-step momentum-SGD update
to atol=1e-5; the score matrix takes argmaxes of those logits, and at these
inputs no logit is near a tie, so it is equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import femnist_cnn as jcnn
from repro.fl.adapter import femnist_adapter as jax_femnist_adapter
from repro.fl.client import make_local_train_fn as jax_local_train
from repro.fl.client import make_score_matrix_fn as jax_score_matrix
from repro_torch.configs import femnist_cnn as tcnn
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.client import make_local_train_fn, make_score_matrix_fn

torch.set_num_threads(2)
WIDTH, BATCH = 8, 16


@pytest.fixture(scope="module")
def init_np():
    return jax.tree.map(np.asarray,
                        jax_femnist_adapter(WIDTH).init(jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def trained_np(init_np):
    """Init with a nonzero output layer, so logits are informative."""
    rng = np.random.default_rng(5)
    p = {k: dict(v) for k, v in init_np.items()}
    p["fc2"]["w"] = (rng.standard_normal((128, 62)) * 0.05).astype(np.float32)
    p["fc2"]["b"] = (rng.standard_normal(62) * 0.05).astype(np.float32)
    return p


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 62, n).astype(np.int32)
    return x, y


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_apply_loss_accuracy_match_reference(trained_np):
    x, y = _batch(0)
    tp = from_numpy_tree(trained_np)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(tcnn.apply(tp, tx).numpy(),
                               np.asarray(jcnn.apply(_jax(trained_np), x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tcnn.loss_fn(tp, tx, ty)),
                               float(jcnn.loss_fn(_jax(trained_np), x, y)),
                               rtol=1e-5)
    assert float(tcnn.accuracy(tp, tx, ty)) == float(
        jcnn.accuracy(_jax(trained_np), x, y))


def test_argmax_ties_pick_the_same_index(init_np):
    # zero-init fc2: every logit is exactly 0, so both argmaxes tie-break
    x, _ = _batch(1)
    logits = tcnn.apply(from_numpy_tree(init_np), torch.from_numpy(x))
    assert not logits.any()
    tpred = logits.argmax(dim=-1).numpy()
    jpred = np.asarray(jcnn.apply(_jax(init_np), x).argmax(axis=-1))
    np.testing.assert_array_equal(tpred, jpred)
    assert (tpred == 0).all()


def test_momentum_sgd_client_update_matches_reference(trained_np):
    rng = np.random.default_rng(2)
    P, steps = 3, 3
    xs = rng.standard_normal((P, steps, 8, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 62, (P, steps, 8)).astype(np.int32)
    want = jax.tree.map(np.asarray, jax_local_train(
        jax_femnist_adapter(WIDTH), 0.02, 0.9)(_jax(trained_np), xs, ys))
    got = to_numpy_tree(make_local_train_fn(femnist_adapter(WIDTH), 0.02, 0.9)(
        from_numpy_tree(trained_np), torch.from_numpy(xs), torch.from_numpy(ys)))
    for k in want:
        for kk in want[k]:
            assert got[k][kk].shape == (P,) + trained_np[k][kk].shape
            np.testing.assert_allclose(got[k][kk], want[k][kk], atol=1e-5)


def test_score_matrix_equal(trained_np):
    rng = np.random.default_rng(3)
    P, Q = 4, 3
    upd = jax.tree.map(
        lambda a: (rng.standard_normal((P,) + a.shape) * 0.02).astype(np.float32),
        trained_np)
    vx = rng.standard_normal((Q, BATCH, 28, 28, 1)).astype(np.float32)
    vy = rng.integers(0, 62, (Q, BATCH)).astype(np.int32)
    want = np.asarray(jax_score_matrix(jax_femnist_adapter(WIDTH))(
        _jax(trained_np), _jax(upd), vx, vy))
    got = make_score_matrix_fn(femnist_adapter(WIDTH))(
        from_numpy_tree(trained_np), from_numpy_tree(upd),
        torch.from_numpy(vx), torch.from_numpy(vy)).numpy()
    assert got.shape == (P, Q)
    np.testing.assert_array_equal(got, want)
