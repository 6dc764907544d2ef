"""The data makers: the same seed gives the same community; LEAF's
population."""
import numpy as np
import pytest

from bench import harness
from bench.data import femnist

LEAF = dict(writers=3550, samples=805_263, mean=226.83)


def test_leaf_population():
    cfg = harness.cell_spec("cnn_leaf_int8").config
    sizes = femnist.client_sizes(cfg["num_clients"], cfg["mean_samples"],
                                 cfg["sigma"], cfg["min_samples"], seed=5)
    assert len(sizes) == LEAF["writers"]
    assert sizes.mean() == pytest.approx(LEAF["mean"], rel=5e-3)
    assert sizes.sum() == pytest.approx(LEAF["samples"], rel=5e-3)
    assert sizes.min() >= cfg["min_samples"]


def test_every_seed_the_same_sizes_in_another_order():
    a = femnist.client_sizes(3550, 200.2, 0.5, 8, seed=1)
    b = femnist.client_sizes(3550, 200.2, 0.5, 8, seed=2**31 + 7)
    assert not np.array_equal(a, b)
    assert np.array_equal(np.sort(a), np.sort(b))


def small_femnist():
    cfg = dict(harness.cell_spec("cnn_leaf_int8").config)
    cfg.update(num_clients=30, mean_samples=12, test_size=20)
    return cfg


@pytest.mark.parametrize("seed", [0, 4_000_000_123])
def test_femnist_repeats_by_seed(seed):
    cfg = small_femnist()
    a = femnist.make_community(cfg, seed, "cpu")
    b = femnist.make_community(cfg, seed, "cpu")
    c = femnist.make_community(cfg, seed + 1, "cpu")
    assert len(a.client_images) == 30
    for x, y in zip(a.client_images + a.client_labels,
                    b.client_images + b.client_labels):
        assert np.array_equal(x, y)
    assert not np.array_equal(np.concatenate(a.client_labels),
                              np.concatenate(c.client_labels))
    for img, lab in zip(a.client_images, a.client_labels):
        assert img.shape[1:] == (28, 28, 1) and img.dtype == np.float32
        assert lab.dtype == np.int32 and len(lab) == len(img)
        assert lab.min() >= 0 and lab.max() < 62
    assert a.test_images.shape == (20, 28, 28, 1)


def test_femnist_classes_are_learnable_shapes():
    """An image is its class's prototype plus style and noise: images of one
    class and writer lie closer to each other than to another class's."""
    cfg = small_femnist()
    cfg.update(num_clients=4, mean_samples=200, noise=0.1)
    com = femnist.make_community(cfg, 3, "cpu")
    x, y = com.client_images[0][..., 0], com.client_labels[0]
    counts = np.bincount(y, minlength=62)
    a, b = np.argsort(counts)[-2:]
    xa, xb = x[y == a], x[y == b]
    within = np.abs(xa[:, None] - xa[None]).mean()
    across = np.abs(xa[:, None] - xb[None]).mean()
    assert within < across


def test_dirichlet_rows():
    import torch

    g = torch.Generator().manual_seed(0)
    p = femnist.dirichlet(g, 5, 62, 0.5, "cpu")
    assert p.shape == (5, 62) and torch.allclose(p.sum(1), torch.ones(5))
    with pytest.raises(ValueError):
        femnist.dirichlet(g, 5, 62, 0.3, "cpu")
