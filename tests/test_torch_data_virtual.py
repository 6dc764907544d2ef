"""The port's ``data/virtual.py`` and ``data/partition.py`` against the
reference's.

Virtual clients alias their base shards (no copies), with negative
indices and an ``IndexError`` past the end, as
``tests/test_hier_round.py`` holds the reference's.  The partitioners are
numpy-only copies: the same labels and seed give the same index arrays.
"""
import numpy as np
import pytest

from repro.data import VirtualFederatedDataset as JaxVirtualFederatedDataset
from repro.data import dirichlet_partition as ref_dirichlet
from repro.data import leaf_style_partition as ref_leaf
from repro.data import make_femnist_like as jax_make_femnist_like
from repro_torch import data as port_data
from repro_torch.data import (
    FederatedDataset,
    VirtualFederatedDataset,
    dirichlet_partition,
    leaf_style_partition,
    make_femnist_like,
)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)


@pytest.fixture(scope="module")
def ds():
    return make_femnist_like(**DATA)


def test_exports_match_reference():
    """The reference's names, plus ``MarkovLM``, which the reference keeps
    in ``repro.data.lm_synthetic`` and the port also exports here."""
    import repro.data

    assert sorted(port_data.__all__) == sorted(repro.data.__all__
                                               + ["MarkovLM"])


def test_virtual_dataset_aliases_base(ds):
    vds = VirtualFederatedDataset(ds, 60)
    assert isinstance(vds, FederatedDataset)
    assert vds.num_clients == 60
    assert len(vds.client_sizes()) == 60
    assert vds.client_images[37] is ds.client_images[37 % 24]
    assert vds.client_labels[59] is ds.client_labels[59 % 24]
    assert vds.client_images[-1] is ds.client_images[59 % 24]
    assert vds.client_labels[-60] is ds.client_labels[0]
    with pytest.raises(IndexError):
        vds.client_images[60]
    with pytest.raises(IndexError):
        vds.client_labels[-61]
    assert [x is ds.client_images[i % 24]
            for i, x in enumerate(vds.client_images)] == [True] * 60
    np.testing.assert_array_equal(vds.test_images, ds.test_images)
    a, b = vds.merged_train()[0], ds.merged_train()[0]
    assert a.shape == b.shape


@pytest.mark.parametrize("n", (1, 24, 60, 1000))
def test_virtual_sizes_equal_reference(ds, n):
    ref = JaxVirtualFederatedDataset(jax_make_femnist_like(**DATA), n)
    vds = VirtualFederatedDataset(ds, n)
    np.testing.assert_array_equal(vds.client_sizes(), ref.client_sizes())
    for i in (0, n // 2, n - 1, -1):
        np.testing.assert_array_equal(vds.client_labels[i], ref.client_labels[i])


@pytest.mark.parametrize("n", (0, -3))
def test_virtual_rejects_empty(ds, n):
    with pytest.raises(ValueError):
        VirtualFederatedDataset(ds, n)


def _labels(seed, n=600, classes=10):
    return np.random.default_rng(seed).integers(0, classes, n)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("alpha", (0.1, 0.5, 10.0))
def test_dirichlet_partition_equals_reference(seed, alpha):
    labels = _labels(seed)
    got = dirichlet_partition(labels, 12, alpha, seed=seed)
    want = ref_dirichlet(labels, 12, alpha, seed=seed)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert min(len(g) for g in got) >= 2


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cpc", (1, 2, 5))
def test_leaf_style_partition_equals_reference(seed, cpc):
    labels = _labels(seed)
    got = leaf_style_partition(labels, 15, cpc, seed=seed)
    want = ref_leaf(labels, 15, cpc, seed=seed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert len(np.unique(labels[g])) <= cpc
