"""Synthetic FEMNIST-like federated dataset.

A numpy-only copy of ``repro/data/synthetic.py``: the same seed gives
bit-equal arrays in both packages, so the port and the reference train on
the same community.

The real FEMNIST bytes are unavailable offline; this generator reproduces the
*statistical shape* the paper's experiments rely on:

* 62 classes of 28x28 "handwritten-character-like" images: each class has a
  smooth low-frequency prototype; samples jitter it with per-writer style
  (a writer-specific smooth field), random shifts and pixel noise.
* 900 writers with unbalanced sample counts (log-normal) and non-IID class
  distributions.  IMPORTANT (paper fidelity): FEMNIST writers write ALL 62
  characters — the non-IID-ness is per-writer style + Dirichlet quantity
  skew, NOT restricted label support.  ``classes_per_client=62`` (default)
  matches that; small values create a much harsher label-partition regime
  (useful for stress tests, but it breaks the paper's BFLC ≈ FedAvg parity:
  committee validation on label-restricted shards locks in a class clique).

The classification task is genuinely learnable (protos are separable) but
non-trivial (style + noise), so FL aggregation quality differences — exactly
what Table I / Fig 4 measure — show up in accuracy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

NUM_CLASSES = 62
IMG = 28


@dataclass
class FederatedDataset:
    """Per-writer federated shards plus a held-out central test set."""

    client_images: List[np.ndarray]   # each (n_i, 28, 28, 1) float32
    client_labels: List[np.ndarray]   # each (n_i,) int32
    test_images: np.ndarray
    test_labels: np.ndarray

    @property
    def num_clients(self) -> int:
        return len(self.client_images)

    def client_sizes(self) -> np.ndarray:
        return np.array([len(x) for x in self.client_labels])

    def merged_train(self) -> Tuple[np.ndarray, np.ndarray]:
        """The stand-alone (centralized) training view of the same data."""
        return (
            np.concatenate(self.client_images, axis=0),
            np.concatenate(self.client_labels, axis=0),
        )


def _smooth_field(rng: np.random.Generator, scale: float, k: int = 4):
    """Random low-frequency 28x28 field from a kxk coefficient grid."""
    coeff = rng.normal(0, scale, (k, k))
    yy = np.linspace(0, np.pi, IMG)
    basis = np.stack([np.cos(yy * i) for i in range(k)])       # (k, 28)
    return basis.T @ coeff @ basis                              # (28, 28)


def make_femnist_like(
    *,
    num_clients: int = 900,
    mean_samples: int = 90,
    alpha: float = 0.5,
    classes_per_client: int = 62,
    test_size: int = 4000,
    noise: float = 0.35,
    seed: int = 0,
) -> FederatedDataset:
    rng = np.random.default_rng(seed)
    protos = np.stack([_smooth_field(rng, 1.0) for _ in range(NUM_CLASSES)])
    protos = protos / np.abs(protos).max(axis=(1, 2), keepdims=True)

    def sample(cls: int, n: int, style: np.ndarray) -> np.ndarray:
        base = protos[cls][None].repeat(n, 0)
        shifts = rng.integers(-2, 3, size=(n, 2))
        out = np.empty_like(base)
        for i in range(n):
            out[i] = np.roll(base[i], tuple(shifts[i]), axis=(0, 1))
        out = out + style[None] + rng.normal(0, noise, out.shape)
        return out.astype(np.float32)

    client_images, client_labels = [], []
    sizes = np.maximum(
        8, rng.lognormal(np.log(mean_samples), 0.5, num_clients).astype(int)
    )
    for ci in range(num_clients):
        style = _smooth_field(rng, 0.25)
        cls_pool = rng.choice(NUM_CLASSES, classes_per_client, replace=False)
        probs = rng.dirichlet(np.full(classes_per_client, alpha))
        labels = rng.choice(cls_pool, size=sizes[ci], p=probs)
        imgs = np.empty((sizes[ci], IMG, IMG), np.float32)
        for cls in np.unique(labels):
            idx = np.where(labels == cls)[0]
            imgs[idx] = sample(int(cls), len(idx), style)
        client_images.append(imgs[..., None])
        client_labels.append(labels.astype(np.int32))

    # IID test set, style-free (central evaluation view)
    test_labels = rng.integers(0, NUM_CLASSES, test_size).astype(np.int32)
    test_images = np.empty((test_size, IMG, IMG), np.float32)
    for cls in np.unique(test_labels):
        idx = np.where(test_labels == cls)[0]
        test_images[idx] = sample(int(cls), len(idx), np.zeros((IMG, IMG)))
    return FederatedDataset(
        client_images, client_labels, test_images[..., None], test_labels
    )


def batch_iterator(rng: np.random.Generator, images, labels, batch: int):
    n = len(labels)
    while True:
        idx = rng.integers(0, n, batch)
        yield images[idx], labels[idx]
