"""Malicious-node attack models (paper §IV.C, §V.B).

Port of ``repro/core/attacks.py``.  The noise is drawn with numpy from the
runtime's host ``Generator``, leaf by leaf in sorted-key order, exactly as
the reference draws it — so a seeded poison is the same array in both
packages.  Leaves go through host numpy and come back as tensors on the
update's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _like(arr: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(t.device)


def gaussian_perturbation(rng: np.random.Generator, update, sigma: float = 1.0,
                          ref=None):
    """Replace each coordinate with pointwise Gaussian noise, scaled per
    leaf to ``ref``'s magnitude when given (the paper's regime, poisoning
    the aggregate), else to the update's own magnitude."""
    ref_leaves = iter(tree_leaves(ref if ref is not None else update))

    def noise(leaf):
        arr = _host(leaf)
        scale = sigma * (np.abs(_host(next(ref_leaves))).mean() + 1e-8)
        return _like(rng.normal(0.0, scale, arr.shape).astype(arr.dtype), leaf)

    return tree_map(noise, update)


def sign_flip(update, scale: float = 1.0):
    return tree_map(lambda x: -scale * x, update)


def scaled_poison(rng: np.random.Generator, update, target_scale: float = 10.0):
    """Boosted poisoning: huge step in a random direction."""

    def poison(leaf):
        arr = _host(leaf)
        direction = rng.normal(0, 1, arr.shape).astype(arr.dtype)
        return _like(target_scale * np.abs(arr).mean() * direction, leaf)

    return tree_map(poison, update)


@dataclass
class CollusionPolicy:
    """Malicious committee members' scoring behaviour (§V.B): random high
    scores for fellow-malicious updates, low scores for honest ones."""

    high_lo: float = 0.9
    high_hi: float = 1.0

    def score(
        self,
        rng: np.random.Generator,
        member_is_malicious: bool,
        uploader_is_malicious: bool,
        honest_score: float,
    ) -> float:
        if member_is_malicious and uploader_is_malicious:
            return float(rng.uniform(self.high_lo, self.high_hi))
        if member_is_malicious and not uploader_is_malicious:
            return float(rng.uniform(0.0, 0.1))
        return honest_score


ATTACKS = {
    "gaussian": gaussian_perturbation,
    "sign_flip": lambda rng, u, **kw: sign_flip(u, **kw),
    "scaled": scaled_poison,
}
