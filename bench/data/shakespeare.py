"""LEAF Shakespeare's population as token windows, made from the run's seed.

LEAF (Caldas et al., arXiv:1812.01097, Table 1) has 1,129 speaking roles
with 4,226,158 samples, 3,743.2 +- 6,212.26 a role; a sample is one
80-character window of a role's lines at a stride of 1, so a role of n
samples holds about n characters.  Here a role's character count is the
lognormal of that mean and spread (median about 1,932, sigma about
1.150): its quantiles, floored, in an order drawn from the seed (as the
FEMNIST maker orders its writers).  A role's text is ``chars //
chars_per_token`` tokens (at least ``seq + 1``) of a seeded Markov chain
over the tokenizer's first ``text_ids`` ids (the transition table of
``MarkovLM``: each id has ``branching`` successors of Zipf-like
weights), each role under a dialect of its own (a permutation of those
weights).  Its rows are its
windows of ``seq + 1`` tokens at a stride of 1: the first ``seq`` tokens
and the last ``seq`` as targets.  The windows are views of the role's
text, so the host holds the text once; the round's community copies the
rows to the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from bench.data.femnist import client_sizes


@dataclass
class Community:
    client_images: List[np.ndarray]      # (n_i, seq) int32 token windows
    client_labels: List[np.ndarray]      # (n_i, seq) int32 next tokens
    test_images: np.ndarray
    test_labels: np.ndarray

    @property
    def rows(self) -> int:
        return sum(len(y) for y in self.client_labels)


def lognormal_of(mean: float, sd: float):
    """(median, sigma) of the lognormal with this mean and spread."""
    s2 = math.log(1.0 + (sd / mean) ** 2)
    return math.exp(math.log(mean) - s2 / 2.0), math.sqrt(s2)


def role_tokens(cfg: dict, seed: int) -> np.ndarray:
    """Each role's text length in tokens, in the seed's order."""
    median, sigma = lognormal_of(cfg["mean_chars"], cfg["sd_chars"])
    chars = client_sizes(cfg["num_clients"], median, sigma, 1, seed)
    return np.maximum(chars // cfg["chars_per_token"], cfg["seq"] + 1)


def markov_texts(rng: np.random.Generator, lengths: np.ndarray, vocab: int,
                 branching: int, table_seed: int):
    """One text a role, all roles drawn step by step together: a uniform
    first id, then each next id the current id's successor chosen by the
    role's dialect of the chain's weights.  Returns the texts (views of
    one (roles, longest) array) and the dialects."""
    succ = np.random.default_rng(table_seed).integers(
        0, vocab, (vocab, branching))
    w = 1.0 / np.arange(1, branching + 1)
    probs = w / w.sum()
    roles = len(lengths)
    dialects = np.stack([rng.permutation(branching) for _ in range(roles)])
    cum = np.cumsum(probs[dialects], axis=1)
    cum[:, -1] = 1.0
    out = np.empty((roles, int(lengths.max())), np.int32)
    cur = rng.integers(0, vocab, roles)
    for t in range(out.shape[1]):
        out[:, t] = cur
        choice = (rng.random(roles)[:, None] >= cum).sum(axis=1)
        cur = succ[cur, np.minimum(choice, branching - 1)]
    return [out[r, :n] for r, n in enumerate(lengths)], dialects


def windows(text: np.ndarray, seq: int):
    """(tokens, targets): the text's windows of seq + 1 at a stride of 1."""
    w = np.lib.stride_tricks.sliding_window_view(text, seq + 1)
    return w[:, :-1], w[:, 1:]


def make_community(cfg: dict, seed: int) -> Community:
    rng = np.random.default_rng([seed % (1 << 64), 1])
    lengths = role_tokens(cfg, seed)
    test_len = cfg["test_rows"] + cfg["seq"]
    texts, _ = markov_texts(rng, np.append(lengths, test_len),
                            cfg["text_ids"], cfg["branching"],
                            seed % (1 << 63))
    images, labels = zip(*(windows(t, cfg["seq"]) for t in texts[:-1]))
    test_x, test_y = windows(texts[-1], cfg["seq"])
    return Community(list(images), list(labels), test_x, test_y)
