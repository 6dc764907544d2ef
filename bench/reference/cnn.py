"""The FEMNIST CNN in plain PyTorch, and its local training.

Parameters as the chain stores them: HWIO conv kernels, (in, out) dense
weights; images NHWC (N, 28, 28, 1).  Two SAME k x k convolutions, each
with ReLU and a 2x2 max pool, the flatten in (H, W, C) order, a dense
layer with ReLU and the class layer (LEAF's FEMNIST CNN: k = 5, 32 and 64
channels, a dense layer of 2048).  A convolution is an im2col product (the
k * k shifted taps side by side on the channel axis, then one matrix
product), so that ``Precision`` governs it as it does every other
product.  Local training is momentum SGD on each client's mean
cross-entropy, the clients of a chunk at once under ``torch.func.vmap``
(a client's gradient is its own loss's), in the precision's dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from bench.reference.precision import Precision
from bench.reference.tree import paths, tree_map


def conv_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """x (N, H, W, C), w (k, k, C, O) -> (N, H, W, O): stride 1, zero
    padding k // 2."""
    k = w.shape[0]
    N, H, W, C = x.shape
    xp = F.pad(x, (0, 0, k // 2, k // 2, k // 2, k // 2))
    taps = torch.cat([xp[:, dy:dy + H, dx:dx + W, :]
                      for dy in range(k) for dx in range(k)], dim=-1)
    y = prec.operand(taps.reshape(N * H * W, k * k * C)) \
        @ prec.operand(w.reshape(k * k * C, -1)) + b
    return y.reshape(N, H, W, -1)


def pool2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2 max pool of (N, H, W, C), stride 2."""
    N, H, W, C = x.shape
    return x.reshape(N, H // 2, 2, W // 2, 2, C).amax(dim=(2, 4))


def logits(p: dict, images: torch.Tensor, prec: Precision) -> torch.Tensor:
    op = prec.operand
    x = images
    for layer in ("conv1", "conv2"):
        x = pool2(F.relu(conv_same(x, p[layer]["w"], p[layer]["b"], prec)))
    x = x.reshape(x.shape[0], -1)
    x = F.relu(op(x) @ op(p["fc1"]["w"]) + p["fc1"]["b"])
    return op(x) @ op(p["fc2"]["w"]) + p["fc2"]["b"]


def loss(p: dict, images, labels, prec: Precision) -> torch.Tensor:
    return F.cross_entropy(logits(p, images, prec), labels.long())


def train(params: dict, xs: torch.Tensor, ys: torch.Tensor, lr: float,
          momentum: float, prec: Precision, chunk: int = 64) -> dict:
    """Each client's update after ``xs.shape[1]`` momentum SGD steps from
    ``params``, in ``prec.dtype``: xs (P, steps, B, 28, 28, 1), ys (P,
    steps, B).  Returns the update tree stacked over P.  Clients go
    ``chunk`` to a call."""
    step_grad = vmap(grad(lambda p, x, y: loss(p, x, y, prec)))
    params = tree_map(lambda a: a.to(prec.dtype), params)
    parts = []
    for lo in range(0, xs.shape[0], chunk):
        x, y = xs[lo:lo + chunk].to(prec.dtype), ys[lo:lo + chunk]
        n = x.shape[0]
        p = tree_map(lambda a: a[None].expand(n, *a.shape).clone(), params)
        mu = tree_map(torch.zeros_like, p)
        for s in range(x.shape[1]):
            g = step_grad(p, x[:, s], y[:, s])
            mu = tree_map(lambda m, gg: momentum * m + gg, mu, g)
            p = tree_map(lambda a, m: a - lr * m, p, mu)
        parts.append(tree_map(lambda a, b: a - b[None], p, params))
    return tree_map(lambda *xs_: torch.cat(xs_), *parts)


class Reference:
    """The CNN as the round judge calls it."""

    def __init__(self, cfg: dict):
        self.cfg = cfg

    def train(self, params, xs, ys, lr, momentum, prec) -> torch.Tensor:
        """(P, D) flat updates, in ``prec.dtype``."""
        upd = train(params, xs, ys, lr, momentum, prec)
        return torch.cat([leaf.reshape(leaf.shape[0], -1)
                          for _, leaf in paths(upd)], dim=1)

    def logits(self, params, x, prec) -> torch.Tensor:
        return logits(params, x, prec)

    def batch(self, data, ids, draws, device):
        images, labels = data
        xs = np.stack([images[i][d] for i, d in zip(ids, draws)])
        ys = np.stack([labels[i][d] for i, d in zip(ids, draws)])
        return torch.from_numpy(xs).to(device), torch.from_numpy(ys).to(device)
