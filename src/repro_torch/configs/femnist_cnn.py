"""The paper's global model: a compact 3x3 CNN for FEMNIST (62 classes of
28x28 characters).

Port of ``repro/configs/femnist_cnn.py``, functional over the reference's
parameter dict: HWIO conv kernels, (in, out) dense weights and NHWC images
at the public functions; ``apply`` permutes to PyTorch's NCHW / OIHW only
inside.  The flatten before ``fc1`` runs over NHWC (H, W, C) order, as the
reference's reshape does, so the same weights give the same logits.
Convolutions and dense products are ``F.conv2d`` and ``torch.matmul``.

``stacked_loss`` is the local trainer's form: P clients' parameters
stacked on a leading axis, each client's products through
``kernels.client_gemm`` (convolutions as the reference's im2col: nine
shifted taps concatenated on the channel axis, then one product), so a
client's loss and gradients are the same bits whatever P.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.client_gemm import client_linear
from repro_torch.numerics import recip_f32

ARCH_ID = "femnist-cnn"
NUM_CLASSES = 62
IMAGE_SHAPE = (28, 28, 1)       # NHWC: height, width, channels


def init_params(generator: torch.Generator, *, width: int = 32,
                num_classes: int = NUM_CLASSES) -> Dict:
    """He-normal init from an explicit CPU generator (the reference's
    ``jax.random`` stream cannot be reproduced; parity runs pass the
    reference's init in instead)."""

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    def conv_init(shape):
        return normal(shape, math.sqrt(2.0 / (shape[0] * shape[1] * shape[2])))

    w = width
    return {
        "conv1": {"w": conv_init((3, 3, 1, w)), "b": torch.zeros((w,))},
        "conv2": {"w": conv_init((3, 3, w, 2 * w)), "b": torch.zeros((2 * w,))},
        "fc1": {"w": normal((7 * 7 * 2 * w, 128), math.sqrt(2.0 / (7 * 7 * 2 * w))),
                "b": torch.zeros((128,))},
        # zero-init output layer: calibrated logits at init (loss = ln 62)
        "fc2": {"w": torch.zeros((128, num_classes)),
                "b": torch.zeros((num_classes,))},
    }


def _conv(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """SAME 3x3 (odd kernel) stride-1 convolution of an NCHW tensor with an
    HWIO kernel."""
    kh, kw = p["w"].shape[0], p["w"].shape[1]
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"],
                    padding=(kh // 2, kw // 2))


def apply(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images: (B, 28, 28, 1) NHWC -> logits (B, 62)."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(F.relu(_conv(x, params["conv1"])), 2)     # 14x14
    x = F.max_pool2d(F.relu(_conv(x, params["conv2"])), 2)     # 7x7
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def loss_fn(params: Dict, images, labels) -> torch.Tensor:
    logp = F.log_softmax(apply(params, images), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def accuracy(params: Dict, images, labels) -> torch.Tensor:
    """Share of argmax hits, as the reference's compiled ``mean`` computes
    it: hits * f32(1 / batch) (see repro_torch.numerics)."""
    hits = (apply(params, images).argmax(dim=-1) == labels).to(torch.float32)
    return hits.sum(dim=-1) * recip_f32(hits.shape[-1])


def _stacked_conv(x: torch.Tensor, p: Dict, P: int) -> torch.Tensor:
    """SAME 3x3 stride-1 convolution of P clients' NHWC images (P*B, H, W,
    C) with their stacked HWIO kernels (P, kh, kw, C, O): im2col in the
    reference's tap order (dy, dx, c), then one product a client."""
    kh, kw, cin, cout = p["w"].shape[1:]
    N, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    taps = torch.cat([xp[:, dy:dy + H, dx:dx + W, :]
                      for dy in range(kh) for dx in range(kw)], dim=-1)
    y = client_linear(taps.reshape(P, (N // P) * H * W, kh * kw * cin),
                      p["w"].reshape(P, kh * kw * cin, cout), p["b"])
    return y.reshape(N, H, W, cout)


def _pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def stacked_loss(params: Dict, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Sum over P clients of each one's mean cross-entropy.

    params: the parameter dict with every leaf stacked to (P, ...);
    images: (P, B, 28, 28, 1); labels: (P, B).  The gradient of the sum
    with respect to client p's leaves is client p's own gradient."""
    P, B = labels.shape
    x = images.reshape(P * B, *images.shape[2:])
    x = _pool_nhwc(F.relu(_stacked_conv(x, params["conv1"], P)))     # 14x14
    x = _pool_nhwc(F.relu(_stacked_conv(x, params["conv2"], P)))     # 7x7
    x = x.reshape(P, B, -1)
    x = F.relu(client_linear(x, params["fc1"]["w"], params["fc1"]["b"]))
    logits = client_linear(x, params["fc2"]["w"], params["fc2"]["b"])
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(2, labels.long()[..., None])[..., 0]
    return nll.mean(dim=1).sum()
