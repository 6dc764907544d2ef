"""FEMNIST-like writers, made on the device from the run's seed.

A vectorized copy of the distribution of the port's ``make_femnist_like``
(itself the reference package's): 62 classes whose prototypes are smooth
28 x 28 fields (a 4 x 4 cosine basis, normal coefficients, each scaled to
a largest |value| of 1); a writer has a smooth style field (coefficients
of scale 0.25) and a Dirichlet(alpha) mix of the 62 classes; an image is
its class's prototype rolled by a shift in [-2, 2]^2, plus the style,
plus normal pixel noise.  The draws differ from that maker's (one device
generator, in bulk), the distribution does not.

Writers' sizes are the lognormal's quantiles (median ``mean_samples``,
sigma ``sigma``, floored, at least ``min_samples``) in an order drawn from
the seed, so every seed holds the same number of images.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

IMG = 28
SHIFT = 2                    # rolls of -2..2 pixels on each axis
CHUNK = 1 << 17              # images made (and copied to the host) a call


@dataclass
class Community:
    client_images: List[np.ndarray]      # (n_i, 28, 28, 1) float32
    client_labels: List[np.ndarray]      # (n_i,) int32
    test_images: np.ndarray
    test_labels: np.ndarray


def client_sizes(num_clients: int, mean_samples: float, sigma: float,
                 min_samples: int, seed: int) -> np.ndarray:
    q = (torch.arange(num_clients, dtype=torch.float64) + 0.5) / num_clients
    sizes = torch.exp(math.log(mean_samples) + sigma * torch.special.ndtri(q))
    sizes = sizes.floor().clamp(min=min_samples).to(torch.int64).numpy()
    return sizes[np.random.default_rng(seed).permutation(num_clients)]


def smooth_fields(g: torch.Generator, n: int, scale: float, device,
                  k: int = 4) -> torch.Tensor:
    """n random low-frequency (28, 28) fields from k x k coefficients."""
    coeff = torch.randn((n, k, k), generator=g, device=device) * scale
    yy = torch.linspace(0, math.pi, IMG, device=device)
    basis = torch.stack([torch.cos(yy * i) for i in range(k)])     # (k, 28)
    return basis.T @ coeff @ basis


def dirichlet(g: torch.Generator, rows: int, classes: int, alpha: float,
              device) -> torch.Tensor:
    """Dirichlet(alpha) rows for alpha a multiple of 1/2: Gamma(m / 2) is
    half a chi-square of m degrees, a sum of m squared normals."""
    m = round(2 * alpha)
    if m < 1 or abs(m - 2 * alpha) > 1e-12:
        raise ValueError(f"alpha {alpha}: want a positive multiple of 1/2")
    z = torch.randn((m, rows, classes), generator=g, device=device)
    gam = z.square().sum(0)
    return gam / gam.sum(1, keepdim=True)


def make_community(cfg: dict, seed: int, device) -> Community:
    """``cfg``: num_clients, mean_samples, sigma, min_samples, classes,
    alpha, noise, test_size."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    n, classes = cfg["num_clients"], cfg["classes"]
    sizes = client_sizes(n, cfg["mean_samples"], cfg["sigma"],
                         cfg["min_samples"], seed)
    protos = smooth_fields(g, classes, 1.0, device)
    protos = protos / protos.abs().amax(dim=(1, 2), keepdim=True)
    shifted = torch.stack([torch.roll(protos, (dy, dx), dims=(1, 2))
                           for dy in range(-SHIFT, SHIFT + 1)
                           for dx in range(-SHIFT, SHIFT + 1)], dim=1)
    styles = smooth_fields(g, n, 0.25, device)
    probs = dirichlet(g, n, classes, cfg["alpha"], device)
    draws = torch.multinomial(probs, int(sizes.max()), replacement=True,
                              generator=g)
    sizes_t = torch.as_tensor(sizes, device=device)
    keep = torch.arange(draws.shape[1], device=device)[None] < sizes_t[:, None]
    labels = draws[keep]                                        # writer-major
    owner = torch.repeat_interleave(torch.arange(n, device=device), sizes_t)
    total = int(sizes.sum())
    images = np.empty((total, IMG, IMG, 1), np.float32)
    host = torch.from_numpy(images).view(total, IMG, IMG)
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        shift = torch.randint(0, (2 * SHIFT + 1) ** 2, (hi - lo,),
                              generator=g, device=device)
        x = shifted[labels[lo:hi], shift] + styles[owner[lo:hi]]
        x += torch.randn(x.shape, generator=g, device=device) * cfg["noise"]
        host[lo:hi].copy_(x)
    labels_np = labels.to(torch.int32).cpu().numpy()
    # the central test set: IID classes, no style
    t_lab = torch.randint(0, classes, (cfg["test_size"],), generator=g,
                          device=device)
    t_shift = torch.randint(0, (2 * SHIFT + 1) ** 2, (cfg["test_size"],),
                            generator=g, device=device)
    t_img = shifted[t_lab, t_shift]
    t_img = t_img + torch.randn(t_img.shape, generator=g, device=device) \
        * cfg["noise"]
    cuts = np.cumsum(sizes)[:-1]
    return Community(
        client_images=np.split(images, cuts),
        client_labels=np.split(labels_np, cuts),
        test_images=t_img[..., None].cpu().numpy(),
        test_labels=t_lab.to(torch.int32).cpu().numpy(),
    )
