"""A FEMNIST CNN (two SAME k x k convolutions with 2x2 max pools, a dense
layer, the class layer) on a community of writers.

The configuration gives the widths (``kernel``, ``channels``, ``dense``,
``classes``).  The benchmark makes the writers (``bench.data.femnist``)
and the weights on the device from the seed, and hands both to the port's
``femnist_adapter``, whose model takes its widths from the weights it is
given; ``bench.reference.cnn`` judges it.  The weights start as LEAF's
model does (TensorFlow's layer defaults): Glorot-uniform kernels, zero
biases.
"""
from __future__ import annotations

import math

import torch

from bench import counts
from bench.data.femnist import make_community
from bench.reference.cnn import Reference

REFERENCE = Reference


def community(cfg: dict, seed: int, device):
    return make_community(cfg, seed, device)


def glorot_limit(shape) -> float:
    """sqrt(6 / (fan_in + fan_out)), a conv kernel's fans times its taps."""
    taps = math.prod(shape[:-2])
    return math.sqrt(6.0 / (taps * shape[-2] + taps * shape[-1]))


def weights(cfg: dict, community, generator: torch.Generator, device) -> dict:
    """One uniform draw cut into the kernels, each scaled to its Glorot
    limit; zero biases."""
    shapes = counts.cnn_shapes(*counts.cnn_dims(cfg))
    kernels = {key: shape for key, shape in shapes.items() if key[1] == "w"}
    total = sum(math.prod(s) for s in kernels.values())
    u = torch.rand((total,), generator=generator, device=device) * 2.0 - 1.0
    out, lo = {}, 0
    for (layer, leaf), shape in shapes.items():
        if leaf == "w":
            size = math.prod(shape)
            w = u[lo:lo + size].reshape(shape) * glorot_limit(shape)
            lo += size
        else:
            w = torch.zeros(shape, device=device)
        out.setdefault(layer, {})[leaf] = w
    return out


def program_adapter(cfg: dict):
    from repro_torch.fl.adapter import femnist_adapter

    return femnist_adapter(cfg["channels"][0])


def round_flops(cfg: dict, traffic: dict, trainers: int,
                validations: int) -> float:
    """FLOPs a round needs: every trainer's local steps and every
    committee validation's forward of ``val_batch`` images."""
    dims = counts.cnn_dims(cfg)
    return (trainers * traffic["local_steps"] * traffic["local_batch"]
            * counts.cnn_train_flops(*dims)
            + validations * traffic["val_batch"] * counts.cnn_forward_flops(*dims))


def gemm_bound_s(cfg: dict, traffic: dict, trainers: int) -> float:
    """The least time of the trainer's products for ``trainers`` clients'
    local steps (``counts.gemm_step_bound_s``, linear in the clients)."""
    return traffic["local_steps"] * counts.gemm_step_bound_s(
        trainers, *counts.cnn_dims(cfg)[:5], traffic["local_batch"],
        cfg["image"])
