"""Minimal optimizers over dicts of tensors (port of
``repro/optim/optimizers.py``).

``Optimizer.init(params) -> state``;
``Optimizer.update(grads, state, params, step) -> (new_params, new_state)``.

Both are pure functions: they return new trees and leave their inputs as
they were, and run under ``torch.no_grad()``.  The arithmetic is the
reference's, in float32: the step count, ``b1 ** t``, ``b2 ** t`` and the
learning rate are float32 tensors on the parameters' device (Python
floats would compute the bias corrections in float64), the gradient
clip's norm sums each leaf's squares in float32, and ``moment_dtype``
stores the Adam moments in that dtype (bfloat16 for giant models) while
the update math stays float32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step) -> (params, state)


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def _step_tensor(step, device) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.int32)
    return torch.full((), int(step), dtype=torch.int32, device=device)


def sgd(lr: Callable | float, *, momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lr_fn(_step_tensor(step, _device_of(params)))
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads, params)
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr_t * g, params, grads), state
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda g, m: g + momentum * m, grads, mu)
        else:
            upd = mu
        return tree_map(lambda p, u: p - lr_t * u, params, upd), {"mu": mu}

    return Optimizer(init, update)


def adamw(
    lr: Callable | float,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moment_dtype=None,
    grad_clip_norm: float = 0.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)
    f32 = torch.float32

    def init(params):
        # zeros_like keeps a DTensor parameter's mesh and placements
        zeros = tree_map(
            lambda p: torch.zeros_like(p, dtype=moment_dtype or p.dtype),
            params)
        return {"m": zeros, "v": tree_map(torch.clone, zeros)}

    @torch.no_grad()
    def update(grads, state, params, step):
        device = _device_of(params)
        step = _step_tensor(step, device)
        if grad_clip_norm > 0:
            total = None
            for g in tree_leaves(grads):
                sq = torch.sum(torch.square(g.to(f32)))
                total = sq if total is None else total + sq
            gnorm = torch.sqrt(total)
            scale = torch.clamp(grad_clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: (g * scale).to(g.dtype), grads)
        m = tree_map(
            lambda mo, g: (b1 * mo.to(f32) + (1 - b1) * g.to(f32)).to(mo.dtype),
            state["m"], grads,
        )
        v = tree_map(
            lambda vo, g: (b2 * vo.to(f32)
                           + (1 - b2) * torch.square(g.to(f32))).to(vo.dtype),
            state["v"], grads,
        )
        t = step.to(f32) + 1.0
        bc1 = 1.0 - torch.full((), b1, dtype=f32, device=device) ** t
        bc2 = 1.0 - torch.full((), b2, dtype=f32, device=device) ** t
        lr_t = lr_fn(step)

        def upd(p, mo, vo):
            mhat = mo.to(f32) / bc1
            vhat = vo.to(f32) / bc2
            u = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u + weight_decay * p.to(f32)
            return (p.to(f32) - lr_t * u).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v}

    return Optimizer(init, update)
