"""OLMo-1B in plain PyTorch: its forward, loss, accuracy and local SGD.

OLMo (Groeneveld et al., arXiv:2402.00838), the 1B model: a decoder of
``num_units`` blocks, each a causal self-attention of ``num_heads`` heads
(rotary position embeddings, base ``rope_theta``, on the two halves of
each head) and a SwiGLU MLP (``silu(x W_gate) * (x W_up)`` then
``W_down``), each behind a non-parametric LayerNorm (no scale, no bias,
``norm_eps``) and added to the residual; a last non-parametric LayerNorm
and the tied embedding as the output layer; no biases anywhere.

Parameters as the chain stores them: ``embed`` (V, d); ``units`` a
one-element tuple of the block's leaves stacked over the blocks:
``mixer`` ``wq``, ``wk``, ``wv`` (d, H * Dh) and ``wo`` (H * Dh, d);
``mlp`` ``gate``, ``up`` (d, F) and ``down`` (F, d); the norms hold no
leaves.  Every product's operands go through ``prec.operand`` and every
tensor is in ``prec.dtype``; ``prec`` is the judge's precision (its
``dtype`` and ``operand``: float64, float32 with TF32 off, or TF32).
Nothing here batches clients, caches a state or calls a kernel.

Departures from the paper, none of which the round under test departs
from: float32 or float64 throughout (OLMo trained in bfloat16 mixed
precision); local training is the BFLC round's momentum SGD on each
client's mean token cross-entropy, not AdamW; sequences are as long as
the rows given (the paper's 2048 at most); the weights are whatever the
caller hands over (the benchmark's seeded init, warm started by AdamW on
this file's loss, not a released checkpoint).

This file imports torch alone; ``tests/olmo_reference.py`` is a copy.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F


def paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, torch.Tensor]]:
    """[(key path, leaf)]: dict keys sorted, tuples by index (the chain's
    leaf order)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, sub in enumerate(tree)
                for pl in paths(sub, prefix + (i,))]
    return [(prefix, tree)]


def layer_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Non-parametric LayerNorm over the last axis: the mean of the squared
    deviations as the variance."""
    centered = x - x.mean(dim=-1, keepdim=True)
    var = centered.square().mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps)


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh) rotated by position 0..S-1: the first half of each
    head against the second, frequency theta ** (-i / (Dh / 2))."""
    S, half = x.shape[1], x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=x.dtype, device=x.device) / half)
    angles = torch.arange(S, dtype=x.dtype, device=x.device)[:, None] * inv
    cos, sin = torch.cos(angles)[None, :, None], torch.sin(angles)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(p: dict, tokens: torch.Tensor, cfg: dict, prec) -> torch.Tensor:
    """tokens (B, S) -> (B, S, V) logits in ``prec.dtype``."""
    op, dt = prec.operand, prec.dtype
    eps, heads = cfg["norm_eps"], cfg["num_heads"]
    embed = p["embed"].to(dt)
    unit = p["units"][0]
    x = embed[tokens.long()]
    B, S, d = x.shape
    hd = d // heads
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    # each stacked leaf taken apart once: its gradient is one stack
    mixers, mlps = ({k: v.to(dt).unbind(0) for k, v in unit[part].items()}
                    for part in ("mixer", "mlp"))
    for layer in range(len(mixers["wq"])):
        w = {k: v[layer] for k, v in mixers.items()}
        h = op(layer_norm(x, eps))
        q, k, v = (h @ op(w[n]) for n in ("wq", "wk", "wv"))
        q, k = (rotary(t.reshape(B, S, heads, hd), cfg["rope_theta"])
                for t in (q, k))
        v = v.reshape(B, S, heads, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", op(q), op(k)) * hd ** -0.5
        attn = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        out = torch.einsum("bhqk,bkhd->bqhd", op(attn), op(v))
        x = x + op(out.reshape(B, S, d)) @ op(w["wo"])
        m = {k: v[layer] for k, v in mlps.items()}
        h = op(layer_norm(x, eps))
        gated = F.silu(h @ op(m["gate"])) * (h @ op(m["up"]))
        x = x + op(gated) @ op(m["down"])
    return op(layer_norm(x, eps)) @ op(embed).T


def loss(p: dict, tokens, targets, cfg: dict, prec) -> torch.Tensor:
    """The mean token cross-entropy."""
    lg = logits(p, tokens, cfg, prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.reshape(-1).long())


def accuracy(p: dict, tokens, targets, cfg: dict, prec) -> torch.Tensor:
    """The share of tokens whose largest logit is the target."""
    return (logits(p, tokens, cfg, prec).argmax(-1) == targets).double().mean()


def train_client(params: dict, xs: torch.Tensor, ys: torch.Tensor,
                 cfg: dict, lr: float, momentum: float, prec) -> dict:
    """One client's update after ``xs.shape[0]`` steps of momentum SGD
    from ``params`` on its own mean loss, in ``prec.dtype``: xs, ys
    (steps, B, S).  Returns the tree of the trained weights minus
    ``params``.  A step's gradient is its B rows' gradients of their own
    mean losses, each over B, summed (the batch mean's terms, one backward
    a row, so that the activations of one row are live); the weights and
    the momentum are updated in place, so the live state is the weights,
    the momentum and one gradient."""
    dt = prec.dtype
    start = [leaf.detach() for _, leaf in paths(params)]
    live = [leaf.to(dt, copy=True).requires_grad_() for leaf in start]
    mu = [torch.zeros_like(leaf) for leaf in live]
    rows = xs.shape[1]
    for step in range(xs.shape[0]):
        tree = _unflatten(params, live)
        grads = None
        for r in range(rows):
            with torch.enable_grad():
                part = torch.autograd.grad(
                    loss(tree, xs[step, r:r + 1], ys[step, r:r + 1], cfg,
                         prec) / rows, live)
            with torch.no_grad():
                if grads is None:
                    grads = list(part)
                else:
                    for g, p in zip(grads, part):
                        g.add_(p)
            del part
        with torch.no_grad():
            for w, m, g in zip(live, mu, grads):
                m.mul_(momentum).add_(g)
                w.sub_(m, alpha=lr)
        del grads, tree
    with torch.no_grad():
        return _unflatten(params, [w.detach().sub_(s.to(dt))
                                   for w, s in zip(live, start)])


def _unflatten(like, leaves: List[torch.Tensor]):
    """``leaves`` (in ``paths`` order) in ``like``'s structure.  No closure
    refers to itself here: a reference cycle would keep the leaves alive
    until the collector runs, gigabytes of them at full width."""
    return _build(like, iter(leaves))


def _build(sub, it):
    if isinstance(sub, dict):
        return {k: _build(sub[k], it) for k in sorted(sub)}
    if isinstance(sub, (list, tuple)):
        return type(sub)(_build(s, it) for s in sub)
    return next(it)
