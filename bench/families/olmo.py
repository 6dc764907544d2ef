"""OLMo (arXiv:2402.00838) as the port builds it, trained by a community of
LEAF Shakespeare's roles.

The configuration gives the model's published widths and depth; the port
builds it through ``repro_torch.configs.olmo_1b.get_config`` (with the
configuration's ``norm_eps``) and ``lm_adapter``.  The community is
``bench.data.shakespeare``'s token windows.  The weights are made here,
with nothing of the port: OLMo's seeded init drawn from the run's
generator (``init_params``), warm started by ``warm_steps`` steps of
``torch.optim.AdamW`` on ``bench.reference.olmo``'s loss, ``warm_batch``
rows a step from the pooled community (``warm_start``): from the init
every candidate scores no correct token and the committee's scores all
tie.  ``bench.reference.olmo`` judges the rounds.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench.data.shakespeare import make_community
from bench.harness import note
from bench.reference.olmo_judge import Reference

REFERENCE = Reference
WARM_WARMUP = 10
WARM_NOTE = 40           # a progress line every this many warm steps


def model_config(cfg: dict):
    from repro_torch.configs import olmo_1b

    m = cfg["model"]
    return olmo_1b.get_config(
        d_model=m["d_model"], num_units=m["num_units"],
        num_heads=m["num_heads"], num_kv_heads=m["num_heads"],
        d_ff=m["d_ff"], vocab_size=m["vocab_size"],
        rope_theta=m["rope_theta"], norm_eps=m["norm_eps"])


def community(cfg: dict, seed: int, device):
    return make_community(cfg, seed)


def pooled_batches(community, idx):
    """Rows ``idx`` (steps, batch) of the community's pooled rows, as host
    arrays (steps, batch, seq) of tokens and of targets."""
    sizes = np.array([len(y) for y in community.client_labels])
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    role = np.searchsorted(starts, idx, side="right") - 1
    row = idx - starts[role]
    pick = [(community.client_images[r][i], community.client_labels[r][i])
            for r, i in zip(role.reshape(-1), row.reshape(-1))]
    xs, ys = (np.stack([p[j] for p in pick]).reshape(idx.shape + (-1,))
              for j in (0, 1))
    return xs, ys


def init_params(cfg: dict, generator: torch.Generator) -> dict:
    """OLMo's seeded init, drawn here on the generator's device: every
    product's weight normal with std 1 / sqrt(fan-in), the embedding
    normal with std 0.02, each leaf stacked over the blocks; the
    non-parametric norms hold no leaves.  The tree is the one the port's
    ``lm_adapter`` takes."""
    m = cfg["model"]
    L, d, F = m["num_units"], m["d_model"], m["d_ff"]

    def normal(*shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=generator.device).mul_(fan_in ** -0.5)

    embed = torch.randn((m["vocab_size"], d), generator=generator,
                        device=generator.device).mul_(0.02)
    mixer = {n: normal(L, d, d, fan_in=d) for n in ("wq", "wk", "wv", "wo")}
    mlp = {"gate": normal(L, d, F, fan_in=d), "up": normal(L, d, F, fan_in=d),
           "down": normal(L, F, d, fan_in=F)}
    unit = {"mixer": mixer, "mlp": mlp, "norm1": {}, "norm2": {}}
    return {"embed": embed, "units": (unit,), "tail": (), "final_norm": {}}


def warm_start(cfg: dict, params: dict, community, generator: torch.Generator,
               device, on_step=None) -> dict:
    """``warm_steps`` steps of ``torch.optim.AdamW`` (OLMo's betas 0.9 and
    0.95, eps 1e-5, weight decay 0.1) on ``bench.reference.olmo``'s loss
    in float32, each of ``warm_batch`` rows drawn from the pooled
    community; the rate rises linearly over ``WARM_WARMUP`` steps to
    ``warm_lr`` and stays there.  ``on_step(step, params)`` is called
    after each step; every ``WARM_NOTE`` steps the step's loss goes to
    standard error.  Returns the trained weights."""
    from bench.reference import olmo as ref
    from bench.reference.precision import Precision

    steps, batch = cfg["warm_steps"], cfg["warm_batch"]
    if not steps:
        return params
    idx = torch.randint(0, community.rows, (steps, batch),
                        generator=generator, device=device).cpu().numpy()
    xs, ys = (torch.from_numpy(a).to(device)
              for a in pooled_batches(community, idx))
    leaves = [leaf.requires_grad_() for _, leaf in ref.paths(params)]
    opt = torch.optim.AdamW(leaves, lr=cfg["warm_lr"], betas=(0.9, 0.95),
                            eps=1e-5, weight_decay=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: min(1.0, (i + 1) / WARM_WARMUP))
    prec, rcfg = Precision("f32", device), REFERENCE(cfg).cfg
    t = time.perf_counter()
    with prec.scope():
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = ref.loss(ref._unflatten(params, leaves), xs[i], ys[i],
                            rcfg, prec)
            loss.backward()
            opt.step()
            sched.step()
            if (i + 1) % WARM_NOTE == 0 or i + 1 == steps:
                t = note(f"warm step {i + 1} loss {float(loss):.4f}", t)
            if on_step is not None:
                on_step(i + 1, params)
    del opt
    for leaf in leaves:        # the last step's gradients: 4.7 GB at full size
        leaf.grad = None
        leaf.requires_grad_(False)
    return params


def weights(cfg: dict, community, generator: torch.Generator, device) -> dict:
    """The seeded init, warm started (``init_params``, ``warm_start``)."""
    return warm_start(cfg, init_params(cfg, generator), community, generator,
                      device)


def program_adapter(cfg: dict):
    from repro_torch.fl.adapter import lm_adapter

    return lm_adapter(model_config(cfg))


def params_count(cfg: dict) -> int:
    """Weights of the blocks and the (tied) embedding."""
    m = cfg["model"]
    d = m["d_model"]
    block = 4 * d * d + 3 * d * m["d_ff"]
    return m["num_units"] * block + m["vocab_size"] * d


def token_flops(cfg: dict, train: bool) -> float:
    """FLOPs of one token at the traffic's sequence length: 2 N a forward
    (every weight once in a product; the tied embedding as the output
    layer) plus attention's two (S x d) products a block, 4 S d, counted
    whole; a training token three times that (the forward and the two
    products of the backward)."""
    m = cfg["model"]
    fwd = 2 * params_count(cfg) + 4 * m["num_units"] * cfg["seq"] * m["d_model"]
    return 3 * fwd if train else fwd


def round_flops(cfg: dict, traffic: dict, trainers: int,
                validations: int) -> float:
    """FLOPs a round needs: every trainer's local steps of ``local_batch``
    rows and every committee validation's forward of ``val_batch`` rows,
    ``seq`` tokens a row."""
    seq = cfg["seq"]
    return (trainers * traffic["local_steps"] * traffic["local_batch"] * seq
            * token_flops(cfg, True)
            + validations * traffic["val_batch"] * seq
            * token_flops(cfg, False))
