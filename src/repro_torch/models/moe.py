"""Mixture-of-Experts layer: the dense path.

Port of ``repro/models/moe.py``'s ``moe_dense``: every expert computes
every token, and each token sums its top-k experts' outputs weighted by
the router, with no capacity and no dropped token.  The parameter layout
is the reference's, shared with its expert-parallel path (V = E * r
virtual experts, F_v = moe_d_ff // r):
  router:  (D, E)
  gate,up: (V, D, F_v)
  down:    (V, F_v, D)

The expert-parallel path (capacity dispatch over a mesh with two
all-to-alls) comes with the LM mesh: ``moe_impl="expert_parallel"`` or a
sharding context raises ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn, dense_init, is_gated, normal

LM_MESH_ITEM = "ROADMAP.md Queue 1 item 11 (the LM half of the mesh)"


def virtual_factor(cfg: ModelConfig, model_axis_size: int) -> int:
    """Replica factor r (1 when E >= the model axis M)."""
    if cfg.num_experts >= model_axis_size:
        if cfg.num_experts % model_axis_size:
            raise ValueError(
                f"num_experts={cfg.num_experts} not divisible by model axis "
                f"{model_axis_size}"
            )
        return 1
    if model_axis_size % cfg.num_experts:
        raise ValueError(
            f"model axis {model_axis_size} not divisible by "
            f"num_experts={cfg.num_experts}"
        )
    return model_axis_size // cfg.num_experts


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, *,
             virtual_r: int = 1) -> dict:
    E, D = cfg.num_experts, cfg.d_model
    F = cfg.resolved_moe_d_ff
    if F % virtual_r:
        raise ValueError(f"moe_d_ff {F} not divisible by virtual_r {virtual_r}")
    V, Fv = E * virtual_r, F // virtual_r
    std_in, std_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    p = {
        "router": dense_init(gen, D, E, dtype=dtype),
        "up": normal(gen, (V, D, Fv), std_in).to(dtype),
        "down": normal(gen, (V, Fv, D), std_out).to(dtype),
    }
    if is_gated(cfg.act):
        p["gate"] = normal(gen, (V, D, Fv), std_in).to(dtype)
    return p


def route(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (T, D) -> (weights (T, k), ids (T, k), aux_loss scalar).

    Softmax in float32, the top k in descending order (``torch.topk``
    sorted, as ``lax.top_k``), weights normalised over the k, and the
    Switch load-balance loss ``E * sum(me * ce) * coef``: ``me`` the mean
    router probability an expert, ``ce`` the share of the T * k routing
    slots it took."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                        # (T, E)
    w, ids = torch.topk(probs, cfg.num_experts_per_tok, dim=-1, sorted=True)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    E = cfg.num_experts
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, ids.reshape(-1),
        torch.full((ids.numel(),), 1.0 / ids.numel(), dtype=torch.float32,
                   device=x.device))
    aux = E * torch.sum(me * ce) * cfg.router_aux_loss_coef
    return w, ids, aux


def _expert_ffn(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h: (V, T, D) tokens per (virtual) expert -> (V, T, D)."""
    f = act_fn(cfg.act)
    up = torch.bmm(h, params["up"])
    if "gate" in params:
        hidden = f(torch.bmm(h, params["gate"])) * up
    else:
        hidden = f(up)
    return torch.bmm(hidden, params["down"])


def moe_dense(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (out, aux).  Computes all experts on all tokens."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    w, ids, aux = route(params, xt, cfg)
    V = params["up"].shape[0]
    r = V // cfg.num_experts
    h = xt[None].expand(V, B * S, D)
    y = _expert_ffn(params, h, cfg)                              # (V, T, D)
    y = y.reshape(cfg.num_experts, r, B * S, D).sum(dim=1)       # (E, T, D)
    gathered = torch.gather(
        y.transpose(0, 1), 1,                                    # (T, E, D)
        ids[..., None].expand(B * S, ids.shape[1], D))           # (T, k, D)
    out = (gathered * w[..., None].to(y.dtype)).sum(dim=1)
    return out.reshape(B, S, D).to(x.dtype), aux


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig, ctx=None):
    """The MoE layer on one device: the dense path."""
    impl = cfg.moe_impl
    if impl == "expert_parallel" or ctx is not None:
        raise NotImplementedError(
            f"the expert-parallel MoE is not ported yet: {LM_MESH_ITEM}")
    return moe_dense(params, x, cfg)
