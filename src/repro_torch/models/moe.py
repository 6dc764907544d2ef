"""Mixture-of-Experts layer.

Port of ``repro/models/moe.py``.  Two implementations sharing one
parameter layout:

* ``moe_dense``           — every expert computes every token, combined
  with router weights.  Exact (no capacity dropping).  Taken for
  ``moe_impl="dense"``, and by ``"auto"`` without a sharding context.
* ``moe_expert_parallel`` — capacity-based dispatch over a mesh's
  ``model`` axis with two all-to-alls (the classic expert-parallel
  schedule), the reference's ``shard_map`` body written as explicit
  collectives on local tensors.  ``"auto"`` takes it whenever a context
  (``MoEShardingCtx``) is given, as the reference does: the steps and the
  serve engine always give one (their default mesh is the 1 x 1
  ``LocalMesh``), so an MoE model follows the reference's capacity
  semantics: per source shard and expert, ``C = ceil(A / E *
  moe_capacity_factor)`` slots for its A = T * k assignments, taken in
  token order; an assignment over capacity is dropped (its expert output
  counts 0).  When the expert count E is smaller than the model-axis
  size M, each expert is split into ``r = M // E`` *virtual experts* that
  hold a 1/r slice of the FFN hidden dim; tokens go to all r slices and
  the down-projection partial sums are added on the way back.

Parameter layout (V = E * r virtual experts, F_v = moe_d_ff // r):
  router:  (D, E)
  gate,up: (V, D, F_v)
  down:    (V, F_v, D)
"""
from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import (
    all_gather,
    all_reduce_mean,
    all_to_all,
    axes_group,
    mesh_axis_names,
    mesh_axis_size,
    reduce_scatter,
)
from repro_torch.launch.shardings import P, placements, spec_axes
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import act_fn, dense_init, is_gated, normal


class MoEShardingCtx(NamedTuple):
    """How the expert-parallel path maps onto the mesh."""

    mesh: object                    # DeviceMesh or LocalMesh
    dp_axes: Tuple[str, ...]        # axes the batch is sharded over
    model_axis: str                 # axis experts are sharded over
    batch_sharded: bool = True      # False for global_batch=1 decode
    # 2D expert parallelism: expert weights keep Fv sliced over the data
    # axes; the token buffers are all-gathered over data and the partial
    # outputs reduce-scattered back
    tp_over_dp: bool = False


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


# ----------------------------------------------------------------------------
# expert parallel (capacity dispatch + two all-to-alls)
# ----------------------------------------------------------------------------


_DROPS: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def count_drops():
    """Collect, for each expert-parallel call inside the block, the number
    of this rank's assignments dropped over capacity: a 0-d device tensor
    a call, appended to the yielded list without waiting for the
    device."""
    global _DROPS
    outer, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = outer


def _dispatch_positions(ids_flat: torch.Tensor, E: int, C: int):
    """Per-assignment slot within its expert's capacity buffer.

    ids_flat: (A,) expert id per assignment.  Returns (pos (A,) int32,
    keep (A,) bool): an expert's assignments take slots 0, 1, ... in
    assignment order (a stable sort-based ranking, O(A) memory); those at
    slot C or beyond are dropped."""
    A = ids_flat.shape[0]
    dev = ids_flat.device
    ids_flat = ids_flat.long()
    order = torch.argsort(ids_flat, stable=True)
    sorted_ids = ids_flat[order]
    starts = torch.searchsorted(sorted_ids, torch.arange(E, device=dev))
    pos_sorted = torch.arange(A, device=dev) - starts[sorted_ids]
    pos = torch.empty((A,), dtype=torch.int32, device=dev).index_copy_(
        0, order, pos_sorted.to(torch.int32))
    return pos, pos < C


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _GatherScatter(torch.autograd.Function):
    """``all_gather`` along ``dim`` (``gather=True``) or ``reduce_scatter``,
    each the other's transpose."""

    @staticmethod
    def forward(ctx, x, dim, group, gather):
        ctx.args = (dim, group, gather)
        return (all_gather if gather else reduce_scatter)(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, gather = ctx.args
        return ((reduce_scatter if gather else all_gather)(g, dim, group),
                None, None, None)


class _Mean(torch.autograd.Function):
    """``lax.pmean`` of a scalar whose cotangent every rank holds whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce_mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _a2a(x, group):
    return x if group is None else _AllToAll.apply(x, group)


def _gather(x, dim, group, gather=True):
    return x if group is None else _GatherScatter.apply(x, dim, group, gather)


def _pmean(x, group):
    return x if group is None else _Mean.apply(x, group)


class _ScaleGrad(torch.autograd.Function):
    """The identity whose backward scales the cotangent by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _ep_body(p: dict, xl: torch.Tensor, cfg: ModelConfig, *, M: int, r: int,
             model_group, dp_group, tp: bool, aux_group):
    """The reference's ``shard_map`` body on this rank's local tensors:
    xl (B_loc, S_loc, D), expert leaves (V / M, ...) -> (y, aux)."""
    B_loc, S_loc, D = xl.shape
    T = B_loc * S_loc
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    V = E * r
    pv = V // M
    xt = xl.reshape(T, D)
    w, ids, aux = route(p, xt, cfg)                       # (T,k),(T,k)
    A = T * k
    ids_f = ids.reshape(A)
    w_f = w.reshape(A)
    # capacity per (source shard, real expert)
    C = max(1, int(math.ceil(A / E * cfg.moe_capacity_factor)))
    pos, keep = _dispatch_positions(ids_f, E, C)
    if _DROPS is not None:
        _DROPS.append((~keep).sum())
    pos = pos.long()
    # send buffer (V, C, D): replica j of expert e is virtual expert e*r+j;
    # a dropped assignment writes a spare row past the end, cut off after
    src = xt.repeat_interleave(k, dim=0)                  # (A, D)
    spare = V * C
    buf = xt.new_zeros((V * C + 1, D))
    rows = []
    for j in range(r):
        row = torch.where(keep, (ids_f * r + j) * C + pos,
                          torch.full_like(pos, spare))
        buf = buf.index_put((row,), src)
        rows.append(row)
    buf = buf[:spare].reshape(M, pv, C, D)
    recv = _a2a(buf, model_group)                         # (M, pv, C, D)
    recv = recv.transpose(0, 1).reshape(pv, M * C, D)
    if tp:
        # 2D EP: every data shard's expert tokens against the local Fv
        # slice, the partial outputs reduce-scattered back
        recv_all = _gather(recv, 1, dp_group)
        out_all = _expert_ffn(p, recv_all, cfg)
        out_e = _gather(out_all, 1, dp_group, gather=False)
    else:
        out_e = _expert_ffn(p, recv, cfg)                 # (pv, M*C, D)
    out_e = out_e.reshape(pv, M, C, D).transpose(0, 1).contiguous()
    back = _a2a(out_e, model_group).reshape(V * C, D)
    back = torch.cat([back, back.new_zeros((1, D))])      # the spare row
    # gather + combine replicas and top-k
    y = torch.zeros((A, D), dtype=torch.float32, device=xl.device)
    for row in rows:
        y = y + torch.where(keep[:, None], back[row].to(torch.float32), 0.0)
    y = (y * w_f[:, None]).reshape(T, k, D).sum(dim=1)
    aux = _pmean(aux, aux_group)
    return y.reshape(B_loc, S_loc, D).to(xl.dtype), aux


def _ep_specs(params: dict, S: int, ctx: MoEShardingCtx):
    """The expert-parallel layer's layout on ``ctx.mesh``: (x_spec,
    param specs, the axes ``aux`` is averaged over), the reference's
    ``in_specs``."""
    M = mesh_axis_size(ctx.mesh, ctx.model_axis)
    seq_sharded = ctx.batch_sharded and S > 1 and S % M == 0
    if seq_sharded:
        x_spec = P(ctx.dp_axes, ctx.model_axis, None)
    elif ctx.batch_sharded:
        x_spec = P(ctx.dp_axes, None, None)
    else:
        x_spec = P(None, None, None)
    fv = ctx.dp_axes if (ctx.tp_over_dp and ctx.batch_sharded) else None
    pspec = {"router": P(None, None),
             "up": P(ctx.model_axis, None, fv),
             "down": P(ctx.model_axis, fv, None)}
    if "gate" in params:
        pspec["gate"] = P(ctx.model_axis, None, fv)
    aux_axes = ()
    if ctx.batch_sharded:
        aux_axes = tuple(ctx.dp_axes) + ((ctx.model_axis,) if seq_sharded
                                         else ())
    return x_spec, pspec, aux_axes


def moe_expert_parallel(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        ctx: MoEShardingCtx):
    """x: (B, S, D) -> (out, aux) with all-to-all expert parallelism.

    Each source shard (a data slice, and a sequence slice of it over
    ``model`` when the batch is sharded and ``S % M == 0``) routes its own
    tokens.  Two kinds of input:

    * on a ``LocalMesh`` the tensors are the whole and every collective is
      the identity;
    * on a ``DeviceMesh`` they are DTensors (the steps and the engine lay
      the parameters out with ``distribute``), redistributed to the layer's layout (``_ep_specs``) and
      the outputs come back as DTensors in it.  Each output is replicated
      over the mesh axes its spec does not name, computed once on each of
      their ranks; its cotangent is scaled by 1 / (their size) and the
      local gradients of the inputs are partial sums over the axes those
      replicate over, so the gradients are the reference's.
    """
    mesh = ctx.mesh
    M = mesh_axis_size(mesh, ctx.model_axis)
    r = virtual_factor(cfg, M)
    x_spec, pspec, aux_axes = _ep_specs(params, x.shape[1], ctx)
    tp = ctx.tp_over_dp and ctx.batch_sharded
    groups = dict(model_group=axes_group(mesh, ctx.model_axis),
                  dp_group=axes_group(mesh, ctx.dp_axes) if tp else None,
                  tp=tp, aux_group=axes_group(mesh, aux_axes)
                  if aux_axes else None)
    if getattr(mesh, "is_local", False):
        return _ep_body(params, x, cfg, M=M, r=r, **groups)

    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(x, DTensor):
        raise TypeError("on a DeviceMesh the expert-parallel MoE takes "
                        "DTensors (lay the parameters out with distribute)")
    names = mesh_axis_names(mesh)

    def local(t, spec):
        pl = placements(mesh, spec)
        axes = spec_axes(spec)
        grad_pl = tuple(p if a in axes else Partial()
                        for a, p in zip(names, pl))
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    def replicas(axes) -> int:
        n = 1
        for a in names:
            if a not in axes:
                n *= mesh_axis_size(mesh, a)
        return n

    p_loc = {n: local(params[n], s) for n, s in pspec.items()}
    y, aux = _ep_body(p_loc, local(x, x_spec), cfg, M=M, r=r, **groups)
    ry, raux = replicas(spec_axes(x_spec)), replicas(set(aux_axes))
    if ry > 1:
        y = _ScaleGrad.apply(y, 1.0 / ry)
    if raux > 1:
        aux = _ScaleGrad.apply(aux, 1.0 / raux)
    y = DTensor.from_local(y, mesh, placements(mesh, x_spec), run_check=False)
    aux = DTensor.from_local(aux, mesh, (Replicate(),) * len(names),
                             run_check=False)
    return y, aux


def apply_moe(params: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: Optional[MoEShardingCtx] = None):
    """``moe_impl="auto"`` is the expert-parallel path when a context is
    given, else the dense one; ``"expert_parallel"`` needs a context."""
    impl = cfg.moe_impl
    if impl == "auto":
        impl = "expert_parallel" if ctx is not None else "dense"
    if impl == "expert_parallel":
        if ctx is None:
            raise ValueError("the expert-parallel MoE needs a sharding context")
        return moe_expert_parallel(params, x, cfg, ctx)
    return moe_dense(params, x, cfg)
