"""ShardCtx: activation-sharding constraints + the MoE mesh context,
threaded through the model forward.

Port of ``repro/models/shardctx.py``.  Where the reference pins an
activation with ``with_sharding_constraint``, the port redistributes a
DTensor to the named placements; a plain tensor (the ``LocalMesh``, one
device) passes through.  Pinning activations to (dp, None, None) and
logits to (dp, None, model) keeps the batch sharded through the head
instead of letting sharding propagation gather it.

``scope()`` is where the model runs on the mesh: on a ``DeviceMesh`` it
is DTensor's ``implicit_replication``, under which the plain tensors the
model makes itself (rotary tables, masks, zeros) count as replicated
DTensors beside the DTensor parameters and activations; on a
``LocalMesh`` it does nothing.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from repro_torch.models.moe import MoEShardingCtx


_DTENSOR = None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the class looked up once: this runs
    several times a layer on every decode step)."""
    global _DTENSOR
    if _DTENSOR is None:
        from torch.distributed.tensor import DTensor

        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


_SCOPE_DEPTH = 0


@contextlib.contextmanager
def mesh_scope(mesh):
    """``implicit_replication()`` on a DeviceMesh, else nothing.  Nested
    scopes enter it once: it switches itself off on exit, whatever was on
    before."""
    global _SCOPE_DEPTH
    if mesh is None or getattr(mesh, "is_local", False) or _SCOPE_DEPTH:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    _SCOPE_DEPTH += 1
    try:
        with implicit_replication():
            yield
    finally:
        _SCOPE_DEPTH -= 1


def unshard_dim(x, dim: int, parts: int):
    """``x`` with tensor dimension ``dim`` no longer split over the mesh
    dimensions whose sizes do not divide ``parts``: DTensor cannot view a
    dimension split n ways as (parts, rest) unless n divides parts (GSPMD
    reshards there by itself).  Plain tensors pass through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dim = dim % x.dim()
    mesh = x.device_mesh
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(i)
    if n == 1 or parts % n == 0:
        return x
    return x.redistribute(mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements))


class _GradLikeForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements)


class _PinBothWays(torch.autograd.Function):
    """Redistribute to ``placements``, and the cotangent to the same."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def grad_like(x):
    """``x``, whose cotangent is redistributed to ``x``'s own placements
    in the backward before it flows on: a matmul's rule may split the
    cotangent along a dimension that the backward of a reshape then
    cannot view (heads the model axis does not divide).  Plain tensors
    pass through."""
    return _GradLikeForward.apply(x) if is_dtensor(x) else x


def replicate(x):
    """``x`` whole on every rank (a DTensor redistributed to
    ``Replicate()``); plain tensors pass through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def whole(x):
    """A DTensor's full value as this rank's plain tensor; plain tensors
    pass through.  The decode caches are plain tensors every rank holds
    whole (as the tokens and positions are): what a sharded step writes
    into them is gathered first."""
    return x.full_tensor() if is_dtensor(x) else x


class ShardCtx(NamedTuple):
    mesh: object
    moe: Optional[MoEShardingCtx] = None
    act_spec: Optional[tuple] = None      # (B, S, D) activations
    logits_spec: Optional[tuple] = None   # (B, S, V) logits
    kv_spec: Optional[tuple] = None       # (B, S, Kv, Dh) attention K/V
    q_spec: Optional[tuple] = None        # (B, S, H, Dh) — set iff H % mesh == 0
    dp: Optional[tuple] = None            # data axes (None when batch unsharded)
    model_axis: str = "model"
    model_size: int = 1

    def _pin(self, x, spec, ndim=None):
        if spec is None or (ndim is not None and x.dim() != ndim) \
                or not is_dtensor(x):
            return x
        from repro_torch.launch.shardings import placements

        return x.redistribute(self.mesh, placements(self.mesh, spec))

    def act(self, x):
        """Pin a (B, S, D) activation, and its cotangent in the backward:
        DTensor's own backward of a reduction to ``Replicate`` hands back
        a ``Partial`` cotangent, with which the products behind it run
        whole on every model rank."""
        if self.act_spec is None or x.dim() != 3 or not is_dtensor(x):
            return x
        from repro_torch.launch.shardings import placements

        return _PinBothWays.apply(x, placements(self.mesh, self.act_spec))

    def logits(self, x):
        return self._pin(x, self.logits_spec)

    def kv(self, x):
        """Pin K/V before attention (heads over model when they divide
        it), so sharding propagation does not compute every block on every
        model shard."""
        return self._pin(x, self.kv_spec, 4)

    def q(self, x):
        return self._pin(x, self.q_spec, 4)

    def scope(self):
        return mesh_scope(self.mesh)


def make_shard_ctx(mesh, dp_axes, model_axis: str, *, batch_sharded: bool,
                   moe: Optional[MoEShardingCtx] = None,
                   num_kv_heads: int = 0, num_heads: int = 0,
                   seq_parallel: bool = False,
                   act_shard_d: bool = False) -> ShardCtx:
    from repro_torch.launch.mesh import mesh_axis_names, mesh_axis_size
    from repro_torch.launch.shardings import P

    dp = dp_axes if batch_sharded else None
    # data-only meshes have no model axis: treat it as size 1 and never
    # name it in a spec
    msize = mesh_axis_size(mesh, model_axis)
    M = model_axis if model_axis in mesh_axis_names(mesh) else None
    kv_heads_shardable = (M is not None and num_kv_heads > 0
                          and num_kv_heads % msize == 0)
    q_heads_shardable = (M is not None and num_heads > 0
                         and num_heads % msize == 0)
    return ShardCtx(
        mesh=mesh,
        moe=moe,
        act_spec=P(dp, M if seq_parallel else None,
                   M if act_shard_d and not seq_parallel else None),
        logits_spec=P(dp, None, M),
        kv_spec=P(dp, None, M if kv_heads_shardable else None, None),
        q_spec=(P(dp, None, M, None) if q_heads_shardable else None),
        dp=dp,
        model_axis=model_axis,
        model_size=msize,
    )
