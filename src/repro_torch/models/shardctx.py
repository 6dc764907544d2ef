"""ShardCtx: activation-sharding constraints + the MoE mesh context,
threaded through the model forward.

Port of ``repro/models/shardctx.py``.  Where the reference pins an
activation with ``with_sharding_constraint``, the port redistributes a
DTensor to the named placements; a plain tensor (the ``LocalMesh``, one
device) passes through.  Pinning activations to (dp, None, None) and
logits to (dp, None, model) keeps the batch sharded through the head
instead of letting sharding propagation gather it.

On a DeviceMesh the decode cache is DTensors laid out by
``launch.shardings.cache_pspecs``; the local maps below read and write
each rank's blocks of it, and ``softmax_merge`` joins the attention over
a cache whose sequence is split over ranks.

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
    pass through."""
    return x.full_tensor() if is_dtensor(x) else x


# ----------------------------------------------------------------------------
# local maps: the decode state on a mesh
# ----------------------------------------------------------------------------
#
# The decode cache lives on a DeviceMesh as DTensors laid out by
# ``launch.shardings.cache_pspecs``.  What reads or writes it runs as a
# local map: each rank takes its own blocks (``local_part``), computes on
# plain tensors and hands back a DTensor made from its block
# (``as_dtensor``).  A rank's place along a split dimension
# (``shard_range``) is a Python int from its mesh coordinate: the
# offsets DTensor would compute are tensor operations, which the dry
# run's fake mode cannot read.


def shard_range(mesh, placements, dim: int, size: int):
    """(start, length) of this rank's block of a dimension of ``size``
    split by ``placements``: torch's ``Shard`` blocks (``torch.chunk``'s:
    the first ranks take the extra rows), in mesh-dimension order, major
    to minor."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    start = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(i)
            chunk = -(-size // n)
            s = min(coord[i] * chunk, size)
            size = max(0, min(size, s + chunk) - s)
            start += s
    return start, size


def keep_dims(placements, dims: dict) -> tuple:
    """``placements`` with ``Shard(d)`` renumbered to ``Shard(dims[d])``
    for the dimensions ``dims`` names, every other entry ``Replicate()``:
    the layout of a tensor that shares some dimensions of another."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in placements)


def local_part(x, mesh, placements):
    """This rank's block of ``x`` laid out by ``placements``: a DTensor
    redistributed there, a plain tensor (one every rank holds whole)
    narrowed to the block."""
    if is_dtensor(x):
        return x.redistribute(mesh, placements).to_local()
    from torch.distributed.tensor import Shard

    for d in sorted({p.dim for p in placements if isinstance(p, Shard)}):
        x = x.narrow(d, *shard_range(mesh, placements, d, x.shape[d]))
    return x


def as_dtensor(local, mesh, placements, shape):
    """A DTensor of global ``shape`` (contiguous strides) whose block on
    this rank is ``local``; uneven blocks allowed, no communication."""
    from torch.distributed.tensor import DTensor

    shape = tuple(int(n) for n in shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= max(n, 1)
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def full_dtensor(shape, fill, dtype, device, mesh, spec):
    """A DTensor of ``shape`` filled with ``fill``, laid out by ``spec``
    (a ``launch.shardings.P``), each rank allocating only its block."""
    from repro_torch.launch.shardings import placements as spec_placements

    pl = spec_placements(mesh, spec)
    local_shape = [shard_range(mesh, pl, d, n)[1] for d, n in enumerate(shape)]
    local = torch.full(local_shape, fill, dtype=dtype, device=device)
    return as_dtensor(local, mesh, pl, shape)


def local_groups(mesh, placements, dim: int) -> list:
    """The process groups of the mesh dimensions that split ``dim``, in
    mesh order (size-1 dimensions hold no split)."""
    from torch.distributed.tensor import Shard

    return [mesh.get_group(i) for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim and mesh.size(i) > 1]


def all_reducer(groups):
    """``reduce(t, op)``: ``t``'s all-reduce ("max" or "sum") over each
    group in turn, as a new tensor (``t`` itself with no group)."""
    def reduce(t, op):
        if not groups:
            return t
        import torch.distributed as dist

        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        t = t.clone(memory_format=torch.contiguous_format)
        for g in groups:
            dist.all_reduce(t, op=red, group=g)
        return t
    return reduce


def softmax_merge(m, l, o, reduce):
    """A softmax-weighted sum over a sequence whose slots are split over
    ranks, from each rank's partial: ``m`` its row max (..., 1), ``l`` its
    sum of exp(s - m) (..., 1), ``o`` its sum of exp(s - m) v (..., Dh).
    The max is all-reduced first; each rank rescales by exp(m - max) and
    the sums are all-reduced (``reduce``, from ``all_reducer``).  A rank
    whose slots are all masked (m at the masking fill, -1e30) rescales by
    exp(-1e30 - max) = 0 and adds exactly zero; when every slot of a row
    is masked the result is the mean of v, the whole row's softmax."""
    m_all = reduce(m, "max")
    c = torch.exp(m - m_all)
    return reduce(o * c, "sum") / reduce(l * c, "sum")


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
    # spec of each decode-cache leaf by name (``cache_leaf_specs``): the
    # layout the prefill writes its cache in on a DeviceMesh
    cache_specs: Optional[dict] = None

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
                   act_shard_d: bool = False,
                   cache_specs: Optional[dict] = None) -> ShardCtx:
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
        cache_specs=cache_specs,
    )
