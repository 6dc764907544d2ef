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
a cache whose sequence is split over ranks.  The embedding lookup
(``vocab_lookup``) and the greedy pick over split logits
(``vocab_argmax``) are local maps too: each rank works on its own block
of the vocabulary, as the reference's compiled steps do.

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

from repro_torch.launch.mesh import all_gather, reduce_scatter
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


def reduce_partial(x):
    """``x`` with each ``Partial`` placement reduced to ``Replicate`` (its
    cotangent stays as it comes: DTensor keeps a replicated gradient
    replicated); plain tensors, and DTensors with no ``Partial``, pass
    through.  Before a product with a weight split along its output
    (the MLP's ``down`` at a batch of one, its D split over data): a
    ``Partial`` operand there makes DTensor gather the weight."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


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


def split_dims(mesh, placements, dim=None) -> list:
    """The mesh dimensions of size 2 or more on which ``placements``
    split tensor dimension ``dim`` (any dimension when None), in mesh
    order."""
    return [i for i, p in enumerate(placements)
            if p.is_shard() and mesh.size(i) > 1
            and (dim is None or p.dim == dim)]


def local_groups(mesh, placements, dim: int) -> list:
    """The process groups of the mesh dimensions that split ``dim``, in
    mesh order (size-1 dimensions hold no split)."""
    return [mesh.get_group(i) for i in split_dims(mesh, placements, dim)]


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


# ----------------------------------------------------------------------------
# local maps: the vocabulary
# ----------------------------------------------------------------------------


class _VocabLookup(torch.autograd.Function):
    """``vocab_lookup``'s local map on a rank's table block (vn, dn) and
    its tokens.  ``plan``: (v0, the model groups, the D groups, (d0, dn),
    gather_block), groups in mesh order."""

    @staticmethod
    def forward(ctx, block, tokens, plan):
        v0, v_groups, d_groups, _, gather_block = plan
        if gather_block:
            # the rank's rows whole in D, the minor axis's blocks first
            for g in reversed(d_groups):
                block = all_gather(block, 1, g)
        local = tokens.long() - v0
        hit = (local >= 0) & (local < block.shape[0])
        idx = torch.where(hit, local, torch.zeros_like(local))
        rows = torch.where(hit[..., None], block[idx], block.new_zeros(()))
        # one real row and zeros over the model ranks: an exact sum
        out = all_reducer(v_groups)(rows, "sum")
        if not gather_block:
            for g in reversed(d_groups):
                out = all_gather(out, -1, g)
        ctx.save_for_backward(idx, hit)
        ctx.plan, ctx.rows = plan, block.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        idx, hit = ctx.saved_tensors
        _, _, d_groups, (d0, dn), gather_block = ctx.plan
        if d_groups and not gather_block:
            g = g.narrow(-1, d0, dn)
        # the backward of ``block[idx]`` (aten's index backward, whose
        # sums run in a fixed order): on a mesh of one rank, the bits of
        # the plain lookup's gradient
        grad = g.new_zeros((ctx.rows, g.shape[-1])).index_put_(
            (idx,), torch.where(hit[..., None], g, g.new_zeros(())),
            accumulate=True)
        if gather_block:
            # the other ranks' tokens' rows summed, each keeping its D block
            for gr in d_groups:
                grad = reduce_scatter(grad, 1, gr)
        return grad, None, None


def vocab_lookup(table, tokens):
    """``table[tokens]`` for a (V, D) DTensor table laid out as
    ``param_pspecs`` lays out the embedding: V split over model, D over
    the data axes under FSDP.  The local map never gathers the table:

    * each rank looks up the rows of its own vocabulary block; a token
      outside the block gives a zero row, and the rows are summed over
      model (one real row plus zeros: exact);
    * where D is split over axes that also split the tokens (FSDP, the
      batch over data), the rank's block is first gathered whole in D
      (V / model x D, the gather FSDP makes of every other weight);
      where the tokens are whole on those axes (a batch of one), the
      (..., D / data) rows are looked up and gathered along D instead.

    The result is laid out as the tokens are (plain tokens: whole on
    every rank).  The backward scatter-adds each rank's cotangent rows
    into its own block only: a ``Partial`` sum over the axes that split
    the tokens, reduce-scattered over D's axes where the block was
    gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    tpl = tuple(table.placements)
    V, D = table.shape
    if is_dtensor(tokens):
        tok_pl, tok = tuple(tokens.placements), tokens.to_local()
    else:
        tok_pl, tok = (Replicate(),) * mesh.ndim, tokens
    v_dims, d_dims = split_dims(mesh, tpl, 0), split_dims(mesh, tpl, 1)
    t_dims = split_dims(mesh, tok_pl)
    if set(t_dims) & set(v_dims):
        raise ValueError("tokens split over the vocabulary's mesh axes")
    gather_block = bool(set(t_dims) & set(d_dims))
    grad_pl = tuple(Shard(0) if i in v_dims else Shard(1) if i in d_dims
                    else Partial() if i in t_dims else Replicate()
                    for i in range(mesh.ndim))
    v0, _ = shard_range(mesh, tpl, 0, V)
    plan = (v0, local_groups(mesh, tpl, 0), local_groups(mesh, tpl, 1),
            shard_range(mesh, tpl, 1, D), gather_block)
    out = _VocabLookup.apply(table.to_local(grad_placements=grad_pl), tok,
                             plan)
    return as_dtensor(out, mesh, tok_pl, tuple(tokens.shape) + (D,))


def _pick_largest(vals, idxs):
    """Over the leading axis of (n, B) candidate maxima and their indices:
    the largest value, a tie going to the lowest index and a NaN counting
    as the largest (``jnp.argmax``'s pick).  Returns (value, index)."""
    nan = vals.isnan()
    score = torch.where(nan, torch.full_like(vals, float("inf")), vals)
    top = (score == score.amax(0)) & (nan | ~nan.any(0))
    k = torch.where(top, idxs, torch.full_like(idxs, torch.iinfo(
        idxs.dtype).max)).argmin(0)[None]
    return vals.gather(0, k)[0], idxs.gather(0, k)[0]


def vocab_argmax(x):
    """``argmax(x, -1)`` as int32 of (B, V) logits.  A DTensor whose V is
    split over mesh axes takes each rank's largest entry and its global
    index, gathers the (value, index) pairs over those axes and keeps the
    largest, a tie to the lowest index (``jnp.argmax``'s); the vocabulary
    row is never gathered.  The result is laid out as ``x``'s rows are."""
    if not is_dtensor(x):
        return torch.argmax(x, dim=-1).to(torch.int32)
    mesh = x.device_mesh
    pl = keep_dims(x.placements, {0: 0, 1: 1})
    loc = local_part(x, mesh, pl)
    v0, _ = shard_range(mesh, pl, 1, x.shape[1])
    idx = torch.argmax(loc, dim=-1)
    val = loc.gather(-1, idx[:, None])[:, 0]
    idx = (idx + v0).to(torch.int32)
    for g in local_groups(mesh, pl, 1):
        val, idx = _pick_largest(all_gather(val[None], 0, g),
                                 all_gather(idx[None], 0, g))
    return as_dtensor(idx, mesh, keep_dims(pl, {0: 0}), (x.shape[0],))


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
