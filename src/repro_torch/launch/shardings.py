"""Sharding policy: partition specs for parameters, batches and caches, and
the round engine's data layout.

Port of ``repro/launch/shardings.py``.  A spec is a ``P``: a tuple with
one entry per tensor dimension, each a mesh axis name, a tuple of axis
names or None (not split), as JAX's ``PartitionSpec``.  Specs are
computed from shapes alone, so a full-size config's tree can be walked on
``device="meta"`` tensors.  ``named(mesh, specs)`` turns them into
DTensor placements (one ``Shard(dim)`` / ``Replicate()`` per mesh
dimension) and ``distribute(tree, mesh, specs)`` lays a tree out by them.

Baseline policy (the reference's):

* tensor parallelism over ``model``: attention heads / FFN hidden /
  experts / vocab;
* FSDP over ``data`` (+``pod``): the other big matrix dim;
* batch over the data axes; batch 1 shards the KV-cache sequence axis
  instead (``cache_pspecs``; the decode step's tokens, positions and
  logits: ``decode_pspecs``).

Rules are (parent-context, leaf-name)-keyed, applied over the param tree;
leaves under the stacked ``units`` get a leading ``None`` axis.

The round engine's layout (``round_engine_pspecs``,
``score_matrix_pspecs``) names, for the 1-D ``("data",)`` round mesh,
the tensor dimension split over its ranks, or None for a tensor every
rank holds whole; ``RoundMesh.shard`` / ``RoundMesh.gather`` split and
gather by it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, NamedTuple, Optional, Tuple

if TYPE_CHECKING:   # the models package imports this module
    from repro_torch.models.config import ModelConfig


class P(tuple):
    """A partition spec: ``P("data", None)`` is ``("data", None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True
    dp_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    model_axis_size: int = 16
    dp_sizes: Tuple[int, ...] = (16,)   # aligned with dp_axes
    # shard experts' big dims over data (FSDP) as well
    shard_moe_fsdp: bool = True
    # sequence-parallel residual stream: activations (B,S,D) keep S sharded
    # over the model axis between layers
    seq_parallel_acts: bool = False
    # 2D expert parallelism: expert Fv stays sliced over data inside the
    # expert-parallel MoE (tokens gathered instead of weights)
    moe_tp_over_dp: bool = False
    # model-dim-sharded residual stream (RWKV)
    act_shard_d: bool = False

    @property
    def fsdp_axis(self):
        return self.dp_axes if self.fsdp else None

    def axis_size(self, entry) -> int:
        """Product of mesh-axis sizes for one spec entry."""
        if entry is None:
            return 1
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        sizes = dict(zip(self.dp_axes, self.dp_sizes))
        sizes[self.model_axis] = self.model_axis_size
        n = 1
        for a in names:
            n *= sizes.get(a, 1)
        return n


def _param_rule(owner: str, name: str, pol: ShardingPolicy) -> Optional[P]:
    M, F = pol.model_axis, pol.fsdp_axis
    moe_f = F if pol.shard_moe_fsdp else None
    col2 = P(F, M)           # (in, out): out over model, in over fsdp
    row2 = P(M, F)           # (in, out): in over model
    table = {
        ("top", "embed"): P(M, F),
        ("top", "lm_head"): P(F, M),
        ("mixer", "wq"): col2,
        ("mixer", "wk"): col2,
        ("mixer", "wv"): col2,
        ("mixer", "wg"): col2,
        ("mixer", "wr"): col2,
        ("mixer", "wo"): row2,
        ("mixer", "bq"): P(M),
        ("mixer", "bk"): P(M),
        ("mixer", "bv"): P(M),
        ("mixer", "in_proj"): col2,
        ("mixer", "out_proj"): row2,
        ("mixer", "x_proj"): P(M, None),
        ("mixer", "dt_proj"): P(None, M),
        ("mixer", "dt_bias"): P(M),
        ("mixer", "conv_w"): P(None, M),
        ("mixer", "conv_b"): P(M),
        ("mixer", "A_log"): P(M, None),
        ("mixer", "D"): P(M),
        # RWKV DDLoRA weights are tiny: replicated
        ("mixer", "mix_w1"): P(),
        ("mixer", "mix_w2"): P(),
        ("mixer", "decay_w2"): P(),
        ("mlp", "gate"): col2,
        ("mlp", "up"): col2,
        ("mlp", "down"): row2,
        ("mlp", "wk"): col2,
        ("mlp", "wv"): row2,
        ("mlp", "wr"): col2,
        ("mlp", "router"): P(F, None),
        # MoE expert weights (V, D, Fv) / (V, Fv, D): experts over model.
        # tp_over_dp slices Fv over data (the expert-parallel layer's own
        # layout); otherwise FSDP goes on the other dim.
        ("mlp", "moe_up"): P(M, None, moe_f) if pol.moe_tp_over_dp
        else P(M, moe_f, None),
        ("mlp", "moe_gate"): P(M, None, moe_f) if pol.moe_tp_over_dp
        else P(M, moe_f, None),
        ("mlp", "moe_down"): P(M, moe_f, None) if pol.moe_tp_over_dp
        else P(M, None, moe_f),
    }
    return table.get((owner, name))


def _leaf_spec(name: str, leaf, owner: str, under_units: bool,
               pol: ShardingPolicy) -> P:
    lead = (None,) if under_units else ()
    ndim = len(leaf.shape)
    base = ndim - len(lead)
    is_moe = owner == "mlp" and name in ("up", "gate", "down") and base == 3
    key = f"moe_{name}" if is_moe else name
    spec = _param_rule(owner, key, pol)
    if spec is None or len(spec) > base:
        spec = P()  # replicate (norms, small vectors, unknown leaves)
    parts = lead + tuple(spec) + (None,) * (base - len(spec))
    parts = parts[:ndim]
    # divisibility guard: drop sharding on dims the mesh axis doesn't divide
    # (e.g. HuBERT's 504-class head on a 16-way model axis)
    shape = leaf.shape
    return P(*(e if shape[i] % pol.axis_size(e) == 0 else None
               for i, e in enumerate(parts)))


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replicated(v) for v in tree)
    return P()


def _walk_layer(layer: dict, pol: ShardingPolicy, under_units: bool) -> dict:
    out = {}
    for part, sub in layer.items():
        if part in ("mixer", "mlp"):
            out[part] = {
                name: (_replicated(leaf) if isinstance(leaf, dict)
                       else _leaf_spec(name, leaf, part, under_units, pol))
                for name, leaf in sub.items()
            }
        else:  # norm1 / norm2
            out[part] = _replicated(sub)
    return out


def param_pspecs(cfg: ModelConfig, params: dict, pol: ShardingPolicy) -> dict:
    """A spec tree matching ``params`` (tensors, ``meta`` tensors included:
    only shapes are read)."""
    out = {}
    for k, v in params.items():
        if k == "units":
            out[k] = tuple(_walk_layer(lp, pol, True) for lp in v)
        elif k == "tail":
            out[k] = tuple(_walk_layer(lp, pol, False) for lp in v)
        elif isinstance(v, dict):
            out[k] = _replicated(v)
        else:
            out[k] = _leaf_spec(k, v, "top", False, pol)
    return out


# ----------------------------------------------------------------------------
# batch / cache specs
# ----------------------------------------------------------------------------


def batch_pspecs(cfg: ModelConfig, pol: ShardingPolicy, *, batch_sharded: bool):
    from repro_torch.models.transformer import Batch

    dp = pol.dp_axes if batch_sharded else None
    pos = P(None, dp, None) if cfg.rope == "mrope" else P(dp, None)
    return Batch(
        tokens=None if cfg.frontend == "audio" else P(dp, None),
        embeds=P(dp, None, None) if cfg.frontend else None,
        embed_mask=P(dp, None) if cfg.frontend else None,
        positions=pos,
        targets=P(dp, None),
        loss_mask=P(dp, None),
    )


def cache_leaf_specs(cfg: ModelConfig, pol: ShardingPolicy,
                     *, batch_sharded: bool) -> dict:
    """Spec of each decode-cache leaf of one layer, by leaf name (a leaf
    under the stacked ``units`` takes a leading None besides).

    attn k/v (B, L, Kv, hd): batch over dp; kv-heads over model when
    divisible by the model axis, else the sequence axis takes the model
    axis.  batch=1: sequence over data (+ model when kv heads don't
    shard).  Mamba conv (B, dc-1, din) and ssm (B, din, ds): d_inner over
    model; RWKV wkv (B, H, dh, dh): heads over model when they divide it;
    token shifts (B, D): batch only."""
    M = pol.model_axis
    msize = pol.model_axis_size
    dp = pol.dp_axes if batch_sharded else None
    kv_over_model = cfg.num_kv_heads % msize == 0 and cfg.num_kv_heads > 0
    rwkv_heads = cfg.d_model // max(cfg.rwkv_head_dim, 1)
    h_over_model = rwkv_heads % msize == 0

    if batch_sharded:
        seq_axes = M if not kv_over_model else None
    else:
        seq_axes = ("data", M) if not kv_over_model else ("data",)
    kv = P(dp, seq_axes, M if kv_over_model else None, None)
    return {
        "k": kv,
        "v": kv,
        "pos": P(dp, seq_axes),
        "conv": P(dp, None, M),
        "ssm": P(dp, M, None),
        "shift": P(dp, None),
        "wkv": P(dp, M if h_over_model else None, None, None),
    }


def cache_pspecs(cfg: ModelConfig, cache, pol: ShardingPolicy,
                 *, batch_sharded: bool):
    """Specs for the decode cache tree: ``cache_leaf_specs`` by leaf
    name, a leading None under ``units``; any other leaf replicated."""
    by_name = cache_leaf_specs(cfg, pol, batch_sharded=batch_sharded)

    def leaf_spec(names, leaf):
        lead = (None,) if "units" in names else ()
        spec = by_name.get(names[-1])
        if spec is not None:
            return P(*lead, *spec)
        base = len(leaf.shape) - len(lead)
        return P(*lead, *([None] * base))

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, names + (str(i),))
                              for i, v in enumerate(tree))
        return leaf_spec(names, tree)

    return walk(cache, ())


class DecodeSpecs(NamedTuple):
    """The decode step's other inputs and outputs (the reference dry
    run's ``in_shardings`` / ``out_shardings``)."""

    tokens: P                      # (B, 1)
    position: P                    # (B,)
    mrope_position: Optional[P]    # (3, B, 1); None without M-RoPE
    next_token: P                  # (B, 1)
    logits: P                      # (B, 1, V)


def decode_pspecs(cfg: ModelConfig, pol: ShardingPolicy,
                  *, batch_sharded: bool) -> DecodeSpecs:
    dp = pol.dp_axes if batch_sharded else None
    return DecodeSpecs(
        tokens=P(dp, None),
        position=P(dp),
        mrope_position=P(None, dp, None) if cfg.rope == "mrope" else None,
        next_token=P(dp, None),
        logits=P(dp, None, pol.model_axis),
    )


# ----------------------------------------------------------------------------
# specs -> DTensor placements
# ----------------------------------------------------------------------------


def map_specs(fn, tree: Any, *rest: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree (``P`` and None are leaves;
    dicts, tuples, lists and named tuples are walked)."""
    if tree is None or isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def placements(mesh, spec: Optional[P]) -> tuple:
    """One DTensor placement per mesh dimension: ``Shard(i)`` where the
    mesh axis names entry ``i`` of ``spec``, else ``Replicate()``.  An
    entry naming several axes shards that dimension over each, major to
    minor in mesh order (JAX's order for a tuple in mesh order).  A mesh
    dimension of size 1 holds every tensor whole: ``Replicate()`` (some
    PyTorch versions refuse to view a dimension "split" one way)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis, size in zip(mesh.mesh_dim_names, mesh.shape):
        dim = None
        for i, e in enumerate(spec or ()):
            names = e if isinstance(e, (tuple, list)) else (e,)
            if axis in names:
                dim = i
        out.append(Shard(dim) if dim is not None and size > 1
                   else Replicate())
    return tuple(out)


def spec_axes(spec) -> set:
    """The mesh axes a spec names."""
    out = set()
    for e in spec:
        if e is not None:
            out.update(e if isinstance(e, (tuple, list)) else (e,))
    return out


def named(mesh, spec_tree):
    """The spec tree as DTensor placements on ``mesh`` (a spec of None
    stays None)."""
    return map_specs(lambda s: None if s is None else placements(mesh, s),
                     spec_tree)


def distribute(tree, mesh, spec_tree):
    """``tree``'s tensors as DTensors on ``mesh`` laid out by
    ``spec_tree``.  Every rank holds the whole tree (the same seed) and
    keeps its own shard.  A one-device mesh without a process group
    (``launch.mesh.LocalMesh``) leaves the tree as it is."""
    if getattr(mesh, "is_local", False):
        return tree
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(spec, t):
        if t is None:
            return None
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements(mesh, spec))
        return distribute_tensor(t, mesh, placements(mesh, spec))

    return map_specs(one, spec_tree, tree)


# ----------------------------------------------------------------------------
# round-engine specs (the BFLC sharded stages, repro_torch.fl.sharded)
# ----------------------------------------------------------------------------


def round_engine_pspecs() -> dict:
    """* ``clients``    — client-stacked leaves (P, ...): P split (local
      training batches in, update stacks out);
    * ``dshard``     — (K, Dpad) int8 stack and (K, nblk) scales: D split
      (each rank quantizes / reduces its slice);
    * ``dvec``       — (Dpad,) aggregated flat update: D split (gathered
      into the model block);
    * ``replicated`` — global params and the (K,) weight vector."""
    return {"clients": 0, "dshard": 1, "dvec": 0, "replicated": None}


def score_matrix_pspecs() -> dict:
    """* ``updates``    — candidate-stacked leaves (P, ...): P split (the
      update rows arrive split from the trainer);
    * ``int8_rows``  — (P, Dpad) int8 rows + (P, nblk) scales of the fused
      score-from-int8 path: P split (tiles are row-local, so the blobs
      equal the single-device codec's);
    * ``scores``     — the (P, Q) score matrix: P split, gathered at the
      validate stage's boundary;
    * ``replicated`` — global params and the (Q, vb, ...) member val
      batches."""
    return {"updates": 0, "int8_rows": 0, "scores": 0, "replicated": None}
