"""The vocabulary on a mesh: the embedding lookup and the greedy pick as
local maps over each rank's block of the vocabulary
(``shardctx.vocab_lookup``, ``shardctx.vocab_argmax``).

* On 8 gloo ranks (``spawn_world``, ``make_host_mesh(2, 4)``, one world
  for every case) against the reference's ``embed_inputs`` jitted on its
  (2, 4) host mesh, the table laid out by ``param_pspecs`` (V over model,
  D over data under FSDP) and the tokens by ``batch_pspecs`` (a batch of
  one whole on every rank, a batch of 8 over data): olmo-1b and gemma3-4b
  smoke (gemma3 scales the embeddings), at B = 1 and B = 8, with and
  without FSDP.  Every token batch holds duplicates, within a rank and
  across the data ranks, and tokens on both sides of each vocabulary
  block's edge.
  - The forward equals the reference's at atol 0: each output row is one
    real row plus zeros.
  - The table's gradient (the lookup's output times a seeded cotangent,
    summed) equals ``jax.grad``'s within GRAD_STEPS float32 steps at its
    largest entry: a row's cotangents may add in another order where a
    token repeats.
  - The result is laid out as the tokens are, the gradient as the table.
* The greedy pick over (B, V) logits split over model against
  ``jnp.argmax`` on the reference's mesh: ties inside a block, across
  two neighbouring blocks (the lowest index wins) and across blocks far
  apart, at B = 1 and B = 8.
* ``_pick_largest`` in one process against ``torch.argmax`` on rows with
  ties and NaNs.

The rank functions live in this module, which imports neither ``jax``
nor ``repro`` at its top.
"""
import numpy as np
import pytest
import torch

from repro_torch.hostdevices import spawn_world

torch.set_num_threads(1)
DATA, MODEL = 2, 4
SEQ = 16
# the table's gradient within GRAD_STEPS float32 steps at its largest entry
# (4.7 to 149 here): a token's cotangents may add in another order (none
# did on torch 2.13 on the CPU: equal bit for bit)
GRAD_STEPS = 4

ARCHS = ("olmo-1b", "gemma3-4b")
CASES = [(arch, rows, fsdp) for arch in ARCHS for rows in (1, 8)
         for fsdp in (True, False)]
CASE_IDS = [f"{a}-B{b}-{'fsdp' if f else 'nofsdp'}" for a, b, f in CASES]

# name -> (rows, {(row, column): value}) on (rows, V) normal logits
ARGMAX = {
    "tie_straddles_blocks": (1, {(0, 255): 9.0, (0, 256): 9.0}),
    "tie_far_apart": (1, {(0, 900): 7.5, (0, 300): 7.5}),
    "tie_in_one_block": (1, {(0, 600): 6.0, (0, 520): 6.0}),
    "rows_of_8": (8, {(0, 767): 8.0, (0, 768): 8.0, (3, 1023): 8.0,
                      (3, 0): 8.0, (5, 17): 8.0, (6, 512): 8.0}),
}


def _vocab(arch):
    from repro_torch.configs import registry

    cfg = registry.smoke_config(arch)
    return cfg.vocab_size, cfg.d_model


def _tokens(vocab, rows, seed):
    """Tokens with duplicates (a pool of four drawn over and over) and
    the edges of the model axis's vocabulary blocks."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (rows, SEQ))
    block = vocab // MODEL
    pool = np.array([0, block - 1, block, vocab - 1])
    dup = rng.random((rows, SEQ)) < 0.4
    tok[dup] = rng.choice(pool, dup.sum())
    return tok.astype(np.int32)


def _inputs():
    tables, cases, argmax = {}, {}, {}
    for i, arch in enumerate(ARCHS):
        V, D = _vocab(arch)
        tables[arch] = np.random.default_rng(20 + i).standard_normal(
            (V, D)).astype(np.float32)
    for i, (arch, rows, fsdp) in enumerate(CASES):
        V, D = _vocab(arch)
        cases[CASE_IDS[i]] = dict(
            tokens=_tokens(V, rows, 30 + i),
            cot=np.random.default_rng(40 + i).standard_normal(
                (rows, SEQ, D)).astype(np.float32))
    V = _vocab("olmo-1b")[0]
    for i, (name, (rows, marks)) in enumerate(ARGMAX.items()):
        logits = np.random.default_rng(50 + i).standard_normal(
            (rows, V)).astype(np.float32)
        for where, v in marks.items():
            logits[where] = v
        argmax[name] = logits
    return dict(tables=tables, cases=cases, argmax=argmax)


# ----------------------------------------------------------------------------
# the port's ranks
# ----------------------------------------------------------------------------


def _pol(fsdp):
    from repro_torch.launch.shardings import ShardingPolicy

    return ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                          model_axis_size=MODEL, fsdp=fsdp)


def _lookup(mesh, arch, rows, fsdp, table_np, case):
    from repro_torch.configs import registry
    from repro_torch.launch.shardings import (
        P,
        batch_pspecs,
        distribute,
        param_pspecs,
        placements,
    )
    from repro_torch.models.shardctx import mesh_scope
    from repro_torch.models.transformer import Batch, embed_inputs

    cfg = registry.smoke_config(arch)
    pol = _pol(fsdp)
    tree = {"embed": torch.from_numpy(table_np)}
    spec = param_pspecs(cfg, tree, pol)["embed"]
    table = distribute(tree, mesh, {"embed": spec})["embed"]
    table.requires_grad_(True)
    tspec = batch_pspecs(cfg, pol, batch_sharded=rows > 1).tokens
    tokens = distribute(torch.from_numpy(case["tokens"]), mesh, tspec)
    cot = distribute(torch.from_numpy(case["cot"]), mesh, P(*tspec, None))
    with mesh_scope(mesh):
        out = embed_inputs({"embed": table}, cfg, Batch(tokens=tokens))
        (grad,) = torch.autograd.grad((out * cot).sum(), table)
        grad = grad.redistribute(mesh, table.placements)
    return dict(out=out.detach().full_tensor().numpy(),
                out_placed=tuple(out.placements) == placements(mesh, tspec),
                grad=grad.full_tensor().numpy(),
                grad_local=tuple(grad.to_local().shape),
                table_local=tuple(table.to_local().shape))


def _argmax(mesh, logits_np):
    from repro_torch.launch.shardings import P, distribute, placements
    from repro_torch.models.shardctx import vocab_argmax

    rows = logits_np.shape[0]
    spec = P("data" if rows > 1 else None, "model")
    tok = vocab_argmax(distribute(torch.from_numpy(logits_np), mesh, spec))
    return dict(tokens=tok.full_tensor().numpy(),
                placed=tuple(tok.placements) == placements(mesh, P(spec[0])))


def _rank_world8(inputs):
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    mesh = make_host_mesh(DATA, MODEL, device="cpu")
    out = {}
    for cid, (arch, rows, fsdp) in zip(CASE_IDS, CASES):
        out[cid] = _lookup(mesh, arch, rows, fsdp, inputs["tables"][arch],
                           inputs["cases"][cid])
    for name, logits in inputs["argmax"].items():
        out[name] = _argmax(mesh, logits)
    out["metered"] = _metered_decode(mesh)
    return out


def _metered_decode(mesh):
    """One decode step of olmo-1b smoke at B = 1 under ``CollectiveMeter``
    (real tensors, gloo): the collectives by kind, the largest, and the
    table's bytes."""
    from repro_torch.configs import registry
    from repro_torch.launch.hlo_stats import CollectiveMeter
    from repro_torch.launch.shardings import distribute, param_pspecs
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import init_cache, init_model

    cfg = registry.smoke_config("olmo-1b")
    pol = _pol(True)
    params = init_model(torch.Generator().manual_seed(0), cfg)
    params = distribute(params, mesh, param_pspecs(cfg, params, pol))
    cache = init_cache(cfg, 1, SEQ, torch.float32, mesh=mesh, pol=pol,
                       batch_sharded=False)
    step = make_decode_step(cfg, mesh, pol, batch_sharded=False)
    zeros = torch.zeros((1, 1), dtype=torch.int32)
    with torch.no_grad(), CollectiveMeter() as meter:
        tok, _, _ = step(params, zeros, zeros[:, 0], cache)
    table = params["embed"]
    return dict(stats=meter.stats, token=int(tok.full_tensor()[0, 0]),
                table_bytes=table.numel() * table.element_size())


# ----------------------------------------------------------------------------
# the reference on its (2, 4) host mesh
# ----------------------------------------------------------------------------


def _reference(inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shardings import ShardingPolicy, batch_pspecs, param_pspecs
    from repro.models.transformer import Batch, embed_inputs

    mesh = make_host_mesh(DATA, MODEL)
    out = {}
    for cid, (arch, rows, fsdp) in zip(CASE_IDS, CASES):
        cfg = jreg.smoke_config(arch)
        pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                             model_axis_size=MODEL, fsdp=fsdp)
        table = inputs["tables"][arch]
        tsh = NamedSharding(mesh, param_pspecs(cfg, {"embed": table},
                                               pol)["embed"])
        tspec = batch_pspecs(cfg, pol, batch_sharded=rows > 1).tokens
        ksh = NamedSharding(mesh, tspec)
        csh = NamedSharding(mesh, JP(*tspec, None))

        def embed(t, tok):
            return embed_inputs({"embed": t}, cfg, Batch(tokens=tok))

        case = inputs["cases"][cid]
        args = (jax.device_put(jnp.asarray(table), tsh),
                jax.device_put(jnp.asarray(case["tokens"]), ksh))
        fwd = jax.jit(embed, in_shardings=(tsh, ksh))(*args)
        grad = jax.jit(jax.grad(lambda t, tok, c: jnp.sum(embed(t, tok) * c)),
                       in_shardings=(tsh, ksh, csh))(
            *args, jax.device_put(jnp.asarray(case["cot"]), csh))
        out[cid] = dict(out=np.asarray(fwd), grad=np.asarray(grad))
    for name, logits in inputs["argmax"].items():
        rows = logits.shape[0]
        sh = NamedSharding(mesh, JP("data" if rows > 1 else None, "model"))
        out[name] = np.asarray(jax.jit(lambda z: jnp.argmax(z, axis=-1).astype(
            jnp.int32), in_shardings=(sh,))(jax.device_put(logits, sh)))
    return out


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    w8 = spawn_world(8, _rank_world8, inputs, timeout=600)
    return inputs, w8, _reference(inputs)


@pytest.mark.parametrize("cid", CASE_IDS)
def test_lookup_forward_equals_reference(runs, cid):
    inputs, w8, ref = runs
    arch, rows, fsdp = CASES[CASE_IDS.index(cid)]
    want = ref[cid]["out"]
    assert want.shape == (rows, SEQ, _vocab(arch)[1])
    for rank, res in enumerate(w8):
        np.testing.assert_array_equal(res[cid]["out"], want,
                                      err_msg=f"rank {rank}")
        assert res[cid]["out_placed"], rank


@pytest.mark.parametrize("cid", CASE_IDS)
def test_lookup_table_gradient_matches_reference(runs, cid):
    inputs, w8, ref = runs
    arch, rows, fsdp = CASES[CASE_IDS.index(cid)]
    V, D = _vocab(arch)
    want = ref[cid]["grad"]
    tokens = inputs["cases"][cid]["tokens"]
    # the case holds duplicates, and rows no token touches stay zero
    assert len(np.unique(tokens)) < tokens.size
    untouched = np.setdiff1d(np.arange(V), tokens)
    assert untouched.size and not want[untouched].any()
    block = (V // MODEL, D // DATA if fsdp else D)
    atol = GRAD_STEPS * float(np.spacing(np.abs(want).max()))
    for rank, res in enumerate(w8):
        got = res[cid]
        np.testing.assert_allclose(got["grad"], want, rtol=0, atol=atol,
                                   err_msg=f"rank {rank}")
        assert not got["grad"][untouched].any(), rank
        # the table and its gradient are each rank's block, never the whole
        assert got["table_local"] == got["grad_local"] == block, rank


@pytest.mark.parametrize("name", list(ARGMAX))
def test_vocab_argmax_equals_jnp_argmax(runs, name):
    inputs, w8, ref = runs
    rows, marks = ARGMAX[name]
    want = ref[name]
    np.testing.assert_array_equal(
        want, np.argmax(inputs["argmax"][name], axis=-1))
    if name == "tie_straddles_blocks":
        assert want.tolist() == [255]     # the last of block 0, not 256
    for rank, res in enumerate(w8):
        np.testing.assert_array_equal(res[name]["tokens"], want,
                                      err_msg=f"rank {rank}")
        assert res[name]["placed"], rank


def test_pick_largest_breaks_ties_low_and_counts_nan_largest():
    from repro_torch.models.shardctx import _pick_largest

    nan, inf = float("nan"), float("inf")
    vals = torch.tensor([[1.0, 5.0, inf, nan, 2.0, nan],
                         [3.0, 5.0, 0.0, 1.0, nan, 4.0],
                         [3.0, 4.0, inf, 9.0, 2.0, nan]])
    idxs = torch.tensor([[10, 40, 7, 3, 0, 11],
                         [20, 30, 8, 4, 1, 12],
                         [5, 50, 2, 5, 2, 13]], dtype=torch.int32)
    val, idx = _pick_largest(vals, idxs)
    assert idx.tolist() == [5, 30, 2, 3, 1, 11]
    # the same pick as torch.argmax over the blocks laid end to end
    for b in range(vals.shape[1]):
        row = torch.full((60,), -inf)
        row[idxs[:, b].long()] = vals[:, b]
        assert int(torch.argmax(row)) == idx[b], b
    assert val[3].isnan() and val[2] == inf


def test_collective_meter_sees_the_decode_steps_collectives(runs):
    """``CollectiveMeter`` on real gloo ranks: the batch-1 decode step's
    collectives are counted (the lookup's and the attention merge's
    all-reduces, the argmax's all-gathers), and none is as large as the
    table."""
    _, w8, _ = runs
    for rank, res in enumerate(w8):
        got = res["metered"]
        stats = got["stats"]
        assert stats.count_by_kind.get("all-reduce", 0) > 0, rank
        assert stats.count_by_kind.get("all-gather", 0) >= 2, rank
        assert max(stats.largest_by_kind.values()) < got["table_bytes"], rank
        assert got["token"] == w8[0]["metered"]["token"], rank
