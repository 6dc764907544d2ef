"""The decode state on a mesh: the KV cache and the recurrent states
sharded as ``cache_pspecs`` lays them out, through the steps and the
serve engine.

* On 8 gloo ranks (``spawn_world``, ``make_host_mesh(2, 4)``, one world
  for every case) against the reference's jitted prefill and decode on
  its (2, 4) host mesh, one smoke config per cache branch: olmo-1b (KV
  heads over model), mixtral-8x7b (the sequence over model; a 40-token
  prompt past its 32-token window, so the prefill keeps the last 32 in
  the ring and decode wraps it across the ranks' blocks), gemma3-4b (the
  sequence over model; its 16-token local window wraps during decode and
  its global cache of 22 slots splits unevenly, 6 / 6 / 6 / 4),
  jamba-1.5-large-398b (attention with the sequence over model, Mamba
  ``conv`` / ``ssm`` with d_inner over model), rwkv6-7b (``wkv`` heads
  over model) and gemma3-4b at batch 1 (the sequence over data and
  model: 16 local slots 2 a rank, 22 global ones 3 / 3 / 3 / 2 a data
  half).  Tokens equal the reference's, logits within 1e-4 (the merge
  of a sequence split over ranks sums in another order), and after the
  prefill and after the last decode step every rank's cache leaf is a
  DTensor in ``placements(mesh, cache_pspecs(...))``, its local block the
  shape of its share (torch's blocks: the first ranks take the extra
  rows) and never the whole leaf.  The decode step's tokens and
  positions go in as DTensors by ``decode_pspecs``, and its next token
  and logits come back laid out by it.
* ``shardctx.softmax_merge`` in one process (four ranks simulated by
  threads) against the whole row's softmax, with a shard whose slots
  are all masked, a row masked everywhere, and a logit softcap.
* ``ServeEngine`` on gloo world 2, olmo-1b smoke at (2, 1) (slots over
  data) and mixtral-8x7b smoke at (1, 2) (KV heads over model, MoE
  expert-parallel at a capacity factor of its expert count, so no token
  drops on either side), against the ``LocalMesh`` engine on the same
  ``VirtualClock`` trace: the same served tokens, and the cache stays a
  DTensor in its layout.

The reference's params are carried across with
``repro_torch.convert.from_numpy_tree``.  The rank functions live in
this module, which imports neither ``jax`` nor ``repro`` at its top.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.hostdevices import spawn_world

torch.set_num_threads(1)
DATA, MODEL = 2, 4
LOGIT_ATOL = 1e-4

# name -> (arch, rows, prompt, generated, max_len, batch_sharded, fsdp)
CASES = {
    "olmo-1b": ("olmo-1b", 4, 8, 4, 16, True, True),
    "mixtral-8x7b": ("mixtral-8x7b", 4, 40, 6, 48, True, False),
    "gemma3-4b": ("gemma3-4b", 4, 12, 10, 22, True, True),
    "jamba": ("jamba-1.5-large-398b", 4, 8, 4, 16, True, False),
    "rwkv6-7b": ("rwkv6-7b", 4, 8, 4, 16, True, True),
    "gemma3-4b-batch1": ("gemma3-4b", 1, 12, 10, 22, False, True),
}


def _prompt(vocab, rows, seq, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (rows, seq)).astype(np.int32)


def _inputs():
    import jax

    from repro.configs import registry as jreg
    from repro.models import init_model as j_init

    params, prompts = {}, {}
    for i, (name, (arch, rows, seq, *_)) in enumerate(CASES.items()):
        if arch not in params:
            cfg = jreg.smoke_config(arch)
            params[arch] = jax.tree.map(
                np.asarray, j_init(jax.random.PRNGKey(3), cfg))
        prompts[name] = _prompt(jreg.smoke_config(arch).vocab_size, rows, seq,
                                10 + i)
    return dict(params=params, prompts=prompts)


# ----------------------------------------------------------------------------
# the port's ranks
# ----------------------------------------------------------------------------


def _pol(data, model, fsdp):
    from repro_torch.launch.shardings import ShardingPolicy

    return ShardingPolicy(dp_axes=("data",), dp_sizes=(data,),
                          model_axis_size=model, fsdp=fsdp)


def _block(mesh, spec, shape):
    """This rank's block shape of a tensor of ``shape`` laid out by
    ``spec``, by torch.chunk's blocks over each named axis in mesh order
    (independent of the port's ``shard_range``)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for n, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        for axis in mesh.mesh_dim_names:          # mesh order
            if axis in names and sizes[axis] > 1:
                blocks = torch.arange(n).chunk(sizes[axis])
                n = len(blocks[coord[axis]]) if coord[axis] < len(blocks) else 0
        out.append(n)
    return tuple(out)


def _layout(cfg, cache, mesh, pol, batch_sharded):
    """For each cache leaf: (placements as expected, local shape = its
    share, sharded somewhere, local numel below the whole's)."""
    from repro_torch.launch.shardings import (
        cache_pspecs,
        map_specs,
        placements,
        spec_axes,
    )
    from repro_torch.models.shardctx import is_dtensor

    rows = []

    def check(spec, leaf):
        assert is_dtensor(leaf), spec
        local = tuple(leaf.to_local().shape)
        split = any(mesh.shape[mesh.mesh_dim_names.index(a)] > 1
                    for a in spec_axes(spec))
        rows.append((str(spec), tuple(leaf.placements) == placements(mesh, spec),
                     local == _block(mesh, spec, tuple(leaf.shape)), split,
                     leaf.to_local().numel() < leaf.numel()))

    map_specs(check, cache_pspecs(cfg, cache, pol,
                                  batch_sharded=batch_sharded), cache)
    return rows


def _serve_mesh(name, params_np, prompt):
    from repro_torch.configs import registry
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import (
        batch_pspecs,
        decode_pspecs,
        distribute,
        param_pspecs,
        placements,
    )
    from repro_torch.models.shardctx import whole
    from repro_torch.models.transformer import Batch

    arch, rows, seq, gen, max_len, bs, fsdp = CASES[name]
    cfg = registry.smoke_config(arch)
    mesh = make_host_mesh(DATA, MODEL, device="cpu")
    pol = _pol(DATA, MODEL, fsdp)
    p = distribute(from_numpy_tree(params_np), mesh,
                   param_pspecs(cfg, from_numpy_tree(params_np), pol))
    batch = Batch(tokens=torch.from_numpy(prompt),
                  positions=torch.arange(seq, dtype=torch.int32)[None]
                  .expand(rows, seq).contiguous())
    bspec = batch_pspecs(cfg, pol, batch_sharded=bs)._replace(
        embeds=None, embed_mask=None, targets=None, loss_mask=None)
    dspec = decode_pspecs(cfg, pol, batch_sharded=bs)
    prefill = tsteps.make_prefill_step(cfg, mesh, pol, max_len=max_len,
                                       batch_sharded=bs)
    decode = tsteps.make_decode_step(cfg, mesh, pol, batch_sharded=bs)
    outputs = []
    with torch.no_grad():
        logits, cache = prefill(p, distribute(batch, mesh, bspec))
        layout = {"prefill": _layout(cfg, cache, mesh, pol, bs)}
        tok = torch.argmax(whole(logits)[:, -1], -1).to(torch.int32)[:, None]
        toks, seen = [tok], [whole(logits)[:, -1]]
        for i in range(gen - 1):
            pos = torch.full((rows,), seq + i, dtype=torch.int32)
            tok, logits, cache = decode(p, distribute(tok, mesh, dspec.tokens),
                                        distribute(pos, mesh, dspec.position),
                                        cache)
            outputs.append((tuple(tok.placements)
                            == placements(mesh, dspec.next_token),
                            tuple(logits.placements)
                            == placements(mesh, dspec.logits)))
            tok = whole(tok)
            toks.append(tok)
            seen.append(whole(logits)[:, -1])
        layout["decode"] = _layout(cfg, cache, mesh, pol, bs)
    return dict(tokens=torch.cat(toks, 1).numpy(),
                logits=torch.stack(seen, 1).numpy(), layout=layout,
                outputs=outputs)


def _rank_world8(inputs):
    torch.set_num_threads(1)
    return {name: _serve_mesh(name, inputs["params"][CASES[name][0]],
                              inputs["prompts"][name])
            for name in CASES}


# the engine on gloo world 2: arch -> ((data, model), config overrides)
ENGINE = {"olmo-1b": ((2, 1), {}),
          "mixtral-8x7b": ((1, 2), {"moe_capacity_factor": 8.0})}


def _engine_requests(vocab):
    from repro_torch.serve import Request

    rng = np.random.default_rng(7)
    lens = [(6, 5), (30, 8), (9, 3), (12, 7), (25, 6), (5, 2), (17, 4)]
    return [Request(rid=i, prompt=rng.integers(0, vocab, (s,)).astype(np.int32),
                    max_new=g, arrival=0.5 * i)
            for i, (s, g) in enumerate(lens)]


def _rank_engine(inputs):
    from repro_torch.configs import registry
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.shardctx import is_dtensor
    from repro_torch.serve import ServeEngine, VirtualClock

    torch.set_num_threads(1)
    out = {}
    for arch, ((data, model), over) in ENGINE.items():
        cfg = registry.smoke_config(arch).replace(**over)
        params = from_numpy_tree(inputs["params"][arch])
        reqs = _engine_requests(cfg.vocab_size)
        served = []
        for mesh, pol in ((make_host_mesh(data, model, device="cpu"),
                           _pol(data, model, False)), (None, None)):
            eng = ServeEngine(cfg, params, num_slots=4, max_len=40, mesh=mesh,
                              pol=pol, device="cpu")
            rep = eng.run(reqs, clock=VirtualClock())
            served.append({r.rid: list(r.tokens) for r in rep.results})
            if mesh is not None:
                tokens, positions, cache = eng._fresh_state()
                leaf = cache["units"][0]["k"]
                out[arch + "_state"] = (is_dtensor(tokens), is_dtensor(leaf),
                                        tuple(leaf.to_local().shape),
                                        tuple(leaf.shape))
        out[arch] = served
    return out


# ----------------------------------------------------------------------------
# the reference on its (2, 4) host mesh
# ----------------------------------------------------------------------------


def _reference(inputs):
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shardings import ShardingPolicy, named, param_pspecs
    from repro.models.transformer import Batch

    mesh = make_host_mesh(DATA, MODEL)
    out = {}
    for name, (arch, rows, seq, gen, max_len, bs, fsdp) in CASES.items():
        cfg = jreg.smoke_config(arch)
        pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                             model_axis_size=MODEL, fsdp=fsdp)
        pnp = inputs["params"][arch]
        p = jax.device_put(jax.tree.map(jnp.asarray, pnp),
                           named(mesh, param_pspecs(cfg, pnp, pol)))
        prefill = jax.jit(jsteps.make_prefill_step(cfg, mesh, pol, max_len,
                                                   batch_sharded=bs))
        decode = jax.jit(jsteps.make_decode_step(cfg, mesh, pol,
                                                 batch_sharded=bs))
        batch = Batch(tokens=jnp.asarray(inputs["prompts"][name]),
                      positions=jnp.broadcast_to(
                          jnp.arange(seq, dtype=jnp.int32)[None], (rows, seq)))
        logits, cache = prefill(p, batch)
        tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
        toks, seen = [tok], [logits[:, -1]]
        for i in range(gen - 1):
            pos = jnp.full((rows,), seq + i, jnp.int32)
            tok, logits, cache = decode(p, tok, pos, cache)
            toks.append(tok)
            seen.append(logits[:, -1])
        out[name] = dict(tokens=np.asarray(jnp.concatenate(toks, 1)),
                         logits=np.asarray(jnp.stack(seen, 1)))
    return out


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures

    inputs = _inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w8 = pool.submit(spawn_world, 8, _rank_world8, inputs, timeout=600)
        w2 = pool.submit(spawn_world, 2, _rank_engine, inputs, timeout=600)
        ref = _reference(inputs)
        return w8.result(), w2.result(), ref


# ----------------------------------------------------------------------------
# the sharded steps against the reference's
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_matches_reference(runs, name):
    w8, _, ref = runs
    for rank, res in enumerate(w8):
        got = res[name]
        np.testing.assert_array_equal(got["tokens"], ref[name]["tokens"],
                                      err_msg=f"rank {rank}")
        np.testing.assert_allclose(got["logits"], ref[name]["logits"], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"rank {rank}")
        # the next token and the logits come back by decode_pspecs
        assert got["outputs"] and all(all(o) for o in got["outputs"]), rank


@pytest.mark.parametrize("name", list(CASES))
def test_cache_leaves_are_each_ranks_share(runs, name):
    w8, _, _ = runs
    for rank, res in enumerate(w8):
        for when, rows in res[name]["layout"].items():
            assert rows, (rank, when)
            for spec, placed, block, split, partial in rows:
                where = f"rank {rank} {when} {spec}"
                assert placed, where
                assert block, where
                # every leaf the spec splits over a mesh axis of 2 or more
                # is a block of the whole, never the whole
                assert partial or not split, where
            # the attention and state leaves are all split somewhere
            assert all(split for _, _, _, split, _ in rows), (rank, when)


# ----------------------------------------------------------------------------
# the merge
# ----------------------------------------------------------------------------


def _threaded_reduce(n):
    """``reduce(rank)``: an all-reduce among ``n`` threads, each calling
    with its own tensor (a process group simulated in one process)."""
    barrier = threading.Barrier(n)
    slots = [None] * n

    def for_rank(rank):
        def reduce(t, op):
            slots[rank] = t
            barrier.wait()
            stack = torch.stack(slots)
            out = stack.amax(0) if op == "max" else stack.sum(0)
            barrier.wait()
            return out
        return reduce
    return for_rank


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_softmax_merge_matches_whole_row_softmax(softcap):
    from repro_torch.models.attention import _dense_attention, _merged_attention

    gen = torch.Generator().manual_seed(5)
    B, H, Kv, Dh, S, n = 3, 4, 2, 16, 20, 4
    q = torch.randn((B, 1, H, Dh), generator=gen)
    k = torch.randn((B, S, Kv, Dh), generator=gen) * 3
    v = torch.randn((B, S, Kv, Dh), generator=gen)
    mask = torch.rand((B, 1, S), generator=gen) > 0.3
    mask[0, 0, 5:10] = False       # row 0: shard 1's slots all masked
    mask[1, 0, :] = False          # row 1: masked everywhere (uniform)
    mask[2, 0, 15:] = False        # row 2: the last shard all masked
    mask[2, 0, 3] = True
    want = _dense_attention(q, k, v, mask, softcap)
    bounds = [0, 5, 10, 15, 20]
    reducer = _threaded_reduce(n)
    outs = [None] * n

    def rank(r):
        sl = slice(bounds[r], bounds[r + 1])
        outs[r] = _merged_attention(q, k[:, sl], v[:, sl], mask[:, :, sl],
                                    softcap, reducer(r))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for out in outs:
        torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(outs[0][1], v[1].mean(0, keepdim=True)
                               .repeat_interleave(H // Kv, 1), rtol=0,
                               atol=1e-6)


def test_all_masked_shard_adds_exactly_zero():
    from repro_torch.models.shardctx import softmax_merge

    m = torch.tensor([[2.0], [-1e30]])
    l = torch.tensor([[3.0], [7.0]])
    o = torch.tensor([[6.0, 9.0], [123.0, -5.0]])
    reduce = lambda t, op: (t.amax(0, keepdim=True) if op == "max"
                            else t.sum(0, keepdim=True))
    out = softmax_merge(m, l, o, reduce)
    assert torch.equal(out, torch.tensor([[2.0, 3.0]]))


# ----------------------------------------------------------------------------
# the engine on a mesh
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ENGINE))
def test_engine_on_world2_serves_the_local_engines_tokens(runs, arch):
    _, w2, _ = runs
    for rank, res in enumerate(w2):
        mesh_served, local_served = res[arch]
        assert mesh_served == local_served, f"rank {rank}"
        assert sum(len(t) for t in mesh_served.values()) == sum(
            g for _, g in [(6, 5), (30, 8), (9, 3), (12, 7), (25, 6), (5, 2),
                           (17, 4)])
        tokens_dt, cache_dt, local, whole = res[arch + "_state"]
        assert tokens_dt and cache_dt
        assert local != whole and np.prod(local) * 2 == np.prod(whole)
