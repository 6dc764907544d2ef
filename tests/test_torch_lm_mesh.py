"""The port's LM mesh: sharding policy, sharded steps and the MoE default.

* ``param_pspecs`` / ``batch_pspecs`` / ``cache_pspecs`` equal the
  reference's (singleton axis tuples normalized, as
  ``tests/test_pbft_and_sharding.py`` normalizes them) for every registry
  arch at smoke size under three policies, and for olmo-1b,
  hubert-xlarge and qwen2-vl-7b at full size on ``meta`` tensors
  (``abstract_params``).
* On 8 gloo ranks (``spawn_world``, ``make_host_mesh(2, 4)``) against
  the reference's jitted steps on its (2, 4) host mesh: olmo-1b's
  standard train step, 2 AdamW steps with DTensor params and moments
  laid out by ``param_pspecs`` and the batch by ``batch_pspecs`` (losses
  and params at ``tests/test_torch_train_step.py``'s tolerances); a bflc
  step and the committee weights of a poisoned cohort on the mesh (the
  poisoned cohort weighs least in both); mixtral's sharded prefill and
  4 greedy decode steps at ``fsdp=False`` (tokens equal).
* A world-1 ``DeviceMesh`` (DTensor params on a (1, 1) mesh) gives the
  ``LocalMesh`` (plain tensors) result bit for bit: an AdamW step of
  olmo-1b and of mixtral (through the expert-parallel path), mixtral's
  prefill + decode logits, and the training CLI's ``run_lm`` with and
  without ``--use-all-devices``.
* The MoE repair: the port's default ``ServeEngine`` and train step now
  take the expert-parallel path with the reference's capacity dispatch,
  so they equal the reference's defaults on qwen3-moe and mixtral smoke
  token for token and loss for loss.

The rank functions live in this module, which imports neither ``jax``
nor ``repro`` at its top.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.hostdevices import spawn_world

torch.set_num_threads(1)
B, S = 8, 16
LOSS_RTOL = 1e-6
PARAM_ATOL = 3e-5
PROMPT, GEN, MAX_LEN = 8, 4, 16


def _norm(spec):
    """Spec entries version-agnostic: ('data',) -> 'data'."""
    out = []
    for e in spec:
        if isinstance(e, (tuple, list)) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, list) else e)
    return tuple(out)


def _tokens(vocab, rows, seed, seq=S):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (rows, seq + 1)).astype(np.int32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None], (rows, seq))
    return dict(tokens=toks[:, :-1], positions=np.ascontiguousarray(pos),
                targets=toks[:, 1:], loss_mask=np.ones((rows, seq), np.float32))


def _poisoned(arrays, logits):
    """Cohort 0's targets (the first B / 4 rows) poisoned: each is the
    token the model finds least likely there, as a label-flipping attacker
    would pick (``tests/test_torch_train_step.py``'s poisoning)."""
    out = dict(arrays)
    tg = arrays["targets"].copy()
    tg[:B // 4] = np.asarray(logits)[:B // 4].argmin(-1)
    out["targets"] = tg
    return out


def _inputs():
    import jax

    from repro.configs import registry as jreg
    from repro.models import forward
    from repro.models import init_model as j_init
    from repro.models.transformer import Batch

    out = {}
    for arch in ("olmo-1b", "mixtral-8x7b"):
        cfg = jreg.smoke_config(arch)
        out[arch] = jax.tree.map(lambda a: np.array(a),
                                 j_init(jax.random.PRNGKey(7), cfg))
    v = jreg.smoke_config("olmo-1b").vocab_size
    out["train"] = [_tokens(v, B, 10 + i) for i in range(2)]
    out["val"] = _tokens(v, 4, 20)
    clean = _tokens(v, B, 1)
    logits, _ = forward(jax.tree.map(jax.numpy.asarray, out["olmo-1b"]),
                        jreg.smoke_config("olmo-1b"),
                        Batch(tokens=jax.numpy.asarray(clean["tokens"]),
                              positions=jax.numpy.asarray(clean["positions"])))
    out["poisoned"] = _poisoned(clean, logits)
    mv = jreg.smoke_config("mixtral-8x7b").vocab_size
    out["prompt"] = _tokens(mv, 4, 5, PROMPT)["tokens"]
    return out


# ----------------------------------------------------------------------------
# the port's ranks
# ----------------------------------------------------------------------------


def _pol(data, model, fsdp=True):
    from repro_torch.launch.shardings import ShardingPolicy

    return ShardingPolicy(dp_axes=("data",), dp_sizes=(data,),
                          model_axis_size=model, fsdp=fsdp)


def _batch(arrays, keys=("tokens", "positions", "targets", "loss_mask")):
    from repro_torch.models.transformer import Batch

    return Batch(**{k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                    for k in keys})


def _train(cfg, params, mesh, pol, batches, val, mode, steps=2, warmup=True):
    """``steps`` AdamW steps on ``mesh`` (params distributed when it is a
    DeviceMesh): the losses and the final params / moments, whole.  With
    ``warmup`` the learning rate is ``linear_warmup_cosine(1e-2, 1, 3)``'s
    (0 at step 0), else 1e-2."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.shardings import (
        batch_pspecs,
        distribute,
        param_pspecs,
    )
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.models.shardctx import whole
    from repro_torch.tree import tree_map

    opt = adamw(linear_warmup_cosine(1e-2, 1, 3) if warmup else 1e-2,
                eps=1e-3)
    p = distribute(params, mesh, param_pspecs(cfg, params, pol))
    bspec = batch_pspecs(cfg, pol, batch_sharded=True)
    step = tsteps.make_train_step(cfg, opt, mesh, pol, mode=mode,
                                  num_cohorts=4, committee_size=4)
    state = tsteps.TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32))
    losses = []
    for arrays in batches[:steps]:
        vb = distribute(_batch(val), mesh, bspec) if mode == "bflc" else None
        state, m = step(state, distribute(_batch(arrays), mesh, bspec), vb)
        losses.append((float(m["loss"]), float(m["total_loss"])))
    embed = tuple((type(p).__name__, getattr(p, "dim", None))
                  for p in getattr(state.params["embed"], "placements", ()))
    to_np = lambda t: whole(t).detach().numpy()
    return dict(losses=losses, params=tree_map(to_np, state.params),
                m=tree_map(to_np, state.opt_state["m"]), embed=embed)


def _serve(cfg, params, mesh, pol, prompt):
    """Prefill + GEN - 1 greedy decode steps: the tokens and every step's
    logits, whole."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.shardings import (
        batch_pspecs,
        distribute,
        param_pspecs,
    )
    from repro_torch.models.shardctx import whole

    p = distribute(params, mesh, param_pspecs(cfg, params, pol))
    bspec = batch_pspecs(cfg, pol, batch_sharded=True)._replace(
        targets=None, loss_mask=None)
    rows = prompt.shape[0]
    batch = distribute(_batch(dict(
        tokens=prompt, positions=np.broadcast_to(
            np.arange(PROMPT, dtype=np.int32)[None], (rows, PROMPT))),
        ("tokens", "positions")), mesh, bspec)
    prefill = tsteps.make_prefill_step(cfg, mesh, pol, max_len=MAX_LEN)
    decode = tsteps.make_decode_step(cfg, mesh, pol)
    with torch.no_grad():
        logits, cache = prefill(p, batch)
        tok = whole(torch.argmax(whole(logits)[:, -1], -1).to(torch.int32))[:, None]
        toks, seen = [tok], [whole(logits)[:, -1]]
        pos = torch.full((rows,), PROMPT, dtype=torch.int32)
        for _ in range(GEN - 1):
            tok, logits, cache = decode(p, tok, pos, cache)
            tok = whole(tok)
            pos = pos + 1
            toks.append(tok)
            seen.append(whole(logits)[:, -1])
    return dict(tokens=torch.cat(toks, 1).numpy(),
                logits=torch.stack(seen, 1).numpy())


def _rank_world8(inputs):
    from repro_torch.configs import registry
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import (
        batch_pspecs,
        distribute,
        param_pspecs,
    )
    from repro_torch.launch.steps import (
        committee_weights,
        make_moe_ctx,
        token_ce,
    )
    from repro_torch.models import forward
    from repro_torch.models.shardctx import replicate, whole

    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 4, device="cpu")
    olmo = registry.smoke_config("olmo-1b")
    pol = _pol(2, 4)
    params = from_numpy_tree(inputs["olmo-1b"])
    out = dict(standard=_train(olmo, params, mesh, pol, inputs["train"],
                               None, "standard"),
               bflc=_train(olmo, params, mesh, pol, [inputs["poisoned"]],
                           inputs["val"], "bflc", steps=1))
    # the committee weights of the poisoned batch, on the mesh
    ctx = make_moe_ctx(olmo, mesh, pol, batch_sharded=True)
    bspec = batch_pspecs(olmo, pol, batch_sharded=True)
    dp = distribute(params, mesh, param_pspecs(olmo, params, pol))
    with torch.no_grad(), ctx.scope():
        def member_rows(arrays):
            logits, _ = forward(dp, olmo, distribute(_batch(arrays), mesh,
                                                      bspec), ctx)
            nll, mask = token_ce(logits, torch.from_numpy(arrays["targets"]),
                                 torch.from_numpy(arrays["loss_mask"]))
            return replicate(nll), replicate(mask)
        nll, mask = member_rows(inputs["poisoned"])
        cl = nll.reshape(4, -1).sum(1) / mask.reshape(4, -1).sum(1)
        vnll, vmask = member_rows(inputs["val"])
        member = (vnll.sum(-1) / vmask.sum(-1))[:4]
        out["weights"] = whole(committee_weights(cl, member)).numpy()
    mixtral = registry.smoke_config("mixtral-8x7b")
    out["serve"] = _serve(mixtral, from_numpy_tree(inputs["mixtral-8x7b"]),
                          mesh, _pol(2, 4, fsdp=False), inputs["prompt"])
    return out


def _rank_world1(inputs):
    """DTensor params on a (1, 1) DeviceMesh against plain ones on the
    LocalMesh, bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch.mesh import LocalMesh, make_host_mesh

    torch.set_num_threads(2)
    mesh = make_host_mesh(1, 1, device="cpu")
    assert not getattr(mesh, "is_local", False)
    pol = _pol(1, 1, fsdp=False)
    out = {}
    for arch in ("olmo-1b", "mixtral-8x7b"):
        cfg = registry.smoke_config(arch)
        params = from_numpy_tree(inputs[arch])
        train = [_tokens(cfg.vocab_size, B, 30)]
        out[arch] = [_train(cfg, params, m, pol, train, None, "standard",
                            steps=1, warmup=False)
                     for m in (mesh, LocalMesh())]
    mixtral = registry.smoke_config("mixtral-8x7b")
    out["serve"] = [_serve(mixtral, from_numpy_tree(inputs["mixtral-8x7b"]), m,
                           pol, inputs["prompt"]) for m in (mesh, LocalMesh())]
    out["run_lm"] = [_run_lm(flag) for flag in (["--use-all-devices"], [])]
    return out


def _run_lm(extra):
    """The training CLI's ``run_lm`` (small, 2 bflc steps): each step's
    losses and the final params, whole."""
    from repro_torch.launch.train import build_parser, run_lm
    from repro_torch.models.shardctx import whole

    args = build_parser().parse_args(
        ["--small", "--steps", "2", "--seq", "16", "--batch", "4", "--vocab",
         "512", "--mode", "bflc", "--device", "cpu", "--log-every", "1"]
        + extra)
    seen = {}

    def on_step(step, state, metrics):
        seen.setdefault("losses", []).append(
            (float(metrics["loss"]), float(metrics["total_loss"])))
        seen["state"] = state

    run_lm(args, on_step=on_step)
    from repro_torch.tree import tree_map

    return dict(losses=seen["losses"],
                params=tree_map(lambda t: whole(t).numpy(),
                                seen["state"].params),
                dtensor=type(seen["state"].params["embed"]).__name__)


# ----------------------------------------------------------------------------
# the reference on its (2, 4) host mesh
# ----------------------------------------------------------------------------


def _reference(inputs):
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shardings import (
        ShardingPolicy,
        batch_pspecs,
        named,
        param_pspecs,
    )
    from repro.models import forward
    from repro.models.transformer import Batch
    from repro.optim import adamw, linear_warmup_cosine

    mesh = make_host_mesh(2, 4)
    pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(2,), model_axis_size=4)
    cfg = jreg.smoke_config("olmo-1b")
    bsh = named(mesh, batch_pspecs(cfg, pol, batch_sharded=True))
    batch = lambda a: jax.device_put(
        Batch(**{k: jnp.asarray(v) for k, v in a.items()}), bsh)
    opt = adamw(linear_warmup_cosine(1e-2, 1, 3), eps=1e-3)
    out = {}
    for mode, batches, n in (("standard", inputs["train"], 2),
                             ("bflc", [inputs["poisoned"]], 1)):
        psh = named(mesh, param_pspecs(cfg, inputs["olmo-1b"], pol))
        p = jax.device_put(jax.tree.map(jnp.asarray, inputs["olmo-1b"]), psh)
        state = jsteps.TrainState(p, jax.device_put(opt.init(p),
                                                    {"m": psh, "v": psh}),
                                  jnp.zeros((), jnp.int32))
        step = jax.jit(jsteps.make_train_step(cfg, opt, mesh, pol, mode=mode,
                                              num_cohorts=4, committee_size=4))
        losses = []
        for a in batches[:n]:
            state, m = step(state, batch(a),
                            batch(inputs["val"]) if mode == "bflc" else None)
            losses.append((float(m["loss"]), float(m["total_loss"])))
        out[mode] = dict(losses=losses,
                         params=jax.tree.map(np.asarray, state.params),
                         m=jax.tree.map(np.asarray, state.opt_state["m"]))
    # committee weights of the poisoned batch on the mesh
    ctx = jsteps.make_moe_ctx(cfg, mesh, pol, batch_sharded=True)
    p = jax.tree.map(jnp.asarray, inputs["olmo-1b"])

    @jax.jit
    def weights(p, b, v):
        logits, _ = forward(p, cfg, b, ctx)
        nll, mask = jsteps.token_ce(logits, b.targets, b.loss_mask)
        cl = nll.reshape(4, -1).sum(1) / jnp.maximum(mask.reshape(4, -1).sum(1),
                                                     1.0)
        vlogits, _ = forward(p, cfg, v, ctx)
        vnll, vmask = jsteps.token_ce(vlogits, v.targets, v.loss_mask)
        member = (vnll.sum(-1) / jnp.maximum(vmask.sum(-1), 1.0))[:4]
        med = jnp.median(-jnp.abs(cl[:, None] - member[None, :]), axis=1)
        return jax.nn.softmax(med / jnp.maximum(med.std(), 1e-6))

    out["weights"] = np.asarray(weights(p, batch(inputs["poisoned"]),
                                        batch(inputs["val"])))
    # mixtral's sharded prefill + decode, fsdp off
    mcfg = jreg.smoke_config("mixtral-8x7b")
    mpol = dataclasses.replace(pol, fsdp=False)
    mp = jax.device_put(jax.tree.map(jnp.asarray, inputs["mixtral-8x7b"]),
                        named(mesh, param_pspecs(mcfg, inputs["mixtral-8x7b"],
                                                 mpol)))
    prefill = jax.jit(jsteps.make_prefill_step(mcfg, mesh, mpol, MAX_LEN))
    decode = jax.jit(jsteps.make_decode_step(mcfg, mesh, mpol))
    rows = inputs["prompt"].shape[0]
    mb = Batch(tokens=jnp.asarray(inputs["prompt"]),
               positions=jnp.broadcast_to(
                   jnp.arange(PROMPT, dtype=jnp.int32)[None], (rows, PROMPT)))
    logits, cache = prefill(mp, mb)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    toks, seen = [tok], [logits[:, -1]]
    pos = jnp.full((rows,), PROMPT, jnp.int32)
    for _ in range(GEN - 1):
        tok, logits, cache = decode(mp, tok, pos, cache)
        pos = pos + 1
        toks.append(tok)
        seen.append(logits[:, -1])
    out["serve"] = dict(tokens=np.asarray(jnp.concatenate(toks, 1)),
                        logits=np.asarray(jnp.stack(seen, 1)))
    return out


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures

    inputs = _inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        w8 = pool.submit(spawn_world, 8, _rank_world8, inputs, timeout=600)
        w1 = pool.submit(spawn_world, 1, _rank_world1, inputs, timeout=600)
        ref = _reference(inputs)
        return inputs, w8.result(), w1.result()[0], ref


# ----------------------------------------------------------------------------
# the sharding policy against the reference's
# ----------------------------------------------------------------------------


def _policies(mod):
    P = mod.ShardingPolicy
    return [P(dp_axes=("data",), dp_sizes=(16,), model_axis_size=16),
            P(dp_axes=("data",), dp_sizes=(2,), model_axis_size=4, fsdp=False,
              moe_tp_over_dp=True),
            P(dp_axes=("pod", "data"), dp_sizes=(2, 16), model_axis_size=16,
              shard_moe_fsdp=False)]


def _ref_specs(tree):
    import jax
    from jax.sharding import PartitionSpec as JP

    return [_norm(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, JP))]


def _sorted_port_specs(tree):
    """Port spec leaves in the reference's (sorted-key) leaf order."""
    from repro_torch.launch.shardings import P

    def walk(t, prefix=()):
        if isinstance(t, P):
            return [(prefix, t)]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in walk(t[k], prefix + (k,))]
        return [x for i, v in enumerate(t) for x in walk(v, prefix + (i,))]

    return [_norm(s) for _, s in walk(tree)]


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_and_cache_pspecs_match_reference(size):
    import jax

    from repro.configs import registry as jreg
    from repro.launch import shardings as jsh
    from repro.models import init_cache as j_init_cache
    from repro.models import init_model as j_init
    from repro_torch.configs import registry
    from repro_torch.launch import shardings as tsh
    from repro_torch.models import init_cache
    from repro_torch.models.transformer import abstract_params

    archs = (registry.ARCH_IDS if size == "smoke"
             else ("olmo-1b", "hubert-xlarge", "qwen2-vl-7b"))
    get = (lambda r, a: r.smoke_config(a)) if size == "smoke" else \
        (lambda r, a: r.get_config(a))
    for arch in archs:
        jcfg, cfg = get(jreg, arch), get(registry, arch)
        jp = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
        tp = abstract_params(cfg)
        for jpol, tpol in zip(_policies(jsh), _policies(tsh)):
            assert _ref_specs(jsh.param_pspecs(jcfg, jp, jpol)) == \
                _sorted_port_specs(tsh.param_pspecs(cfg, tp, tpol)), arch
            for bs in (True, False):
                jb = jsh.batch_pspecs(jcfg, jpol, batch_sharded=bs)
                tb = tsh.batch_pspecs(cfg, tpol, batch_sharded=bs)
                for f in tb._fields:
                    a, b = getattr(jb, f), getattr(tb, f)
                    assert (a is None) == (b is None), (arch, f)
                    if a is not None:
                        assert _norm(a) == _norm(b), (arch, f, a, b)
                if not jcfg.is_decoder():
                    continue
                jc = jax.eval_shape(lambda: j_init_cache(jcfg, 2, 32,
                                                         jax.numpy.float32))
                tc = init_cache(cfg, 2, 32, torch.float32, device="meta")
                assert _ref_specs(jsh.cache_pspecs(jcfg, jc, jpol,
                                                   batch_sharded=bs)) == \
                    _sorted_port_specs(tsh.cache_pspecs(cfg, tc, tpol,
                                                        batch_sharded=bs)), arch


def test_full_size_specs_shard_big_matrices():
    """The reference's own checks (tests/test_pbft_and_sharding.py) on the
    port: olmo-1b's wq over (data, model), hubert's 504-class head kept
    whole on a 16-way model axis, qwen2-vl's M-RoPE positions."""
    from repro_torch.configs import registry
    from repro_torch.launch.shardings import (
        ShardingPolicy,
        batch_pspecs,
        named,
        param_pspecs,
    )
    from repro_torch.models.transformer import abstract_params

    pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(16,), model_axis_size=16)
    olmo = registry.get_config("olmo-1b")
    specs = param_pspecs(olmo, abstract_params(olmo), pol)
    assert _norm(specs["units"][0]["mixer"]["wq"]) == (None, "data", "model")
    hub = registry.get_config("hubert-xlarge")
    lm = param_pspecs(hub, abstract_params(hub), pol)["lm_head"]
    assert len(lm) < 2 or lm[1] is None
    b = batch_pspecs(registry.get_config("qwen2-vl-7b"), pol, batch_sharded=True)
    assert _norm(b.positions) == (None, "data", None)
    assert _norm(b.tokens) == ("data", None)
    assert pol.axis_size(None) == 1 and pol.axis_size("model") == 16
    assert pol.axis_size(("data", "model")) == 256

    class Mesh2:
        mesh_dim_names = ("data", "model")
        shape = (16, 16)

    from torch.distributed.tensor import Replicate, Shard

    pl = named(Mesh2(), {"w": specs["units"][0]["mixer"]["wq"], "b": None})
    assert pl["w"] == (Shard(1), Shard(2)) and pl["b"] is None
    pl = named(Mesh2(), specs["final_norm"])
    assert all(v == (Replicate(), Replicate()) for v in pl.values())
    Mesh2.shape = (16, 1)             # a dimension of one rank holds it whole
    pl = named(Mesh2(), {"w": specs["units"][0]["mixer"]["wq"]})
    assert pl["w"] == (Shard(1), Replicate())


def test_pick_q_block_matches_reference():
    from repro.models.flash import pick_q_block as j_pick
    from repro_torch.models.flash import pick_q_block

    for seq in (512, 1024, 2560, 4096, 4160, 32768):
        for m in (1, 2, 4, 8, 16, 3):
            for cap in (512, 256):
                assert pick_q_block(seq, m, cap) == j_pick(seq, m, cap), (
                    seq, m, cap)


def test_meshes_without_a_group():
    from repro_torch.launch.mesh import (
        LocalMesh,
        dp_axes,
        make_host_mesh,
        make_production_mesh,
        model_axis,
    )

    mesh = make_host_mesh(1, 1)
    assert isinstance(mesh, LocalMesh) and mesh.shape == (1, 1)
    assert dp_axes(mesh) == ("data",) and model_axis(mesh) == "model"
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2, 4)
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="needs"):
            make_production_mesh(multi_pod=multi_pod)


# ----------------------------------------------------------------------------
# the sharded steps against the reference's
# ----------------------------------------------------------------------------


def _leaf_paths(tree):
    import jax

    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): l
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_sharded_train_step_matches_reference(runs):
    _, w8, _, ref = runs
    for rank, res in enumerate(w8):
        got, want = res["standard"], ref["standard"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        wp, gp = _leaf_paths(want["params"]), _leaf_paths(got["params"])
        assert sorted(wp) == sorted(gp)
        for path in wp:
            np.testing.assert_allclose(gp[path], wp[path], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"rank {rank} {path}")
        wm, gm = _leaf_paths(want["m"]), _leaf_paths(got["m"])
        for path in wm:
            scale = max(float(np.abs(wm[path]).max()), 1e-30)
            assert float(np.abs(gm[path] - wm[path]).max()) <= 1e-5 * scale
    # the state stays laid out by param_pspecs: embed (model, fsdp)
    assert w8[0]["standard"]["embed"] == (("Shard", 1), ("Shard", 0))


def test_sharded_bflc_step_downweights_poisoned_cohort(runs):
    _, w8, _, ref = runs
    got = w8[0]
    np.testing.assert_allclose(got["bflc"]["losses"], ref["bflc"]["losses"],
                               rtol=1e-5)
    assert int(np.argmin(ref["weights"])) == 0
    assert int(np.argmin(got["weights"])) == 0
    np.testing.assert_allclose(got["weights"], ref["weights"], rtol=1e-4,
                               atol=1e-7)
    wp, gp = _leaf_paths(ref["bflc"]["params"]), _leaf_paths(got["bflc"]["params"])
    for path in wp:
        np.testing.assert_allclose(gp[path], wp[path], rtol=0, atol=PARAM_ATOL)


def test_sharded_prefill_decode_matches_reference(runs):
    _, w8, _, ref = runs
    for res in w8:
        np.testing.assert_array_equal(res["serve"]["tokens"],
                                      ref["serve"]["tokens"])
        np.testing.assert_allclose(res["serve"]["logits"],
                                   ref["serve"]["logits"], rtol=0, atol=1e-4)


def test_world1_mesh_equals_no_mesh(runs):
    _, _, w1, _ = runs
    for arch in ("olmo-1b", "mixtral-8x7b"):
        mesh_run, local_run = w1[arch]
        assert mesh_run["losses"] == local_run["losses"], arch
        for key in ("params", "m"):
            a, b = _leaf_paths(mesh_run[key]), _leaf_paths(local_run[key])
            for path in a:
                np.testing.assert_array_equal(a[path], b[path],
                                              err_msg=f"{arch} {key} {path}")
    mesh_run, local_run = w1["serve"]
    np.testing.assert_array_equal(mesh_run["tokens"], local_run["tokens"])
    np.testing.assert_array_equal(mesh_run["logits"], local_run["logits"])
    # the CLI: --use-all-devices on a world of one = the meshless run
    mesh_run, local_run = w1["run_lm"]
    assert (mesh_run["dtensor"], local_run["dtensor"]) == ("DTensor", "Tensor")
    assert mesh_run["losses"] == local_run["losses"]
    a, b = _leaf_paths(mesh_run["params"]), _leaf_paths(local_run["params"])
    for path in a:
        np.testing.assert_array_equal(a[path], b[path], err_msg=str(path))


# ----------------------------------------------------------------------------
# the repair: the MoE defaults
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x7b"])
def test_moe_defaults_match_reference_defaults(arch):
    """Both packages at their defaults (``moe_impl="auto"``; the
    reference's engine and steps on ``make_host_mesh(1, 1)``, the port's on
    the LocalMesh): the engines serve the same tokens and the train steps
    give the same losses.  The port's dense path (its only one before the
    expert-parallel MoE) gives other tokens on this trace."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_host_mesh as j_mesh
    from repro.launch.shardings import ShardingPolicy as JPol
    from repro.models import init_model as j_init
    from repro.models.transformer import Batch as JBatch
    from repro.optim import adamw as j_adamw
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve import VirtualClock as JVirtualClock
    from repro.serve import make_poisson_trace as j_trace
    from repro_torch.configs import registry
    from repro_torch.convert import from_numpy_tree
    from repro_torch.launch import steps as tsteps
    from repro_torch.optim import adamw
    from repro_torch.serve import ServeEngine, VirtualClock, make_poisson_trace

    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    assert jcfg.moe_impl == cfg.moe_impl == "auto"
    ref_np = jax.tree.map(lambda a: np.array(a),
                          j_init(jax.random.PRNGKey(3), jcfg))
    jp, tp = jax.tree.map(jnp.asarray, ref_np), from_numpy_tree(ref_np)
    kw = dict(num_requests=6, rate=1.0, prompt_lens=(8, 12), gen_lens=(4, 8),
              vocab_size=cfg.vocab_size, seed=4)
    ref = JServeEngine(jcfg, jp, num_slots=3, max_len=32).run(
        j_trace(**kw), clock=JVirtualClock())
    port = ServeEngine(cfg, tp, num_slots=3, max_len=32, device="cpu").run(
        make_poisson_trace(**kw), clock=VirtualClock())
    assert [r.tokens for r in port.results] == [r.tokens for r in ref.results]
    dense = ServeEngine(cfg.replace(moe_impl="dense"), tp, num_slots=3,
                        max_len=32, device="cpu").run(
        make_poisson_trace(**kw), clock=VirtualClock())
    assert [r.tokens for r in dense.results] != [r.tokens for r in ref.results]

    pol = JPol(dp_axes=("data",), dp_sizes=(1,), model_axis_size=1, fsdp=False)
    jstep = jax.jit(jsteps.make_train_step(jcfg, j_adamw(1e-2), j_mesh(1, 1),
                                           pol, mode="standard"))
    step = tsteps.make_train_step(cfg, adamw(1e-2), mode="standard")
    js = jsteps.TrainState(jp, j_adamw(1e-2).init(jp), jnp.zeros((), jnp.int32))
    ts = tsteps.TrainState(tp, adamw(1e-2).init(tp),
                           torch.zeros((), dtype=torch.int32))
    for i in range(2):
        a = _tokens(cfg.vocab_size, 4, 40 + i)
        js, jm = jstep(js, JBatch(**{k: jnp.asarray(v) for k, v in a.items()}))
        ts, tm = step(ts, _batch(a))
        for key in ("loss", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
