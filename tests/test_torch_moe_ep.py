"""The port's expert-parallel MoE against the reference's.

The reference runs ``repro.models.moe.moe_expert_parallel`` under
``jax.jit`` on its (2, 4) host mesh (the 8 forced host devices of
``tests/conftest.py``); the port runs on 8 gloo ranks of
``repro_torch.hostdevices.spawn_world`` with ``make_host_mesh(2, 4)``,
each rank running every case and returning numpy.  Same capacity
semantics, drops included, at atol 1e-5:

* E = 8, top 2, at capacity factors 1.25 (assignments dropped) and 8.0
  (none dropped: equal to ``moe_dense`` too, as
  ``tests/test_multidevice.py`` asserts for the reference);
* virtual experts: E = 2 < M = 4, each expert split in r = 2 slices, at
  capacity factors 0.5 (C = 1 for 4 assignments a shard: some dropped)
  and 8.0;
* ``tp_over_dp`` (the expert hidden dim sliced over data, tokens
  gathered and partial outputs reduce-scattered);
* an unsharded batch (decode's ``batch_sharded=False``) and S % M != 0
  (no sequence split).

Each case runs on DTensors (params laid out by the policy's
``param_pspecs`` rules, the batch over data), as the model does on a
``DeviceMesh``.  Two cases also hold the gradients of
``sum(out * g) + aux`` against ``jax.grad`` of the same.  On one device
(the ``LocalMesh``) the port's EP is held against the reference's 1 x 1
mesh, and ``_dispatch_positions`` against the reference's.

The rank function lives in this module, which imports neither ``jax``
nor ``repro`` at its top.
"""
import math

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch.hostdevices import spawn_world

torch.set_num_threads(1)
B, S, D = 4, 8, 32
BASE = dict(name="t", arch_type="moe", d_model=D, vocab_size=97,
            num_units=1, num_heads=4, num_kv_heads=4, d_ff=64,
            num_experts=8, num_experts_per_tok=2, moe_d_ff=48)
CASES = {
    "e8_cf1.25": dict(cf=1.25),
    "e8_cf8": dict(cf=8.0),
    "virtual_e2": dict(cf=0.5, experts=2, k=1),
    "virtual_e2_cf8": dict(cf=8.0, experts=2, k=1),
    "tp_over_dp": dict(cf=1.25, tp=True),
    "unsharded_batch": dict(cf=1.25, batch_sharded=False),
    "seq_6": dict(cf=1.25, seq=6),
}
GRAD_CASES = ("e8_cf1.25", "tp_over_dp")
ATOL = 1e-5


def _case_cfg(mod, case):
    c = CASES[case]
    return mod.ModelConfig(**BASE, unit=mod.moe_unit(1)).replace(
        num_experts=c.get("experts", 8),
        num_experts_per_tok=c.get("k", 2),
        moe_capacity_factor=c["cf"])


def _inputs():
    """Per case: (reference params as numpy, x, the cotangent g)."""
    import jax
    import jax.numpy as jnp

    from repro.models import config as jconfig
    from repro.models.moe import init_moe

    out = {}
    rng = np.random.default_rng(0)
    for i, case in enumerate(CASES):
        cfg = _case_cfg(jconfig, case)
        r = max(1, 4 // cfg.num_experts)
        p = init_moe(jax.random.PRNGKey(10 + i), cfg, jnp.float32, virtual_r=r)
        seq = CASES[case].get("seq", S)
        x = rng.standard_normal((B, seq, D)).astype(np.float32)
        g = rng.standard_normal((B, seq, D)).astype(np.float32)
        out[case] = (jax.tree.map(lambda a: np.array(a), p), x, g)
    return out


def _ctx_kw(case):
    c = CASES[case]
    return dict(batch_sharded=c.get("batch_sharded", True),
                tp_over_dp=c.get("tp", False))


# ----------------------------------------------------------------------------
# the port's ranks
# ----------------------------------------------------------------------------


def _rank_run(inputs):
    """Every case on this rank of the (2, 4) mesh: the full output and
    aux, the drops of this rank, and for GRAD_CASES the
    gradients (params and x) gathered whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import (
        P,
        ShardingPolicy,
        _leaf_spec,
        distribute,
    )
    from repro_torch.models import config as tconfig
    from repro_torch.models.moe import (
        MoEShardingCtx,
        count_drops,
        moe_expert_parallel,
    )
    from repro_torch.models.shardctx import mesh_scope

    torch.set_num_threads(1)
    mesh = make_host_mesh(2, 4, device="cpu")
    results = {}
    for case, (p_np, x_np, g_np) in inputs.items():
        cfg = _case_cfg(tconfig, case)
        kw = _ctx_kw(case)
        ctx = MoEShardingCtx(mesh=mesh, dp_axes=("data",), model_axis="model",
                             **kw)
        pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(2,),
                             model_axis_size=4, moe_tp_over_dp=kw["tp_over_dp"])
        params = {k: torch.from_numpy(v) for k, v in p_np.items()}
        x = torch.from_numpy(x_np)
        specs = {k: _leaf_spec(k, v, "mlp", False, pol)
                 for k, v in params.items()}
        dp = ("data",) if kw["batch_sharded"] else None
        with mesh_scope(mesh):
            dparams = distribute(params, mesh, specs)
            dx = distribute(x, mesh, P(dp, None, None))
            if case in GRAD_CASES:
                dparams = {k: v.detach().requires_grad_(True)
                           for k, v in dparams.items()}
                dx = dx.detach().requires_grad_(True)
            with count_drops() as drops:
                y, aux = moe_expert_parallel(dparams, dx, cfg, ctx)
            out = dict(y=y.full_tensor().detach().numpy(),
                       aux=float(aux.full_tensor()),
                       drops=int(sum(int(d) for d in drops)))
            if case in GRAD_CASES:
                g = distribute(torch.from_numpy(g_np), mesh, P(dp, None, None))
                loss = (y * g).sum() + aux
                grads = torch.autograd.grad(
                    loss, [dparams[k] for k in sorted(dparams)] + [dx])
                out["grads"] = {
                    name: (gr.full_tensor() if isinstance(gr, DTensor)
                           else gr).numpy()
                    for name, gr in zip(sorted(dparams) + ["x"], grads)}
            try:
                moe_expert_parallel(params, x, cfg, ctx)
                out["plain_raises"] = False
            except TypeError:
                out["plain_raises"] = True
        results[case] = out
    return results


@pytest.fixture(scope="module")
def runs():
    """(inputs, the port's rank results, the reference's outputs)."""
    import concurrent.futures

    inputs = _inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_world, 8, _rank_run, inputs, timeout=600)
        ref = _reference(inputs)
        return inputs, port.result(), ref


def _reference(inputs):
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_host_mesh
    from repro.models import config as jconfig
    from repro.models.moe import MoEShardingCtx, moe_expert_parallel

    mesh = make_host_mesh(2, 4)
    out = {}
    for case, (p_np, x_np, g_np) in inputs.items():
        cfg = _case_cfg(jconfig, case)
        ctx = MoEShardingCtx(mesh=mesh, dp_axes=("data",), model_axis="model",
                             **_ctx_kw(case))
        p = jax.tree.map(jnp.asarray, p_np)
        x, g = jnp.asarray(x_np), jnp.asarray(g_np)
        fn = jax.jit(lambda p_, x_: moe_expert_parallel(p_, x_, cfg, ctx))
        y, aux = fn(p, x)
        res = dict(y=np.asarray(y), aux=float(aux))
        if case in GRAD_CASES:
            def loss(p_, x_):
                yy, a = moe_expert_parallel(p_, x_, cfg, ctx)
                return jnp.sum(yy * g) + a
            gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
            res["grads"] = dict(jax.tree.map(np.asarray, gp), x=np.asarray(gx))
        out[case] = res
    return out


# ----------------------------------------------------------------------------
# tests
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_ep_matches_reference_ep(runs, case):
    _, port, ref = runs
    want = ref[case]
    for rank, res in enumerate(port):
        got = res[case]
        np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=ATOL,
                                   err_msg=f"{case} rank {rank}")
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6)
        assert got["plain_raises"], "plain tensors on a DeviceMesh"


@pytest.mark.parametrize("case", ["e8_cf1.25", "e8_cf8", "virtual_e2",
                                  "virtual_e2_cf8"])
def test_capacity_drops(runs, case):
    """Below cf 8 some assignment is dropped somewhere on the mesh and the
    output differs from the dense path's; at cf 8 nothing is dropped and
    the output is ``moe_dense``'s (the port's, on one device)."""
    from repro_torch.models import config as tconfig
    from repro_torch.models.moe import moe_dense

    inputs, port, _ = runs
    p_np, x_np, _ = inputs[case]
    cfg = _case_cfg(tconfig, case)
    dense, _ = moe_dense({k: torch.from_numpy(v) for k, v in p_np.items()},
                         torch.from_numpy(x_np), cfg)
    drops = sum(res[case]["drops"] for res in port)
    if CASES[case]["cf"] >= 8.0:
        assert drops == 0
        np.testing.assert_allclose(port[0][case]["y"], dense.numpy(), rtol=0,
                                   atol=ATOL)
    else:
        assert drops > 0
        assert np.abs(port[0][case]["y"] - dense.numpy()).max() > 1e-3


@pytest.mark.parametrize("case", GRAD_CASES)
def test_ep_gradients_match_reference(runs, case):
    """d(sum(out * g) + aux) / d(params, x) through both all-to-alls,
    each leaf within 1e-5 of its largest |g|."""
    _, port, ref = runs
    want = ref[case]["grads"]
    got = port[0][case]["grads"]
    assert sorted(got) == sorted(want)
    for name in want:
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= 1e-5 * scale, (case, name, err, scale)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_one_device_ep_matches_reference(cf):
    """On the LocalMesh (the steps' default) against the reference's
    1 x 1 host mesh: the same drops, so the same output."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_host_mesh as j_mesh
    from repro.models import config as jconfig
    from repro.models.moe import MoEShardingCtx as JCtx
    from repro.models.moe import init_moe, moe_expert_parallel as j_ep
    from repro_torch.launch.mesh import LocalMesh
    from repro_torch.models import config as tconfig
    from repro_torch.models.moe import (
        MoEShardingCtx,
        apply_moe,
        count_drops,
    )

    jcfg = _case_cfg(jconfig, "e8_cf1.25").replace(moe_capacity_factor=cf)
    cfg = _case_cfg(tconfig, "e8_cf1.25").replace(moe_capacity_factor=cf)
    p = init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    for batch_sharded in (True, False):
        jctx = JCtx(mesh=j_mesh(1, 1), dp_axes=("data",), model_axis="model",
                    batch_sharded=batch_sharded)
        jy, jaux = jax.jit(lambda p_, x_: j_ep(p_, x_, jcfg, jctx))(
            p, jnp.asarray(x))
        ctx = MoEShardingCtx(mesh=LocalMesh(), dp_axes=("data",),
                             model_axis="model", batch_sharded=batch_sharded)
        with count_drops() as drops:
            y, aux = apply_moe({k: torch.from_numpy(np.array(v))
                                for k, v in p.items()},
                               torch.from_numpy(x), cfg, ctx)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
        A = B * S * cfg.num_experts_per_tok
        C = math.ceil(A / cfg.num_experts * cf)
        assert (int(drops[0]) > 0) == (cf < 8.0), (C, int(drops[0]))


def test_auto_without_ctx_is_dense_and_ep_needs_ctx():
    from repro_torch.models import config as tconfig
    from repro_torch.models.moe import apply_moe, init_moe, moe_dense

    cfg = _case_cfg(tconfig, "e8_cf1.25")
    p = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 4, D, generator=torch.Generator().manual_seed(1))
    assert torch.equal(apply_moe(p, x, cfg)[0], moe_dense(p, x, cfg)[0])
    with pytest.raises(ValueError, match="sharding context"):
        apply_moe(p, x, cfg.replace(moe_impl="expert_parallel"))


def _dispatch_pair(ids, e, c):
    import jax.numpy as jnp

    from repro.models.moe import _dispatch_positions as j_dispatch
    from repro_torch.models.moe import _dispatch_positions

    jpos, jkeep = j_dispatch(jnp.asarray(ids, jnp.int32), e, c)
    pos, keep = _dispatch_positions(torch.from_numpy(ids), e, c)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    # each expert's kept assignments take slots 0.. in assignment order
    for ex in range(e):
        mine = np.flatnonzero(ids == ex)
        np.testing.assert_array_equal(pos.numpy()[mine], np.arange(len(mine)))


@pytest.mark.parametrize("seed", range(6))
def test_dispatch_positions_match_reference(seed):
    rng = np.random.default_rng(seed)
    a, e, c = int(rng.integers(4, 200)), int(rng.integers(2, 17)), \
        int(rng.integers(1, 17))
    _dispatch_pair(rng.integers(0, e, a).astype(np.int64), e, c)


@given(a=st.integers(4, 200), e=st.integers(2, 16), c=st.integers(1, 16))
@settings(max_examples=10, deadline=None)
def test_property_dispatch_positions_match_reference(a, e, c):
    rng = np.random.default_rng(a * 7 + e)
    _dispatch_pair(rng.integers(0, e, a).astype(np.int64), e, c)
