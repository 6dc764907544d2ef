"""The flash attention path on a model axis of 2, against the reference.

With ``DENSE_MAX`` lowered to 256 in both packages (as
``tests/test_torch_flash.py`` lowers it), ``attention_forward`` at
S = 1536 takes the flash path on a mesh: the reference under ``jax.jit``
on its host mesh (4 of the 8 forced host devices of
``tests/conftest.py``), the port on 4 gloo ranks of
``repro_torch.hostdevices.spawn_world`` with ``make_host_mesh`` of the
same shape, the parameters laid out by the policy's rules and x over
data.  Three cases of phi4-mini's smoke attention (causal, RoPE):

* ``heads``: (2, 2) mesh, 4 query heads over 2 KV heads, H % M == 0, so
  the flash blocks are split with heads over model;
* ``q_blocks``: (2, 2) mesh, 3 query heads over 1 KV head, H % M != 0,
  so ``pick_q_block`` picks 256 (3 blocks of 512 do not split two ways)
  and the Q blocks are split over model;
* ``batch_only``: (4, 1) mesh, no model axis to split: no block spec,
  flash runs on the DTensors under DTensor's own rules (batch split).

Each holds the output and the gradients of x and of every weight
(``sum(out * ct)``, through the custom backward) within 5e-5 of their
largest entry (``RTOL``), and checks that the port's flash call got the branch's
block size and block spec.

The rank function lives in this module, which imports neither ``jax``
nor ``repro`` at its top.
"""
import numpy as np
import pytest
import torch

from repro_torch.hostdevices import spawn_world

torch.set_num_threads(1)
ARCH = "phi4-mini-3.8b"
S = 1536
WORLD = 4
SMALL_DENSE_MAX = 256
# of the largest entry: the port in one process is already 2.1e-5 off
# the reference's wk gradient at the q_blocks shape (one KV head's
# gradient summed over 3 query heads and 3072 rows in another order)
RTOL = 5e-5
CASES = {
    # (mesh, batch rows, query heads, KV heads, and the port's q_block and
    # block spec: None where flash takes DTensor's own rules)
    "heads": ((2, 2), 2, 4, 2, 512,
              (("data",), None, "model", None, None, None)),
    "q_blocks": ((2, 2), 2, 3, 1, 256,
                 (("data",), "model", None, None, None, None)),
    "batch_only": ((4, 1), 4, 4, 2, 512, None),
}


def _cfg(registry, case):
    _, _, heads, kv, _, _ = CASES[case]
    return registry.smoke_config(ARCH).replace(num_heads=heads,
                                               num_kv_heads=kv)


def _inputs():
    """Per case: (reference params as numpy, x, the cotangent ct)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.models import attention as jattn

    rng = np.random.default_rng(0)
    out = {}
    for i, case in enumerate(CASES):
        cfg = _cfg(jreg, case)
        B = CASES[case][1]
        p = jattn.init_attention(jax.random.PRNGKey(3 + i), cfg, jnp.float32)
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        out[case] = (jax.tree.map(np.asarray, p), x, ct)
    return out


def _norm(spec):
    """Spec entries as the tests compare them: tuples for axis groups."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _rank_run(inputs):
    """Every case on this rank of its mesh: the output and the gradients
    gathered whole, and the (q_block, block_spec) of every flash call."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import (
        P,
        ShardingPolicy,
        _leaf_spec,
        distribute,
    )
    from repro_torch.models import attention as tattn
    from repro_torch.models.shardctx import make_shard_ctx

    torch.set_num_threads(1)
    tattn.DENSE_MAX = SMALL_DENSE_MAX
    real, calls = tattn.flash_attention, []

    def spy(*args, **kw):
        spec = kw["block_spec"]
        calls.append((kw["q_block"], spec if spec is None else _norm(spec)))
        return real(*args, **kw)

    tattn.flash_attention = spy
    results = {}
    for case, (p_np, x_np, ct_np) in inputs.items():
        (data, model), B = CASES[case][:2]
        mesh = make_host_mesh(data, model, device="cpu")
        pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(data,),
                             model_axis_size=model)
        cfg = _cfg(registry, case)
        ctx = make_shard_ctx(mesh, ("data",), "model", batch_sharded=True,
                             num_kv_heads=cfg.num_kv_heads,
                             num_heads=cfg.num_heads)
        params = {k: torch.from_numpy(v) for k, v in p_np.items()}
        specs = {k: _leaf_spec(k, v, "mixer", False, pol)
                 for k, v in params.items()}
        bsh = P(("data",), None, None)
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        del calls[:]
        with ctx.scope():
            dp = {k: v.detach().requires_grad_(True)
                  for k, v in distribute(params, mesh, specs).items()}
            dx = distribute(torch.from_numpy(x_np), mesh,
                            bsh).detach().requires_grad_(True)
            dpos = distribute(pos.contiguous(), mesh, P(("data",), None))
            out = tattn.attention_forward(dp, dx, dpos, cfg, "attn", ctx=ctx)
            ct = distribute(torch.from_numpy(ct_np), mesh, bsh)
            grads = torch.autograd.grad(out, [dx] + [dp[k] for k in sorted(dp)],
                                        ct)
        whole = [g.full_tensor() if isinstance(g, DTensor) else g
                 for g in [out] + list(grads)]
        results[case] = dict(
            out=whole[0].detach().numpy(),
            grads={name: g.numpy() for name, g in
                   zip(["x"] + sorted(dp), whole[1:])},
            calls=list(calls), out_is_dtensor=isinstance(out, DTensor))
    return results


def _reference(inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.configs import registry as jreg
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shardings import ShardingPolicy, _leaf_spec, named
    from repro.models import attention as jattn
    from repro.models.shardctx import make_shard_ctx

    out = {}
    for case, (p_np, x_np, ct_np) in inputs.items():
        (data, model), B = CASES[case][:2]
        mesh = make_host_mesh(data, model)
        pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(data,),
                             model_axis_size=model)
        xsh = NamedSharding(mesh, PartitionSpec("data", None, None))
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
        cfg = _cfg(jreg, case)
        ctx = make_shard_ctx(mesh, ("data",), "model", batch_sharded=True,
                             num_kv_heads=cfg.num_kv_heads,
                             num_heads=cfg.num_heads)

        def fwd_bwd(p, x, ct, cfg=cfg, ctx=ctx, pos=pos):
            y, vjp = jax.vjp(lambda p_, x_: jattn.attention_forward(
                p_, x_, pos, cfg, "attn", ctx=ctx), p, x)
            gp, gx = vjp(ct)
            return y, gp, gx

        psh = named(mesh, {k: _leaf_spec(k, v, "mixer", False, pol)
                           for k, v in p_np.items()})
        y, gp, gx = jax.jit(fwd_bwd)(jax.device_put(p_np, psh),
                                     jax.device_put(x_np, xsh),
                                     jax.device_put(ct_np, xsh))
        grads = {k: np.asarray(v) for k, v in gp.items()}
        grads["x"] = np.asarray(gx)
        out[case] = dict(out=np.asarray(y), grads=grads)
    return out


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures

    from repro.models import attention as jattn

    inputs = _inputs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn_world, WORLD, _rank_run, inputs, timeout=600)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jattn, "DENSE_MAX", SMALL_DENSE_MAX)
            ref = _reference(inputs)
        return port.result(), ref


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_flash_matches_reference(runs, case):
    port, ref = runs
    q_block, block_spec = CASES[case][4:]
    want = ref[case]
    for rank, res in enumerate(port):
        got = res[case]
        assert got["out_is_dtensor"]
        assert got["calls"] == [(q_block, block_spec)], (rank, got["calls"])
        _close(got["out"], want["out"], f"{case} rank {rank} out")
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name in want["grads"]:
            _close(got["grads"][name], want["grads"][name],
                   f"{case} rank {rank} d{name}")
