"""The port's Mamba-1 block (``repro_torch.models.mamba``) against the
reference's ``repro.models.mamba``.

At jamba-1.5-large's smoke width (d_model 128, d_inner 256, d_state 8,
d_conv 4, dt_rank 8) the reference's params are carried across through
``repro_torch.convert`` and the same numpy inputs, made from a seed, go
to both packages (the reference under ``jax.jit``).  Every output and
state is held to ``atol=1e-5`` of that tensor's largest entry: the
matmuls sum in another order than XLA's, and the SSM state is a sum over
the tokens so far.

The reference scans in chunks of 64 tokens, padding S with steps of
``dt = 0``; the port loops over the S tokens unpadded.  S = 70 (6 pad
steps) shows that both leave the same state.  The reference's hybrid
check (``tests/test_models.py:62``) is ported too: a prefill continued by
decode steps gives the logits of a forward of the whole sequence.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mamba as jm
from repro.models import init_model as j_init
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.models import Batch, decode_step, forward, prefill
from repro_torch.models import mamba as tm
from repro_torch.models.cache import init_layer_cache
from repro_torch.tree import tree_paths

torch.set_num_threads(2)
ARCH = "jamba-1.5-large-398b"
RTOL = 1e-5
B = 2


@pytest.fixture(scope="module")
def cfgs():
    return registry.smoke_config(ARCH), jreg.smoke_config(ARCH)


@pytest.fixture(scope="module")
def params(cfgs):
    _, jcfg = cfgs
    p = jax.tree.map(np.asarray, jm.init_mamba(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
    return p, from_numpy_tree(p)


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * scale, err_msg=what)


def _state(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal(
                (B, cfg.mamba_d_conv - 1, cfg.mamba_d_inner)).astype(np.float32),
            "ssm": rng.standard_normal(
                (B, cfg.mamba_d_inner, cfg.mamba_d_state)).astype(np.float32)}


def test_init_mamba_paths_shapes_and_dtypes(cfgs, params):
    """The port's leaves have the reference's names, shapes and dtypes
    (``A_log`` float32 in a bfloat16 model), and the deterministic ones
    equal the reference's: dt_bias, D, conv_b and the norms bit for bit,
    A_log = log(1..d_state) to the float32 rounding of two ``log``s."""
    cfg, jcfg = cfgs
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        ref = jm.init_mamba(jax.random.PRNGKey(0), jcfg, jdtype)
        port = tm.init_mamba(torch.Generator().manual_seed(0), cfg, dtype)
        want = {k: (tuple(a.shape), str(a.dtype)) for k, a in ref.items()}
        got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for k, t in port.items()}
        assert got == want
        assert port["A_log"].dtype == torch.float32
        for key in ("dt_bias", "D", "conv_b", "dt_norm", "b_norm", "c_norm"):
            np.testing.assert_array_equal(
                port[key].to(torch.float32).numpy(),
                np.asarray(ref[key]).astype(np.float32), err_msg=key)
        np.testing.assert_allclose(port["A_log"].numpy(),
                                   np.asarray(ref["A_log"]), rtol=2 ** -23)
    p = tm.init_mamba(torch.Generator().manual_seed(0), cfg, torch.float32)
    bound = cfg.resolved_dt_rank ** -0.5
    assert float(p["dt_proj"].abs().max()) <= bound


def test_ssm_inputs_and_rms_match_reference(cfgs, params):
    cfg, jcfg = cfgs
    p, tp = params
    u = np.random.default_rng(1).standard_normal(
        (B, 16, cfg.mamba_d_inner)).astype(np.float32)
    want = jax.jit(lambda p, u: jm._ssm_inputs(p, u, jcfg))(p, u)
    got = tm._ssm_inputs(tp, torch.tensor(u), cfg)
    for name, g, w in zip(("dt", "B", "C"), got, want):
        assert g.dtype == torch.float32
        _close(g, w, name)
    x = 30 * np.random.default_rng(2).standard_normal((4, 9)).astype(np.float32)
    scale = np.linspace(0.5, 2, 9).astype(np.float32)
    _close(tm._rms(torch.tensor(x), torch.tensor(scale)), jm._rms(x, scale))


def test_softplus_is_logaddexp():
    """jax.nn.softplus is logaddexp(x, 0) at every x, including above
    F.softplus's threshold of 20."""
    x = np.array([-80, -30, -1, 0, 0.5, 19, 20, 21, 40, 100], np.float32)
    np.testing.assert_array_equal(tm._softplus(torch.tensor(x)).numpy(),
                                  np.asarray(jax.nn.softplus(x)))


def test_scan_chunk_matches_reference(cfgs, params):
    cfg, _ = cfgs
    p, _ = params
    rng = np.random.default_rng(3)
    din, ds, L = cfg.mamba_d_inner, cfg.mamba_d_state, 24
    u = rng.standard_normal((B, L, din)).astype(np.float32)
    dt = np.abs(0.1 * rng.standard_normal((B, L, din))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, L, ds)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, din, ds)).astype(np.float32)
    A = -np.exp(p["A_log"])
    wh, wy = jm._scan_chunk(A, h0, u, dt, Bm, Cm)
    gh, gy = tm._scan_chunk(*(torch.tensor(a) for a in (A, h0, u, dt, Bm, Cm)))
    _close(gh, wh, "h")
    _close(gy, wy, "y")


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("S", [2, 16, 64, 70])
def test_mamba_forward_matches_reference(cfgs, params, S, carried):
    """Output and new state from a zero and from a carried state; S = 2 <
    d_conv - 1 keeps rows of the carried conv state in the new one, S = 70
    is padded by the reference and not by the port."""
    cfg, jcfg = cfgs
    p, tp = params
    x = np.random.default_rng(S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    state = _state(cfg, 10 + S) if carried else None
    jo, js = jax.jit(lambda p, x, s: jm.mamba_forward(p, x, jcfg, s))(
        p, x, state)
    to, ts = tm.mamba_forward(tp, torch.tensor(x), cfg,
                              None if state is None else from_numpy_tree(state))
    _close(to, jo, "out")
    assert ts["ssm"].dtype == torch.float32
    _close(ts["ssm"], js["ssm"], "ssm")
    _close(ts["conv"], js["conv"], "conv")
    keep = cfg.mamba_d_conv - 1 - S
    if carried and keep > 0:
        # the carried rows S.. lead the new conv state, bit for bit
        np.testing.assert_array_equal(ts["conv"][:, :keep].numpy(),
                                      state["conv"][:, S:])


def test_mamba_step_matches_reference(cfgs, params):
    cfg, jcfg = cfgs
    p, tp = params
    state = _state(cfg, 5)
    tstate = from_numpy_tree(state)
    rng = np.random.default_rng(6)
    for i in range(4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jo, state = jax.jit(lambda p, x, s: jm.mamba_step(p, x, jcfg, s))(
            p, x, state)
        to, tstate = tm.mamba_step(tp, torch.tensor(x), cfg, tstate)
        _close(to, jo, f"out {i}")
        _close(tstate["ssm"], state["ssm"], f"ssm {i}")
        _close(tstate["conv"], state["conv"], f"conv {i}")


def test_forward_then_steps_equal_one_forward(cfgs, params):
    """The state a forward leaves, carried through steps, equals a forward
    over the whole sequence (outputs and state)."""
    cfg, _ = cfgs
    _, tp = params
    x = torch.tensor(np.random.default_rng(7).standard_normal(
        (B, 20, cfg.d_model)).astype(np.float32))
    whole, wstate = tm.mamba_forward(tp, x, cfg)
    out, state = tm.mamba_forward(tp, x[:, :12], cfg)
    outs = [out]
    for t in range(12, 20):
        o, state = tm.mamba_step(tp, x[:, t:t + 1], cfg, state)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=0, atol=1e-5)
    for key in ("conv", "ssm"):
        torch.testing.assert_close(state[key], wstate[key], rtol=0, atol=1e-5)


def test_init_state_shapes(cfgs):
    cfg, jcfg = cfgs
    want = jm.init_mamba_state(jcfg, 3, jnp.float32)
    got = tm.init_mamba_state(cfg, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert got["ssm"].dtype == torch.float32
    bf = tm.init_mamba_state(cfg, 3, torch.bfloat16)
    assert bf["conv"].dtype == torch.bfloat16 and bf["ssm"].dtype == torch.float32
    spec = next(s for s in cfg.unit if s.mixer == "mamba")
    layer = init_layer_cache(cfg, spec, 3, 16, torch.float32)
    assert [p for p, _ in tree_paths(layer)] == [("conv",), ("ssm",)]


def test_hybrid_prefill_then_decode_equals_forward():
    """tests/test_models.py:62 on the port (its tiny hybrid: attention +
    dense, Mamba + MoE, two units), with the reference's params: the
    logits of one decode step after a prefill equal the last logits of a
    forward over the extended sequence.  The reference holds this to 5e-2;
    the port's exact sequential scan meets 1e-4."""
    from repro.models import ModelConfig as JModelConfig
    from repro.models.config import LayerSpec as JLayerSpec
    from repro_torch.models import LayerSpec, ModelConfig

    kw = dict(name="j", arch_type="hybrid", d_model=64, vocab_size=97,
              num_units=2, num_heads=4, num_kv_heads=2, d_ff=128,
              num_experts=4, num_experts_per_tok=2, mamba_d_state=8)
    jcfg = JModelConfig(unit=(JLayerSpec(mixer="attn", mlp="dense"),
                              JLayerSpec(mixer="mamba", mlp="moe")), **kw)
    cfg = ModelConfig(unit=(LayerSpec(mixer="attn", mlp="dense"),
                            LayerSpec(mixer="mamba", mlp="moe")), **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tp = from_numpy_tree(jax.tree.map(np.asarray,
                                      j_init(jax.random.PRNGKey(0), jcfg)))
    S = 16
    toks = np.random.default_rng(0).integers(0, 97, (2, S)).astype(np.int32)
    _, cache = prefill(tp, cfg, Batch(tokens=torch.from_numpy(toks)), S + 8)
    tok = torch.full((2, 1), 3, dtype=torch.int32)
    dec, _ = decode_step(tp, cfg, tok, torch.full((2,), S, dtype=torch.int32),
                         cache)
    full, _ = forward(tp, cfg, Batch(tokens=torch.cat(
        [torch.from_numpy(toks), tok], 1)))
    torch.testing.assert_close(dec, full[:, -1:], rtol=0, atol=1e-4)
