"""The port's optimizers and schedules against ``repro.optim``.

Both packages get the same numpy params and the same numpy gradients at
every step, so the comparison isolates the update rule.  Tolerances:
float32 params agree to ``rtol=3e-7, atol=1e-7`` (about two ulps; the step's
``b ** t`` and the schedules' ``cos`` are float32 in both, rounded by
different libraries, so the last bit may differ); bfloat16 moments agree
exactly or by one bfloat16 step (``rtol=2**-7``) where a float32
difference in the last bit rounds across a bfloat16 boundary.  The
schedules are held to ``rtol=1e-6`` at every step, step 0 included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch.convert import from_numpy_tree, to_numpy_tree

STEPS = 5


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)},
            "z": rng.standard_normal((3, 2, 4)).astype(np.float32)}


def _grads(step, scale):
    rng = np.random.default_rng(100 + step)
    return {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal((7,))).astype(np.float32)},
            "z": (scale * rng.standard_normal((3, 2, 4))).astype(np.float32)}


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        tree))


# name -> optimizer from a package (its module and its bfloat16 dtype)
CASES = {
    "sgd": lambda m, bf16: m.sgd(0.1),
    "sgd_momentum": lambda m, bf16: m.sgd(0.05, momentum=0.9),
    "sgd_nesterov": lambda m, bf16: m.sgd(0.05, momentum=0.9, nesterov=True),
    "sgd_wd": lambda m, bf16: m.sgd(m.linear_warmup_cosine(0.1, 2, STEPS),
                                    momentum=0.5, weight_decay=0.01),
    "adamw": lambda m, bf16: m.adamw(0.01),
    "adamw_wd_schedule": lambda m, bf16: m.adamw(
        m.linear_warmup_cosine(0.01, 2, STEPS), weight_decay=0.1),
    "adamw_clip": lambda m, bf16: m.adamw(0.01, grad_clip_norm=1.0),
    "adamw_bf16": lambda m, bf16: m.adamw(0.01, moment_dtype=bf16),
}


def _make(name, m):
    return CASES[name](m, jnp.bfloat16 if m is jopt else torch.bfloat16)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_update_matches_reference(name, scale):
    """5 steps on the same gradients; ``scale=1e3`` drives the clip."""
    jo, to = _make(name, jopt), _make(name, topt)
    jp = jax.tree.map(jnp.asarray, _params())
    tp = from_numpy_tree(_params())
    js, ts = jo.init(jp), to.init(tp)
    for step in range(STEPS):
        g = _grads(step, scale)
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, step)
        tp, ts = to.update(from_numpy_tree(g), ts, tp, step)
        for a, b in zip(_leaves(jp), jax.tree.leaves(to_numpy_tree(tp))):
            np.testing.assert_allclose(b, a, rtol=3e-7, atol=1e-7)
    if name == "adamw_bf16":
        for key in ("m", "v"):
            assert all(t.dtype == torch.bfloat16
                       for t in jax.tree.leaves(ts[key]))
            for a, b in zip(_leaves(js[key]),
                            jax.tree.leaves(to_numpy_tree(ts[key]))):
                np.testing.assert_allclose(b, a, rtol=2 ** -7, atol=0)
    else:
        for a, b in zip(_leaves(js), jax.tree.leaves(to_numpy_tree(ts))):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_update_is_pure():
    """Inputs are left as they were: the update returns new trees."""
    opt = topt.adamw(0.01, weight_decay=0.1)
    p = from_numpy_tree(_params())
    before = to_numpy_tree(p)
    state = opt.init(p)
    g = from_numpy_tree(_grads(0, 1.0))
    new_p, new_state = opt.update(g, state, p, 0)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(to_numpy_tree(p))):
        np.testing.assert_array_equal(a, b)
    assert all(float(t.abs().max()) == 0 for t in jax.tree.leaves(state["m"]))
    assert any(float(t.abs().max()) > 0 for t in jax.tree.leaves(new_state["m"]))


@pytest.mark.parametrize("sched,args", [
    ("constant", (0.1,)),
    ("cosine_decay", (1.0, 100)),
    ("cosine_decay", (3e-4, 37, 0.2)),
    ("linear_warmup_cosine", (1.0, 10, 100)),
    ("linear_warmup_cosine", (3e-4, 20, 100)),
    ("linear_warmup_cosine", (3e-4, 1, 3)),
    ("linear_warmup_cosine", (5e-3, 0, 50)),
])
def test_schedules_match_reference(sched, args):
    jf, tf = getattr(jopt, sched)(*args), getattr(topt, sched)(*args)
    for step in range(0, 130):
        want = np.float32(jf(step))
        got = tf(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)
        got_t = tf(torch.tensor(step, dtype=torch.int32))
        assert float(got_t) == float(got)
    if sched == "linear_warmup_cosine" and args[1] > 0:
        assert float(tf(0)) == 0.0


# ---- ports of tests/test_substrate.py's optimizer and schedule tests -----


def _quad_loss(p):
    return ((p["x"] - 3.0) ** 2).sum() + ((p["y"] + 1.0) ** 2).sum()


@pytest.mark.parametrize("opt", [
    topt.sgd(0.1), topt.sgd(0.05, momentum=0.9), topt.adamw(0.1),
    topt.adamw(0.1, moment_dtype=torch.bfloat16),
])
def test_optimizers_converge(opt):
    params = {"x": torch.zeros(3), "y": torch.ones(2)}
    state = opt.init(params)
    for step in range(300):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = torch.autograd.grad(_quad_loss(p), [p["x"], p["y"]])
        params, state = opt.update(dict(zip(("x", "y"), grads)), state,
                                   params, step)
    assert float(_quad_loss(params)) < 1e-2


def test_adamw_grad_clip():
    opt = topt.adamw(0.1, grad_clip_norm=1.0)
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    new, _ = opt.update({"x": torch.full((3,), 1e6)}, state, params, 0)
    assert float(new["x"].abs().max()) < 1.0


def test_schedules():
    assert float(topt.constant(0.1)(5)) == pytest.approx(0.1)
    cd = topt.cosine_decay(1.0, 100, final_frac=0.1)
    assert float(cd(0)) == pytest.approx(1.0)
    assert float(cd(100)) == pytest.approx(0.1, abs=1e-6)
    wc = topt.linear_warmup_cosine(1.0, 10, 100)
    assert float(wc(5)) == pytest.approx(0.5)
    assert float(wc(10)) == pytest.approx(1.0, rel=1e-2)
