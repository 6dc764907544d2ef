"""The port's train step against ``repro.launch.steps`` on one device.

The reference runs on a 1 x 1 host mesh under ``jax.jit``; its params,
AdamW state and step cross to the port through ``repro_torch.convert``,
and the same numpy tokens go to both.  Four dense smoke configs: olmo-1b
(non-parametric LayerNorm, tied embeddings), qwen1.5-4b (QKV bias),
phi4-mini (GQA, SwiGLU) and gemma3-4b (GeGLU, scaled embeddings, local /
global attention, a tail); and mixtral-8x7b and qwen3-moe-30b-a3b, whose
MoE router's load-balance loss is part of the loss and its gradients,
and rwkv6-7b; jamba-1.5-large-398b (the attention + Mamba / MoE hybrid),
hubert-xlarge (the audio frontend: no tokens, the loss on the masked
frames of the reference's ``hubert_batch``) and qwen2-vl-7b (the vision
frontend: patch embeddings and M-RoPE positions of the reference's
``vlm_batch``, whose ``loss_mask`` masks the image slots).  The MoE
configs run with ``moe_impl="dense"`` set on both packages (on a mesh
``"auto"`` takes the expert-parallel path, whose capacity can drop
tokens), and again at ``@auto``, both packages' default: the port's
steps on their default 1 x 1 ``LocalMesh`` against the reference's on
its 1 x 1 host mesh, capacity dispatch and drops on both sides.

Tolerances (float32 in both; the matmuls sum in another order than
XLA's):
  * losses: ``rtol=1e-6`` (O(1) values; about 5e-7 is seen);
  * gradients: each leaf within ``1e-5`` of that leaf's largest |g| in
    ``standard`` mode, ``3e-4`` in ``bflc`` mode.  The committee weights
    divide gaps between O(1) losses, O(1e-2) wide, by their spread, so
    one float32 ulp of a cohort loss moves a weight by up to about 4e-5
    (the weights themselves agree to 3e-8 on equal losses,
    ``test_committee_weights_match_reference``);
  * three AdamW steps under ``linear_warmup_cosine(1e-2, 1, 3)``: params
    within ``atol=3e-5``, moments within the gradients' tolerance of
    each leaf's largest value.  The steps use ``eps=1e-3``: with the default 1e-8, a
    coordinate whose gradient is within float32 rounding of zero can
    flip the sign of Adam's normalized update (about ``lr`` either way),
    so such a comparison would measure rounding, not the step.  The
    default eps is held on identical gradients in test_torch_optim.py.

The non-dense archs (with jamba) are held to tolerances of their own
(``NON_DENSE_TOL``); hubert and qwen2-vl, dense models behind their
frontends, to the dense ones.  RWKV-6's float32 gradients are ill-conditioned in
both packages (the chunked WKV's exponentials of cumulative decays, the
per-head group norm's division by a small spread): the two packages'
gradients sit further apart than the dense archs' 1e-5, and each as far
from a float64 gradient of the same loss.  Over the three AdamW steps
(eps 1e-3, lr 1e-2) a gradient gap g moves a param by up to about
3 * lr * g / eps, and the MoE archs' bflc committee weights magnify a
loss's last bits as the dense archs' do: hence the looser param, moment
and loss tolerances of these cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_host_mesh
from repro.launch.shardings import ShardingPolicy
from repro.launch import steps as jsteps
from repro.models import init_model as j_init
from repro.models.frontends import hubert_batch as j_hubert_batch
from repro.models.frontends import vlm_batch as j_vlm_batch
from repro.models.transformer import Batch as JBatch
from repro.optim import adamw as j_adamw
from repro.optim import linear_warmup_cosine as j_lwc
from repro_torch.configs import registry
from repro_torch.convert import (
    from_numpy_tree,
    to_numpy_tree,
    train_state_from_numpy,
    train_state_to_numpy,
)
from repro_torch.launch import steps
from repro_torch.models.transformer import Batch
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.tree import tree_paths

torch.set_num_threads(2)
DENSE = ("olmo-1b", "qwen1.5-4b", "phi4-mini-3.8b", "gemma3-4b")
NON_DENSE = ("mixtral-8x7b", "qwen3-moe-30b-a3b", "rwkv6-7b",
             "jamba-1.5-large-398b")
MOE_AUTO = ("mixtral-8x7b@auto", "qwen3-moe-30b-a3b@auto",
            "jamba-1.5-large-398b@auto")
FRONTENDS = ("hubert-xlarge", "qwen2-vl-7b")
B, S = 8, 16
LOSS_RTOL = 1e-6
GRAD_RTOL = {"standard": 1e-5, "bflc": 3e-4}
PARAM_ATOL = 3e-5
NON_DENSE_TOL = dict(loss_rtol=1e-5, grad_rtol={"standard": 1e-4, "bflc": 3e-4},
                     param_atol=1e-3, moment_rtol=1e-3)


@pytest.fixture(scope="module")
def mesh_pol():
    return (make_host_mesh(1, 1),
            ShardingPolicy(dp_axes=("data",), model_axis_size=1, fsdp=False))


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jax.tree.map(np.asarray, j_init(
                jax.random.PRNGKey(7), jreg.smoke_config(arch)))
        return cache[arch]

    return get


def _ref_cfg(arch):
    """The reference's smoke config, its MoE on the dense path unless the
    case is ``<arch>@auto``."""
    import dataclasses

    name, _, impl = arch.partition("@")
    cfg = jreg.smoke_config(name)
    if cfg.num_experts and impl != "auto":
        cfg = dataclasses.replace(cfg, moe_impl="dense")
    return cfg


def _port_cfg(arch):
    """The port's smoke config with the same MoE implementation."""
    return registry.smoke_config(arch.partition("@")[0]).replace(
        moe_impl=_ref_cfg(arch).moe_impl)


def _base(arch):
    return arch.partition("@")[0]


def _tokens(vocab, rows, seed):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (rows, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _batches(vocab, rows, seed, mask=None):
    """(reference Batch, port Batch) of the same numpy tokens."""
    toks, tgts = _tokens(vocab, rows, seed)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (rows, S))
    m = np.ones((rows, S), np.float32) if mask is None else mask
    jb = JBatch(tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                targets=jnp.asarray(tgts), loss_mask=jnp.asarray(m))
    tb = Batch(tokens=torch.tensor(toks), positions=torch.tensor(pos),
               targets=torch.tensor(tgts), loss_mask=torch.tensor(m))
    return jb, tb


def _arch_batches(jcfg, rows, seed, mask=None):
    """(reference Batch, port Batch) for an arch: numpy tokens for a text
    model (``_batches``), else the reference's own frontend batch (a 2 x 2
    patch grid amid text for the vision model) carried across as numpy."""
    if not jcfg.frontend:
        return _batches(jcfg.vocab_size, rows, seed, mask)
    key = jax.random.PRNGKey(seed)
    if jcfg.frontend == "audio":
        jb = j_hubert_batch(key, jcfg, rows, S)
    else:
        jb = j_vlm_batch(key, jcfg, rows, S, image_patches=4, grid=(2, 2))
    if mask is not None:
        jb = jb._replace(loss_mask=jb.loss_mask * mask)
    return jb, Batch(**{k: None if v is None else torch.from_numpy(np.array(v))
                        for k, v in jb._asdict().items()})


def _key_paths(tree):
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p): l
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_leafwise(port_tree, ref_tree, rtol, what):
    """Each leaf within ``rtol`` of the reference leaf's largest |value|."""
    ref = _key_paths(jax.tree.map(np.asarray, ref_tree))
    ours = tree_paths(port_tree)
    assert [p for p, _ in ours] == list(ref)
    for path, t in ours:
        want = ref[path].astype(np.float32)
        got = t.detach().to(torch.float32).numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max())
        assert err <= rtol * scale, (what, path, err, scale)


# ---- losses -------------------------------------------------------------------


def test_token_ce_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 5, 50))).astype(np.float32)
    tgts = rng.integers(0, 50, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32)
    jn, jm = jsteps.token_ce(jnp.asarray(logits), jnp.asarray(tgts),
                             jnp.asarray(mask))
    tn, tm = steps.token_ce(torch.tensor(logits), torch.tensor(tgts),
                            torch.tensor(mask))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("committee", [4, 3])
@pytest.mark.parametrize("arch", ("olmo-1b", "gemma3-4b") + NON_DENSE
                         + FRONTENDS + MOE_AUTO)
def test_losses_and_grads_match_reference(arch, committee, mesh_pol,
                                          ref_params):
    """standard_loss and bflc_loss (Q even and odd) and their gradients."""
    mesh, pol = mesh_pol
    jcfg, cfg = _ref_cfg(arch), _port_cfg(arch)
    ctx = jsteps.make_moe_ctx(jcfg, mesh, pol, batch_sharded=True)
    p_np = ref_params(_base(arch))
    mask = np.ones((B, S), np.float32)
    mask[1, 5:] = 0.0
    jb, tb = _arch_batches(jcfg, B, 1, mask)
    jv, tv = _arch_batches(jcfg, 4, 2)
    jfns = {
        "standard": lambda p: jsteps.standard_loss(p, jcfg, jb, ctx),
        "bflc": lambda p: jsteps.bflc_loss(p, jcfg, jb, jv, ctx,
                                           num_cohorts=4,
                                           committee_size=committee),
    }
    for mode, jfn in jfns.items():
        (jtot, jce), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            jax.tree.map(jnp.asarray, p_np))
        grad_fn = steps.make_grad_fn(cfg, mode=mode, num_cohorts=4,
                                     committee_size=committee)
        tg, ttot, tce = grad_fn(from_numpy_tree(p_np), tb, tv)
        np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tce), float(jce), rtol=LOSS_RTOL)
        rtol = (NON_DENSE_TOL["grad_rtol"] if _base(arch) in NON_DENSE
                else GRAD_RTOL)[mode]
        _assert_leafwise(tg, jg, rtol, f"{mode} grads")
        if jcfg.num_experts:     # the router's aux loss is in the total
            assert float(ttot) - float(tce) > 0.0


def _reference_weights(jcfg, p, jb, jv, ctx, C, Q):
    """The reference's committee weights, by the same jnp calls as its
    ``bflc_loss``; held against its returned loss (sum of w * cohort loss)."""
    from repro.models import forward

    logits, _ = forward(p, jcfg, jb, ctx)
    nll, mask = jsteps.token_ce(logits, jb.targets, jb.loss_mask)
    cl = nll.reshape(C, -1).sum(1) / jnp.maximum(mask.reshape(C, -1).sum(1), 1.0)
    vlogits, _ = forward(p, jcfg, jv, ctx)
    vnll, vmask = jsteps.token_ce(vlogits, jv.targets, jv.loss_mask)
    member = (vnll.sum(-1) / jnp.maximum(vmask.sum(-1), 1.0))[:Q]
    med = jnp.median(-jnp.abs(cl[:, None] - member[None, :]), axis=1)
    w = jax.nn.softmax(med / jnp.maximum(med.std(), 1e-6))
    _, loss = jsteps.bflc_loss(p, jcfg, jb, jv, ctx, C, Q)
    np.testing.assert_allclose(float(jnp.sum(w * cl)), float(loss), rtol=1e-6)
    return np.asarray(w), np.asarray(cl), np.asarray(member)


@pytest.mark.parametrize("committee", [4, 3])
def test_poisoned_cohort_gets_smallest_weight(committee, mesh_pol, ref_params):
    """Cohort 0's targets are poisoned (each is the token the model finds
    least likely there, as a label-flipping attacker would pick): its loss
    is anomalous and both packages give it the smallest committee weight.
    (The reference's own test, tests/test_multidevice.py::
    test_bflc_mode_train_step_downweights_poisoned_cohort, checks only
    that the loss is finite.)"""
    mesh, pol = mesh_pol
    arch = "olmo-1b"
    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    ctx = jsteps.make_moe_ctx(jcfg, mesh, pol, batch_sharded=True)
    p_np = ref_params(arch)
    tp = from_numpy_tree(p_np)
    toks, tgts = _tokens(cfg.vocab_size, B, 1)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    with torch.no_grad():
        logits, _ = steps.forward(tp, cfg, Batch(tokens=torch.tensor(toks),
                                                 positions=torch.tensor(pos)))
    tgts = tgts.copy()
    tgts[:B // 4] = logits[:B // 4].argmin(-1).numpy()
    args = dict(tokens=toks, positions=pos, targets=tgts,
                loss_mask=np.ones((B, S), np.float32))
    jb = JBatch(**{k: jnp.asarray(v) for k, v in args.items()})
    tb = Batch(**{k: torch.tensor(np.ascontiguousarray(v))
                  for k, v in args.items()})
    jv, tv = _batches(cfg.vocab_size, 4, 2)
    jw, _, _ = _reference_weights(jcfg, jax.tree.map(jnp.asarray, p_np), jb,
                                  jv, ctx, 4, committee)
    with torch.no_grad():
        logits, _ = steps.forward(tp, cfg, tb)
        nll, mask = steps.token_ce(logits, tb.targets, tb.loss_mask)
        cl = nll.reshape(4, -1).sum(1) / mask.reshape(4, -1).sum(1)
        vlogits, _ = steps.forward(tp, cfg, tv)
        vnll, vmask = steps.token_ce(vlogits, tv.targets, tv.loss_mask)
        member = (vnll.sum(-1) / vmask.sum(-1))[:committee]
        tw = steps.committee_weights(cl, member)
    assert int(np.argmin(jw)) == 0 and int(torch.argmin(tw)) == 0
    np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-4, atol=1e-7)
    _, ce = steps.bflc_loss(tp, cfg, tb, tv, None, 4, committee)
    np.testing.assert_allclose(float(ce), float(torch.sum(tw * cl)), rtol=1e-6)


def test_committee_weights_match_reference():
    """On equal float32 losses the weights are the reference's jnp ones."""
    rng = np.random.default_rng(0)
    for q in (3, 4):
        for _ in range(5):
            cl = (6.9 + 0.02 * rng.standard_normal(4)).astype(np.float32)
            ml = (6.9 + 0.02 * rng.standard_normal(q)).astype(np.float32)
            med = jnp.median(-jnp.abs(cl[:, None] - ml[None, :]), axis=1)
            want = jax.nn.softmax(med / jnp.maximum(med.std(), 1e-6))
            got = steps.committee_weights(torch.tensor(cl), torch.tensor(ml))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_median_is_jnp_median():
    x = np.random.default_rng(0).standard_normal((5, 6)).astype(np.float32)
    for q in (1, 2, 3, 4, 6):
        np.testing.assert_array_equal(
            steps._median_last(torch.tensor(x[:, :q])).numpy(),
            np.asarray(jnp.median(jnp.asarray(x[:, :q]), axis=1)))


# ---- the train step ------------------------------------------------------------


def _opts(lr=1e-2):
    return (j_adamw(j_lwc(lr, 1, 3), eps=1e-3),
            adamw(linear_warmup_cosine(lr, 1, 3), eps=1e-3))


@pytest.mark.parametrize("mode", ["standard", "bflc"])
@pytest.mark.parametrize("arch", DENSE + NON_DENSE + FRONTENDS + MOE_AUTO)
def test_train_step_matches_reference(arch, mode, mesh_pol, ref_params):
    tol = (NON_DENSE_TOL if _base(arch) in NON_DENSE else
           dict(loss_rtol=LOSS_RTOL, grad_rtol=GRAD_RTOL,
                param_atol=PARAM_ATOL, moment_rtol=GRAD_RTOL[mode]))
    mesh, pol = mesh_pol
    jcfg, cfg = _ref_cfg(arch), _port_cfg(arch)
    jopt, opt = _opts()
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, mesh, pol, mode=mode,
                                           num_cohorts=4, committee_size=4))
    step = steps.make_train_step(cfg, opt, mode=mode, num_cohorts=4,
                                 committee_size=4)
    p = jax.tree.map(jnp.asarray, ref_params(_base(arch)))
    js = jsteps.TrainState(p, jopt.init(p), jnp.zeros((), jnp.int32))
    n = lambda t: jax.tree.map(np.asarray, t)
    ts = train_state_from_numpy(n(js.params), n(js.opt_state), js.step)
    for i in range(3):
        jb, tb = _arch_batches(jcfg, B, 10 + i)
        jv, tv = _arch_batches(jcfg, 4, 20 + i)
        js, jm = jstep(js, jb, jv if mode == "bflc" else None)
        ts, tm = step(ts, tb, tv if mode == "bflc" else None)
        for key in ("loss", "total_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=tol["loss_rtol"])
    assert int(ts.step) == int(js.step) == 3
    params, opt_state, step_np = train_state_to_numpy(ts)
    assert step_np.dtype == np.int32 and int(step_np) == 3
    ref = _key_paths(n(js.params))
    for path, t in tree_paths(ts.params):
        np.testing.assert_allclose(t.numpy(), ref[path], rtol=0,
                                   atol=tol["param_atol"], err_msg=str(path))
    for key in ("m", "v"):
        _assert_leafwise(ts.opt_state[key], js.opt_state[key],
                         tol["moment_rtol"], key)


def test_first_step_moves_nothing():
    """linear_warmup_cosine gives lr 0 at step 0: the first step leaves the
    params bit for bit, and the second moves them."""
    cfg = registry.smoke_config("olmo-1b")
    _, opt = _opts()
    step = steps.make_train_step(cfg, opt, mode="standard")
    from repro_torch.models import init_model

    p = init_model(torch.Generator().manual_seed(0), cfg)
    state = steps.TrainState(p, opt.init(p), torch.zeros((), dtype=torch.int32))
    _, tb = _batches(cfg.vocab_size, B, 0)
    s1, _ = step(state, tb)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_paths(s1.params), tree_paths(p)))
    s2, _ = step(s1, tb)
    assert not all(torch.equal(a, b) for (_, a), (_, b)
                   in zip(tree_paths(s2.params), tree_paths(p)))


@pytest.mark.parametrize("mode", ["standard", "bflc"])
def test_microbatches_match_reference(mode, mesh_pol, ref_params):
    """num_microbatches=2 against the reference's scan, and (standard, equal
    token counts) against one microbatch."""
    mesh, pol = mesh_pol
    arch = "phi4-mini-3.8b"
    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    jopt, opt = _opts()
    p_np = ref_params(arch)
    jb, tb = _batches(cfg.vocab_size, B, 3)
    jv, tv = _batches(cfg.vocab_size, 4, 4)
    C = 2
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, mesh, pol, mode=mode,
                                           num_cohorts=C, committee_size=4,
                                           num_microbatches=2))
    p = jax.tree.map(jnp.asarray, p_np)
    js = jsteps.TrainState(p, jopt.init(p), jnp.ones((), jnp.int32))
    js, jm = jstep(js, jb, jv if mode == "bflc" else None)
    grad2 = steps.make_grad_fn(cfg, mode=mode, num_cohorts=C,
                               committee_size=4, num_microbatches=2)
    g2, tot2, ce2 = grad2(from_numpy_tree(p_np), tb, tv)
    np.testing.assert_allclose(float(ce2), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tot2), float(jm["total_loss"]),
                               rtol=LOSS_RTOL)
    # the reference's first-moment after one step at step 1 is 0.1 * g
    m = jax.tree.map(lambda x: x / 0.1, js.opt_state["m"])
    _assert_leafwise(g2, m, GRAD_RTOL[mode], "microbatched grads")
    if mode == "standard":
        g1, _, ce1 = steps.make_grad_fn(cfg, mode=mode)(from_numpy_tree(p_np),
                                                        tb)
        np.testing.assert_allclose(float(ce1), float(ce2), rtol=LOSS_RTOL)
        _assert_leafwise(g2, to_numpy_tree(g1), GRAD_RTOL[mode],
                         "mb=2 vs mb=1")


def test_microbatches_split_mrope_positions(mesh_pol, ref_params):
    """qwen2-vl's (3, B, S) M-RoPE positions split on their batch axis:
    num_microbatches=2 matches the reference's scan (losses and the
    first moment of one AdamW step)."""
    mesh, pol = mesh_pol
    arch = "qwen2-vl-7b"
    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    jopt, _ = _opts()
    p_np = ref_params(arch)
    jb, tb = _arch_batches(jcfg, B, 3)
    assert tuple(tb.positions.shape) == (3, B, S)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, mesh, pol,
                                           mode="standard",
                                           num_microbatches=2))
    p = jax.tree.map(jnp.asarray, p_np)
    js, jm = jstep(jsteps.TrainState(p, jopt.init(p), jnp.ones((), jnp.int32)),
                   jb)
    g2, _, ce2 = steps.make_grad_fn(cfg, mode="standard", num_microbatches=2)(
        from_numpy_tree(p_np), tb)
    np.testing.assert_allclose(float(ce2), float(jm["loss"]), rtol=LOSS_RTOL)
    m = jax.tree.map(lambda x: x / 0.1, js.opt_state["m"])
    _assert_leafwise(g2, m, GRAD_RTOL["standard"], "microbatched grads")


@pytest.mark.parametrize("mode", ["standard", "bflc"])
def test_remat_gives_equal_grads(mode, ref_params):
    """remat True (per unit) and "layer" recompute the same forward: the
    gradients equal those without remat, bit for bit on the CPU."""
    import dataclasses

    arch = "gemma3-4b"
    base = registry.smoke_config(arch)
    p = from_numpy_tree(ref_params(arch))
    _, tb = _batches(base.vocab_size, B, 5)
    _, tv = _batches(base.vocab_size, 4, 6)
    out = {}
    for remat in (False, True, "layer"):
        cfg = dataclasses.replace(base, remat=remat)
        g, tot, _ = steps.make_grad_fn(cfg, mode=mode, num_cohorts=4,
                                       committee_size=4)(p, tb, tv)
        out[remat] = (g, tot)
    for remat in (True, "layer"):
        assert float(out[remat][1]) == float(out[False][1])
        for (path, a), (_, b) in zip(tree_paths(out[remat][0]),
                                     tree_paths(out[False][0])):
            assert torch.equal(a, b), (remat, path)
