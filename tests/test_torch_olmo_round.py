"""OLMo's BFLC round on the port: the model against a plain reference, and
the streamed per-client round against the batched program.

Model: olmo-1b's smoke config (d 128, 2 units, 4 heads of 32, SwiGLU 256,
vocab 1024, tied embedding) with OLMo's LayerNorm eps of 1e-5, through
the port's ``lm_adapter``.  The reference is ``olmo_reference.py`` beside
this file, a copy of the benchmark's ``bench/reference/olmo.py``: plain
PyTorch that imports nothing of the port.

* The adapter against the reference at seeded random weights: logits,
  loss and every leaf's gradient of the port in float32 against the
  reference in float64.  Tolerances: relative to the largest entry of
  each tensor, 2e-5 for the logits (measured under 2e-6: float32
  round-off through 2 blocks and a 1024-way head, with room), 1e-5 for
  the loss (measured under 1e-6) and 1e-4 for a gradient (measured under
  1e-5: the backward adds the softmax's and the norms' round-off).
* The streamed round against the batched program: runtimes built alike
  from one seed, one given the same int8 validator behind a wrapper,
  which is no ``Int8CommitteeValidator``, so that its rounds do not
  stream (the batched trainer, one flatten, one ``quantize_stack``, one
  ``fused_candidates`` a cohort), 2 rounds each at P = 1, 4, 5 (5 with a quarter of the nodes
  malicious under the gaussian attack, so poisoning comes between a
  client's training and its quantization) and under the async schedule.
  Held bit for bit: each client's f32 update row, each cohort's int8
  rows and score matrix, the stored blobs, the ``RoundLog``s, the chain's
  hashes and the final model.
* No f32 tensor of more than one client's padded row is made by the
  streamed trainer or validator (a dispatch-mode spy over both stages;
  the batched program's (P, D) stacks are caught by the same spy).
* A recorded streamed round carries the spans ``train.client``,
  ``train.quantize`` and ``validate.rebuild`` and the counter
  ``live_bytes`` (0 on the CPU).
* Which runtimes stream, and the CNN's batched int8 scorer calling
  ``quantize_stack`` and ``fused_candidates`` once a cohort.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import grad
from torch.utils._python_dispatch import TorchDispatchMode

import olmo_reference as ref
from repro_torch.api import build_runtime
from repro_torch.configs import olmo_1b
from repro_torch.data import FederatedDataset, MarkovLM
from repro_torch.data import make_femnist_like
from repro_torch.fl import client as client_mod
from repro_torch.fl.adapter import femnist_adapter, lm_adapter
from repro_torch.fl.pipeline import resolve, streams_int8
from repro_torch.models import init_model
from repro_torch.tree import tree_leaves, tree_paths, tree_unstack

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CLIENTS, ROWS, SEQ = 16, 24, 16
BASE = dict(local_steps=2, local_batch=4, val_batch=8, use_kernels=True,
            quantize_chain=True, seed=0)
INT8 = {"validator": "committee_int8"}
# P trainers: active_proportion of 16 clients, Q = max(3, 0.4 x active)
COHORTS = {1: dict(active_proportion=0.25, k_updates=1),
           4: dict(active_proportion=0.4375, k_updates=3),
           5: dict(active_proportion=0.5, k_updates=3)}


def smoke_cfg():
    return olmo_1b.get_config(d_model=128, num_units=2, num_heads=4,
                              num_kv_heads=4, d_ff=256, vocab_size=1024,
                              norm_eps=1e-5)


def ref_cfg(cfg):
    return {"num_heads": cfg.num_heads, "norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta}


class F64:
    dtype = torch.float64

    @staticmethod
    def operand(x):
        return x


@pytest.fixture(scope="module")
def model():
    cfg = smoke_cfg()
    adapter = lm_adapter(cfg)
    lm = MarkovLM(cfg.vocab_size, seed=1)
    rng = np.random.default_rng(0)
    images, labels = [], []
    for _ in range(CLIENTS):
        rows = lm.sample(rng, ROWS, SEQ + 1,
                         dialect=rng.permutation(lm.branching))
        images.append(rows[:, :-1])
        labels.append(rows[:, 1:])
    test = lm.sample(rng, 8, SEQ + 1)
    ds = FederatedDataset(images, labels, test[:, :-1], test[:, 1:])
    init = init_model(torch.Generator().manual_seed(0), cfg)
    return dict(cfg=cfg, adapter=adapter, ds=ds, init=init)


# ----------------------------------------------------------------------
# the adapter against the plain reference
# ----------------------------------------------------------------------
def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def test_lm_adapter_matches_the_plain_reference(model):
    cfg, adapter, params = model["cfg"], model["adapter"], model["init"]
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, SEQ),
                                           dtype=np.int32))
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, SEQ),
                                            dtype=np.int32))
    p64 = params
    from repro_torch.models import forward
    from repro_torch.models.transformer import Batch

    pos = torch.arange(SEQ, dtype=torch.int32)[None].expand(2, SEQ)
    got, _ = forward(params, cfg, Batch(tokens=tokens, positions=pos))
    want = ref.logits(p64, tokens, ref_cfg(cfg), F64)
    assert rel_gap(got, want) < 2e-5
    loss = adapter.loss(params, tokens, targets)
    want_loss = ref.loss(p64, tokens, targets, ref_cfg(cfg), F64)
    assert abs(float(loss) - float(want_loss)) / float(want_loss) < 1e-5
    grads = grad(adapter.loss)(params, tokens, targets)
    live = [leaf.double().requires_grad_() for leaf in tree_leaves(params)]
    tree = ref._unflatten(params, live)
    want_grads = torch.autograd.grad(
        ref.loss(tree, tokens, targets, ref_cfg(cfg), F64), live)
    names = [p for p, _ in tree_paths(params)]
    assert [p for p, _ in ref.paths(params)] == names
    for name, g, w in zip(names, tree_leaves(grads), want_grads):
        assert rel_gap(g, w) < 1e-4, name


def test_reference_trainer_is_momentum_sgd(model):
    """Two steps of the reference's local SGD against the port's
    single-client program, both in float32 on one client: each leaf to
    1e-4 of its largest entry (measured 1.1e-5, the two programs' float32
    round-off)."""
    cfg, adapter, params = model["cfg"], model["adapter"], model["init"]
    ds = model["ds"]
    xs = torch.from_numpy(ds.client_images[0][:8].reshape(2, 4, SEQ))
    ys = torch.from_numpy(ds.client_labels[0][:8].reshape(2, 4, SEQ))

    class F32:
        dtype = torch.float32

        @staticmethod
        def operand(x):
            return x

    upd = ref.train_client(params, xs, ys, ref_cfg(cfg), 0.05, 0.9, F32)
    program = client_mod.make_one_client_fn(adapter, 0.05, 0.9)
    want = program(params, xs, ys)
    for a, b in zip(tree_leaves(upd), tree_leaves(want)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_reference_copy_matches_the_benchmark_and_loads_no_port():
    here = Path(__file__).with_name("olmo_reference.py")
    assert here.read_bytes() == (ROOT / "bench/reference/olmo.py").read_bytes()
    probe = (f"import sys; sys.path.insert(0, {str(here.parent)!r})\n"
             "import olmo_reference, json\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"repro", "repro_torch", "jax", "jaxlib", "flax"}


# ----------------------------------------------------------------------
# the streamed round against the batched program
# ----------------------------------------------------------------------
def flat_row(tree) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1).float() for leaf in tree_leaves(tree)])


class Batched:
    """The int8 validator behind a wrapper: the same scores, but no
    ``Int8CommitteeValidator``, so a runtime given it runs the batched
    program."""

    def __init__(self):
        self.inner = resolve("validator", "committee_int8")

    def __getattr__(self, attr):
        return getattr(self.inner, attr)

    def __call__(self, ctx):
        self.inner(ctx)


def stages(stream: bool) -> dict:
    return INT8 if stream else {"validator": Batched()}


def streamed(rt) -> bool:
    return streams_int8(rt.adapter, rt.cfg, rt.pipeline, rt.mesh)


def drive(model, P: int, stream: bool, malicious: float = 0.0,
          schedule: str = "sequential", rounds: int = 2) -> dict:
    """Runs ``rounds`` rounds and records each cohort's trained f32 update
    rows (before any poisoning), int8 rows, poisoned rows and scores, every
    update block's blob and the chain."""
    cfg = dict(BASE, **COHORTS[P], malicious_fraction=malicious)
    rt = build_runtime(model["adapter"], model["ds"], cfg,
                       initial_params=model["init"], stages=stages(stream),
                       schedule=schedule, device="cpu")
    assert streamed(rt) == stream and rt.p_trainers == P
    rec = {"f32": [], "int8": [], "scores": [], "poisoned": []}
    trainer, validator = rt.pipeline.local_trainer, rt.pipeline.validator
    client_fn = rt._client_train

    def spy_client(params, xs, ys):
        update = client_fn(params, xs, ys)
        rec["f32"].append(flat_row(update))
        return update

    class Trainer:
        def __getattr__(self, attr):
            return getattr(trainer, attr)

        def finalize(self, ctx):
            if not stream:             # the trained rows, before poisoning
                rec["f32"].extend(flat_row(u) for u in tree_unstack(
                    ctx.train_inflight, len(ctx.trainers)))
            trainer.finalize(ctx)
            rec["poisoned"].append(list(ctx.cohort_poisoned))

        def __call__(self, ctx):
            self.dispatch(ctx)
            self.finalize(ctx)

    class Validator:
        def __getattr__(self, attr):
            return getattr(validator, attr)

        def finalize(self, ctx):
            validator.finalize(ctx)
            rec["scores"].append(np.array(ctx.cohort_scores))
            rec["int8"].append([(e.q[e.i].clone(), e.scales[e.i].clone())
                                for e in (ctx.row_quant[u]
                                          for u in ctx.trainers)])

        def __call__(self, ctx):
            self.dispatch(ctx)
            self.finalize(ctx)

    rt._client_train = spy_client
    rt.pipeline.local_trainer, rt.pipeline.validator = Trainer(), Validator()
    rec["logs"] = [rt.run_round() for _ in range(rounds)]
    rec["blobs"] = [(b.payload["q"].clone(), b.payload["scales"].clone())
                    for b in rt.chain.blocks if b.kind == "update"]
    rec["hashes"] = [b.hash for b in rt.chain.blocks]
    rec["params"] = flat_row(rt.global_params())
    rec["verify"] = rt.chain.verify()
    return rec


def same_tensors(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("P,malicious,schedule", [
    (1, 0.0, "sequential"), (4, 0.0, "sequential"),
    (5, 0.25, "sequential"), (5, 0.0, "async")])
def test_streamed_round_is_the_batched_program(model, P, malicious,
                                               schedule):
    got = drive(model, P, True, malicious, schedule)
    want = drive(model, P, False, malicious)
    assert got["verify"] and want["verify"]
    assert len(got["f32"]) == 2 * P
    assert same_tensors(got["f32"], want["f32"])
    assert len(got["int8"]) == len(want["int8"]) == 2
    for g, w in zip(got["int8"], want["int8"]):
        assert same_tensors([t for pair in g for t in pair],
                            [t for pair in w for t in pair])
    for g, w in zip(got["scores"], want["scores"]):
        np.testing.assert_array_equal(g, w)
    assert same_tensors([t for pair in got["blobs"] for t in pair],
                        [t for pair in want["blobs"] for t in pair])
    assert got["logs"] == want["logs"]
    assert got["hashes"] == want["hashes"]
    assert torch.equal(got["params"], want["params"])
    assert got["poisoned"] == want["poisoned"]
    assert any(got["poisoned"]) == bool(malicious)


class LargestF32(TorchDispatchMode):
    """The most elements of any float32 tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                self.most = max(self.most, t.numel())
        return out


def largest_f32_in_stages(model, P: int, stream: bool) -> tuple:
    rt = build_runtime(model["adapter"], model["ds"], dict(BASE, **COHORTS[P]),
                       initial_params=model["init"], stages=stages(stream),
                       device="cpu")
    assert streamed(rt) == stream
    spy = LargestF32()
    trainer, validator = rt.pipeline.local_trainer, rt.pipeline.validator

    def watched(stage):
        def run(ctx):
            with spy:
                stage(ctx)
        return run

    rt.pipeline.local_trainer = watched(trainer)
    validate = watched(validator)
    validate.prepare = validator.prepare
    rt.pipeline.validator = validate
    rt.run_round()
    return spy.most, rt.chain.codec.dim


def test_no_cohort_wide_f32_tensor_when_streamed(model):
    from repro_torch.kernels.ops import padded_dim

    P = 5
    most, D = largest_f32_in_stages(model, P, True)
    assert most <= padded_dim(D), (most, D)
    batched, _ = largest_f32_in_stages(model, P, False)
    assert batched >= P * D          # the spy sees the batched stacks


def test_recorded_streamed_round_has_the_new_spans(model):
    cfg = dict(BASE, **COHORTS[4])
    rt = build_runtime(model["adapter"], model["ds"], cfg,
                       initial_params=model["init"], stages=INT8,
                       device="cpu")
    rt.run_round()
    entry = rt.stage_timings[-1]
    for name, parent in (("train.client", "train.steps"),
                         ("train.quantize", "train.steps"),
                         ("validate.rebuild", "validate"),
                         ("validate.score", "validate")):
        assert name in entry.spans, name
        assert set(entry.spans[name].parents) == {parent}, name
        assert entry.spans[name].host_s > 0
    assert entry.counts["live_bytes"] == 0          # no CUDA allocator here


# ----------------------------------------------------------------------
# which runtimes stream; the CNN's batched scorer
# ----------------------------------------------------------------------
def test_which_runtimes_stream(model):
    def built(adapter, ds, **kw):
        return build_runtime(adapter, ds, dict(BASE, **COHORTS[4]),
                             initial_params=kw.pop("init", None),
                             device="cpu", **kw)

    lm, ds, init = model["adapter"], model["ds"], model["init"]
    assert streamed(built(lm, ds, init=init, stages=INT8))
    assert not streamed(built(lm, ds, init=init))         # f32 committee
    assert not streamed(built(lm, ds, init=init, stages=dict(
        INT8, packer="top_k")))                           # stores f32 trees
    assert not streamed(built(lm, ds, init=init, stages=INT8, tiers=2))
    cnn = make_femnist_like(num_clients=16, mean_samples=20, test_size=20,
                            seed=1)
    assert not streamed(built(femnist_adapter(4), cnn, stages=INT8))


def test_cnn_scores_a_cohort_in_one_quantize_and_one_rebuild(monkeypatch):
    calls = {"quantize_stack": 0, "candidates_from_quantized": 0}
    for name in calls:
        fn = getattr(client_mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(client_mod, name, counted)
    ds = make_femnist_like(num_clients=16, mean_samples=20, test_size=20,
                           seed=1)
    rt = build_runtime(femnist_adapter(4), ds, dict(BASE, **COHORTS[4]),
                       stages=INT8, device="cpu")
    assert not streamed(rt)
    validator, cohorts = rt.pipeline.validator, []

    class Counted:
        def __getattr__(self, attr):
            return getattr(validator, attr)

        def __call__(self, ctx):
            cohorts.append(ctx.cohort)
            validator(ctx)

    rt.pipeline.validator = Counted()
    rt.run(2, eval_every=2)
    assert cohorts and calls == {"quantize_stack": len(cohorts),
                                 "candidates_from_quantized": len(cohorts)}
