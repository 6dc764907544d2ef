"""An LM's BFLC round on the port against the reference's.

Model: olmo-1b's smoke config (d 128, 2 units, 4 heads, vocab 1024)
through each package's ``lm_adapter``.  Data: a ``FederatedDataset``
whose "images" are ``MarkovLM(1024, seed=1)`` token rows and whose
"labels" are the next tokens: 16 clients of 24 rows of 16 tokens, each
client's rows drawn under a ``dialect`` permutation of its own (non-IID
shards), and 32 test rows without one.  Both packages get the same numpy
arrays.  Warm start: the reference's init (``PRNGKey(0)``) after 100
plain SGD steps (lr 0.5, batch 32) on the pooled rows, in JAX, carried
across with ``convert.from_numpy_tree``.  From the init every candidate
scores 0 next-token accuracy and the committee's scores all tie, which
would test no selection.

* The local trainer (an adapter without ``stacked_loss``, so each client
  runs the single-client program on its own): a cohort of P = 4 clients
  whole against calls of 2 and of 1, and on a gloo world of 2 CPU ranks
  (P = 4, and P = 5 with one padded row) against the whole call, at atol
  0.  A ``vmap`` over the clients, the port's former form, moved rows by
  up to 3e-8 between call sizes.
* Rounds: an int8 chain (``use_kernels=True, quantize_chain=True``),
  active_proportion 0.5 (P = 5, Q = 3), k = 3, local_steps 2,
  local_batch 4, val_batch 8, 2 rounds under the f32 ``committee`` and 2
  under ``committee_int8``.  Held equal: round 0's P x Q score matrix
  (which must not be all tied), ``RoundLog``s, committees and packed
  uploader ids.  Both chains ``verify()``.  The int8 blobs are held to
  the codec's rule (q within +-1, scales rtol 1e-5 or atol 1e-9: the
  updates differ from the reference's in the last bits, as f32 training
  in two packages does) and the final params to atol 2e-5 (8.1e-6
  measured; one q step of the largest tile is 8.8e-5).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import build_runtime as jax_build_runtime
from repro.configs import registry as jax_registry
from repro.data.synthetic import FederatedDataset as JaxFederatedDataset
from repro.fl import pipeline as jax_pipeline
from repro.fl.adapter import lm_adapter as jax_lm_adapter
from repro_torch.api import build_runtime
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.data import FederatedDataset, MarkovLM
from repro_torch.fl import pipeline
from repro_torch.fl.adapter import lm_adapter
from repro_torch.fl.client import make_local_train_fn
from repro_torch.hostdevices import spawn_world
from repro_torch.tree import tree_leaves, tree_map

torch.set_num_threads(2)

ARCH, CLIENTS, ROWS, SEQ, TEST_ROWS, DATA_SEED = "olmo-1b", 16, 24, 16, 32, 0
WARM_STEPS, WARM_LR, WARM_BATCH = 100, 0.5, 32
CFG = dict(active_proportion=0.5, k_updates=3, local_steps=2, local_batch=4,
           val_batch=8, use_kernels=True, quantize_chain=True, seed=0)
ROUNDS = 2
LR, MOMENTUM, STEPS, BATCH = 0.05, 0.9, 2, 4
PARAMS_ATOL = 2e-5


def lm_arrays(vocab: int):
    """(client token rows, client next tokens, test rows, test next tokens)."""
    lm = MarkovLM(vocab, seed=1)
    rng = np.random.default_rng(DATA_SEED)
    images, labels = [], []
    for _ in range(CLIENTS):
        rows = lm.sample(rng, ROWS, SEQ + 1,
                         dialect=rng.permutation(lm.branching))
        images.append(rows[:, :-1])
        labels.append(rows[:, 1:])
    test = lm.sample(rng, TEST_ROWS, SEQ + 1)
    return images, labels, test[:, :-1], test[:, 1:]


@pytest.fixture(scope="module")
def setup():
    cfg = registry.smoke_config(ARCH)
    arrays = lm_arrays(cfg.vocab_size)
    jax_cfg = jax_registry.smoke_config(ARCH)
    adapter = jax_lm_adapter(jax_cfg)
    params = adapter.init(jax.random.PRNGKey(0))
    xs, ys = np.concatenate(arrays[0]), np.concatenate(arrays[1])
    step = jax.jit(jax.grad(adapter.loss))
    rng = np.random.default_rng(5)
    for _ in range(WARM_STEPS):
        idx = rng.integers(0, len(xs), WARM_BATCH)
        params = jax.tree.map(lambda p, g: p - WARM_LR * g, params,
                              step(params, xs[idx], ys[idx]))
    return dict(cfg=cfg, jax_cfg=jax_cfg, arrays=arrays,
                warm=jax.tree.map(np.asarray, params))


def cohort(arrays, P: int):
    rng = np.random.default_rng(7)
    idx = rng.integers(0, ROWS, (P, STEPS, BATCH))
    xs = np.stack([arrays[0][c][idx[c]] for c in range(P)])
    ys = np.stack([arrays[1][c][idx[c]] for c in range(P)])
    return xs, ys


def assert_rows_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", (2, 1))
def test_trainer_rows_independent_of_call_size(setup, chunk):
    train = make_local_train_fn(lm_adapter(setup["cfg"]), LR, MOMENTUM)
    params = from_numpy_tree(setup["warm"])
    xs, ys = (torch.from_numpy(a) for a in cohort(setup["arrays"], 4))
    whole = train(params, xs, ys)
    parts = [train(params, xs[i:i + chunk], ys[i:i + chunk])
             for i in range(0, 4, chunk)]
    assert_rows_equal(tree_map(lambda *l: torch.cat(l), *parts), whole)


def _world_rows(cfg, warm, arrays, sizes, threads: int) -> dict:
    from repro_torch.fl.client import make_sharded_local_train_fn
    from repro_torch.fl.sharded import _pad_clients
    from repro_torch.launch.mesh import make_round_mesh
    from repro_torch.launch.shardings import round_engine_pspecs

    torch.set_num_threads(threads)
    mesh = make_round_mesh(device="cpu")
    train = make_sharded_local_train_fn(lm_adapter(cfg), LR, mesh, MOMENTUM)
    split = round_engine_pspecs()["clients"]
    out = {}
    for P in sizes:
        xs, ys, _ = _pad_clients(*cohort(arrays, P), mesh.size)
        block = train(from_numpy_tree(warm), xs, ys)
        out[P] = {"block_rows": tree_leaves(block)[0].shape[0],
                  "rows": tree_map(lambda x: mesh.gather(x, split)[:P].numpy(),
                                   block)}
    return out


@pytest.fixture(scope="module")
def world2(setup):
    return spawn_world(2, _world_rows, setup["cfg"], setup["warm"],
                       setup["arrays"], (4, 5), torch.get_num_threads())


@pytest.mark.parametrize("P", (4, 5))     # 5: one padded row on rank 1
def test_sharded_trainer_rows_equal_whole_call(setup, world2, P):
    train = make_local_train_fn(lm_adapter(setup["cfg"]), LR, MOMENTUM)
    xs, ys = (torch.from_numpy(a) for a in cohort(setup["arrays"], P))
    whole = train(from_numpy_tree(setup["warm"]), xs, ys)
    for rank in (r[P] for r in world2):
        assert rank["block_rows"] == -(-P // 2)
        assert_rows_equal(tree_map(torch.from_numpy, rank["rows"]), whole)


class ScoreSpy:
    """The validator stage with each cohort's P x Q scores recorded."""

    def __init__(self, inner):
        self.inner = inner
        self.prepare = inner.prepare
        self.scores = []

    def __call__(self, ctx):
        self.inner(ctx)
        self.scores.append(np.array(ctx.cohort_scores))


@pytest.fixture(scope="module", params=("committee", "committee_int8"))
def both(request, setup):
    name = request.param
    jax_spy = ScoreSpy(jax_pipeline.REGISTRIES["validator"][name])
    spy = ScoreSpy(pipeline.REGISTRIES["validator"][name])
    jrt = jax_build_runtime(jax_lm_adapter(setup["jax_cfg"]),
                            JaxFederatedDataset(*setup["arrays"]), CFG,
                            initial_params=setup["warm"],
                            stages={"validator": jax_spy})
    trt = build_runtime(lm_adapter(setup["cfg"]),
                        FederatedDataset(*setup["arrays"]), CFG,
                        initial_params=from_numpy_tree(setup["warm"]),
                        stages={"validator": spy}, device="cpu")
    committees = []
    for _ in range(ROUNDS):
        jrt.run_round()
        trt.run_round()
        committees.append((list(jrt.committee), list(trt.committee)))
    return jrt, trt, jax_spy.scores, spy.scores, committees


def test_scores_equal_and_not_tied(both):
    _, _, jax_scores, scores, _ = both
    assert len(scores) == len(jax_scores) >= ROUNDS
    assert scores[0].shape == (5, 3)
    assert len(np.unique(scores[0])) > 1
    for got, want in zip(scores, jax_scores):
        np.testing.assert_array_equal(got, want)


def test_round_logs_committees_and_packed_ids_equal(both):
    jrt, trt, _, _, committees = both
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    assert len(trt.logs) == ROUNDS
    for jc, tc in committees:
        assert jc == tc
    packed = [[(b.round, b.uploader) for b in rt.chain.blocks
               if b.kind == "update"] for rt in (jrt, trt)]
    assert packed[0] == packed[1]
    assert len(packed[1]) == ROUNDS * CFG["k_updates"]


def test_chain_blobs_and_params_agree(both):
    jrt, trt, _, _, _ = both
    assert jrt.chain.verify() and trt.chain.verify()
    assert trt.chain.height == jrt.chain.height
    for jb, tb in zip(jrt.chain.blocks, trt.chain.blocks):
        assert (tb.kind, tb.round, tb.uploader, tb.score, tb.encoded) == \
               (jb.kind, jb.round, jb.uploader, jb.score, jb.encoded)
        if tb.kind == "update":
            assert tb.encoded and tb.payload["d"] == jb.payload["d"]
            dq = (tb.payload["q"].numpy().astype(np.int32)
                  - np.asarray(jb.payload["q"]).astype(np.int32))
            assert np.abs(dq).max() <= 1
            np.testing.assert_allclose(tb.payload["scales"].numpy(),
                                       np.asarray(jb.payload["scales"]),
                                       rtol=1e-5, atol=1e-9)
    got = tree_leaves(to_numpy_tree(trt.global_params()))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jrt.global_params()))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAMS_ATOL)
