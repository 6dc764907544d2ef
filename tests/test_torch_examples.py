"""The port's examples (``examples/torch_*.py``) on the CPU at reduced sizes.

Each runs in this process through its ``main(argv)`` with ``--device
cpu``; the serve demo's ``main`` runs the serving CLI in a child process
and returns its exit code.

* ``torch_quickstart`` (2 rounds, 20 writers, 3 local steps) and
  ``torch_election_strategies`` (the same sizes, each of the three
  methods) are held against the reference's ``BFLCRuntime`` built here on
  the same dataset arrays, config and ``initial_params`` (the reference's
  init, carried across with ``convert.from_numpy_tree``): ``RoundLog``s
  (with the final test accuracy of the election runs), committees and
  packed uploader ids equal, both chains ``verify()``.
* The others are held to what they print: ``verify()``, the pruned
  payload count and bytes, the int8 codec's 4x ratio and exact round
  trip, the failback's accuracies, finite losses and accuracies in
  [0, 1], a saved checkpoint that loads.
"""
import dataclasses
import importlib.util
import math
import os

import jax
import numpy as np
import torch

from repro.data.synthetic import FederatedDataset as JaxFederatedDataset
from repro.fl import BFLCConfig as JaxBFLCConfig
from repro.fl import BFLCRuntime as JaxBFLCRuntime
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro_torch.convert import from_numpy_tree

torch.set_num_threads(2)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SMALL = ["--device", "cpu", "--rounds", "2", "--clients", "20",
         "--local-steps", "3"]


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_init(width: int = 16):
    return jax.tree.map(np.asarray,
                        jax_femnist_adapter(width).init(jax.random.PRNGKey(0)))


def reference_twin(rt, init):
    """The reference's runtime on the port runtime's data, config and init."""
    d = rt.data
    data = JaxFederatedDataset(d.client_images, d.client_labels,
                               d.test_images, d.test_labels)
    return JaxBFLCRuntime(jax_femnist_adapter(16), data,
                          JaxBFLCConfig(**dataclasses.asdict(rt.cfg)),
                          initial_params=init)


def packed_ids(chain):
    return [(b.round, b.uploader) for b in chain.blocks if b.kind == "update"]


def assert_twins(jrt, trt):
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    assert trt.committee == jrt.committee
    assert packed_ids(trt.chain) == packed_ids(jrt.chain)
    assert trt.chain.verify() and jrt.chain.verify()


def test_quickstart_matches_reference():
    init = reference_init()
    trt = example("torch_quickstart").main(SMALL,
                                           initial_params=from_numpy_tree(init))
    jrt = reference_twin(trt, init)
    for r in range(2):
        jrt.run_round(eval_test=(r % 5 == 4))
    assert trt.chain.height == 1 + 2 * (1 + trt.cfg.k_updates)
    assert_twins(jrt, trt)


def test_election_strategies_match_reference():
    init = reference_init()
    runs = example("torch_election_strategies").main(
        SMALL, initial_params=from_numpy_tree(init))
    assert sorted(runs) == ["by_score", "multi_factor", "random"]
    for method, trt in runs.items():
        assert trt.cfg.election_method == method
        jrt = reference_twin(trt, init)
        jrt.run(2, eval_every=2)
        assert_twins(jrt, trt)
        assert trt.logs[-1].test_accuracy is not None


def test_malicious_attack_runs():
    runs = example("torch_malicious_attack").main(SMALL)
    assert runs["bflc"].chain.verify()
    assert len(runs["bflc"].logs) == 2
    assert 0.0 <= runs["bflc"].logs[-1].test_accuracy <= 1.0
    for agg in ("fedavg", "cwmed"):
        assert runs[agg].cfg.aggregation == agg
        assert len(runs[agg].accuracies) == 1
        assert 0.0 <= runs[agg].accuracies[-1] <= 1.0


def test_custom_stage_runs():
    runs = example("torch_custom_stage").main(
        ["--device", "cpu", "--rounds", "2", "--clients", "20",
         "--warm-steps", "20"])
    for name in ("committee", "no_committee"):
        rt = runs[name]
        assert rt.chain.verify() and len(rt.logs) == 2
        assert 0.0 <= rt.logs[-1].test_accuracy <= 1.0
    # the custom packer packs unscored updates, the committee's are scored
    scores = [b.score for b in runs["no_committee"].chain.blocks
              if b.kind == "update"]
    assert scores == [0.0] * (2 * runs["no_committee"].cfg.k_updates)
    assert 0.0 <= runs["baseline"].accuracies[-1] <= 1.0


def test_storage_and_recovery_invariants():
    out = example("torch_storage_and_recovery").main(
        ["--device", "cpu", "--rounds", "2", "--clients", "16"])
    # 2 rounds, keep 2: the genesis model and round 0's k updates go
    assert out["pruned"] == 1 + 6
    assert out["verify"]
    assert 0 < out["bytes_pruned"] < out["bytes_full"]
    assert out["bytes_off_chain"] == 0
    assert 3.9 < out["codec_ratio"] <= 4.0
    assert out["codec_max_err"] == 0.0   # a constant update is one q step
    assert out["acc_recovered"] == out["acc_before"]
    assert 0.0 <= out["acc_poisoned"] <= 1.0


def test_train_100m_small_saves_a_checkpoint(tmp_path):
    from repro_torch.checkpoint import load_pytree

    ckpt = str(tmp_path / "m.msgpack")
    loss = example("torch_train_100m").main(
        ["--device", "cpu", "--small", "--steps", "2", "--ckpt", ckpt])
    assert math.isfinite(loss)
    params = load_pytree(ckpt)
    assert params["embed"].shape == (8192, 256)


def test_serve_demo_exits_zero():
    assert example("torch_serve_demo").main(["--device", "cpu"]) == 0
