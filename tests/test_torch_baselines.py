"""The committee-free baselines (Basic FL / CwMed) and stand-alone training
against the reference.

Both packages run on the same synthetic community (24 clients) from the
reference's init, converted through numpy, with the same host seed, so
they draw the same cohorts, malicious sets and poison.  Config: width 8,
active_proportion 0.5, local_steps 3, local_batch 8, 25 % malicious,
3 rounds.  Held: the malicious sets equal, the global params within
atol 1e-5 (training's convolution sum order differs) and the test
accuracies equal.  ``train_standalone`` takes the reference's init through
a test-side adapter and runs 6 steps: params within atol 1e-5, accuracies
equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.api import build_runtime as jax_build_runtime
from repro.data import make_femnist_like as jax_make_femnist_like
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro.fl.baselines import train_standalone as jax_train_standalone
from repro_torch.api import build_config, build_runtime
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.data import make_femnist_like
from repro_torch.fl import FLConfig, FLTrainer, train_standalone
from repro_torch.fl.adapter import ModelAdapter, femnist_adapter
from repro_torch.fl.runtime import BFLCConfig

torch.set_num_threads(2)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
CFG = dict(active_proportion=0.5, local_steps=3, local_batch=8,
           malicious_fraction=0.25, seed=0)


@pytest.fixture(scope="module")
def datasets():
    return jax_make_femnist_like(**DATA), make_femnist_like(**DATA)


@pytest.fixture(scope="module")
def init_np():
    return jax.tree.map(np.asarray,
                        jax_femnist_adapter(8).init(jax.random.PRNGKey(0)))


def _assert_trees_close(got, want, atol):
    for k in want:
        for kk in want[k]:
            np.testing.assert_allclose(got[k][kk], np.asarray(want[k][kk]),
                                       rtol=0, atol=atol)


@pytest.mark.parametrize("method", ("fedavg", "cwmed"))
def test_fl_trainer_matches_reference(datasets, init_np, method):
    jd, td = datasets
    cfg = dict(CFG, aggregation=method)
    jrt = jax_build_runtime(jax_femnist_adapter(8), jd, cfg, baseline=True,
                            initial_params=init_np)
    trt = build_runtime(femnist_adapter(8), td, cfg, baseline=True,
                        initial_params=from_numpy_tree(init_np), device="cpu")
    assert isinstance(trt, FLTrainer)
    assert trt.malicious == jrt.malicious and trt.malicious
    jacc = jrt.run(3, eval_every=1)
    tacc = trt.run(3, eval_every=1)
    _assert_trees_close(to_numpy_tree(trt.params), jrt.params, atol=1e-5)
    np.testing.assert_allclose(tacc, jacc, rtol=0, atol=1e-6)
    assert set(trt.stage_timings[0]) == {"sample", "train", "validate",
                                         "pack", "aggregate", "elect",
                                         "reward"}


def test_train_standalone_matches_reference(datasets, init_np):
    jd, td = datasets
    jadapter = jax_femnist_adapter(8)
    tadapter = femnist_adapter(8)
    # the reference's init handed over through the adapter the function calls
    tadapter = ModelAdapter(init=lambda _gen: from_numpy_tree(init_np),
                            loss=tadapter.loss, accuracy=tadapter.accuracy)
    jadapter = jadapter._replace(init=lambda _key: jax.tree.map(
        jax.numpy.asarray, init_np))
    kw = dict(steps=6, batch=16, lr=0.05, seed=4, eval_every=3)
    jparams, jaccs = jax_train_standalone(jadapter, jd, **kw)
    tparams, taccs = train_standalone(tadapter, td, device="cpu", **kw)
    assert len(taccs) == len(jaccs) == 2
    _assert_trees_close(to_numpy_tree(tparams), jparams, atol=1e-5)
    np.testing.assert_allclose(taccs, jaccs, rtol=0, atol=1e-6)


def test_build_config_and_runtime_pick_the_baseline(datasets):
    _, td = datasets
    assert isinstance(build_config({"aggregation": "cwmed"}, baseline=True),
                      FLConfig)
    assert isinstance(build_config(None), BFLCConfig)
    fl = FLConfig(aggregation="cwmed")
    assert build_config(fl) is fl
    with pytest.raises(ValueError, match="baseline=True contradicts"):
        build_config(BFLCConfig(), baseline=True)
    with pytest.raises(TypeError):
        build_config(3)
    with pytest.raises(ValueError, match="tiers applies"):
        build_runtime(femnist_adapter(8), td, fl, tiers=2, device="cpu")
    rt = build_runtime(femnist_adapter(8), td, fl, device="cpu")
    assert isinstance(rt, FLTrainer) and rt.cfg is fl


@pytest.mark.parametrize("kwargs, match", [
    (dict(mesh=object()), "make_round_mesh"),
    (dict(schedule="async", mesh=object()), "make_round_mesh"),
])
def test_fl_trainer_unported_engines_raise(datasets, kwargs, match):
    """A mesh that is not a round mesh is refused, naming what is
    expected (the sharded baselines run in
    tests/test_torch_sharded_round.py)."""
    _, td = datasets
    with pytest.raises(TypeError, match=match):
        build_runtime(femnist_adapter(8), td, CFG, baseline=True,
                      device="cpu", **kwargs)


def test_fl_trainer_default_device_is_cuda(datasets):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FLTrainer(femnist_adapter(8), datasets[1], FLConfig())
