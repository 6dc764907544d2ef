"""The port's training driver (``repro_torch.launch.train``) on the CPU.

Ports of tests/test_system.py's driver tests with ``device="cpu"``: the
LM driver learns at the reference test's small settings, the bflc mode
runs, the fl driver runs BFLC end to end.  Then the CLI in a fresh
process, and ``lm_adapter``'s loss and accuracy against the reference's
on the same params and tokens (``atol=1e-5`` on an O(1) loss; the
accuracy exactly).
"""
import argparse
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.fl.adapter import lm_adapter as j_lm_adapter
from repro.models import init_model as j_init
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.fl import lm_adapter
from repro_torch.launch.train import lm_100m_config, run_fl, run_lm
from repro_torch.models import Batch, forward

torch.set_num_threads(4)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _lm_args(**kw):
    base = dict(steps=100, batch=16, seq=64, lr=5e-3, mode="standard",
                cohorts=2, committee=2, small=True, use_all_devices=False,
                ckpt="", log_every=100, vocab=512, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_lm_driver_learns():
    """The train step drives the loss toward the Markov chain's entropy
    floor (started at ln(512) ~ 6.24)."""
    assert run_lm(_lm_args()) < 5.0


def test_bflc_mode_lm_driver_runs(tmp_path):
    seen = []
    ckpt = str(tmp_path / "lm.msgpack")
    final = run_lm(_lm_args(steps=10, batch=8, seq=32, lr=1e-3, mode="bflc",
                            cohorts=4, committee=4, ckpt=ckpt),
                   on_step=lambda step, state, m: seen.append(int(state.step)))
    assert np.isfinite(final)
    assert seen == list(range(1, 11))
    from repro_torch.checkpoint import load_pytree

    assert load_pytree(ckpt)["embed"].shape == (512, 256)


def test_fl_driver_end_to_end():
    args = argparse.Namespace(
        clients=20, rounds=2, active=0.5, k_updates=3, local_steps=3,
        malicious=0.0, seed=0, log_every=2, device="cpu",
    )
    acc = run_fl(args)
    assert 0.0 <= acc <= 1.0


def test_lm_100m_config_is_the_reference():
    import dataclasses

    from repro.launch.train import lm_100m_config as j_cfg

    assert dataclasses.asdict(lm_100m_config()) == dataclasses.asdict(j_cfg())
    assert registry.param_count(lm_100m_config()) == 116_411_136


def test_cli_help_runs_in_a_fresh_process():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--help"], env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--driver", "--mode", "--use-all-devices", "--device",
                 "--ckpt", "--k-updates"):
        assert flag in proc.stdout


def test_driver_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_lm(_lm_args(device="cuda", steps=1))


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b"])
def test_lm_adapter_matches_reference(arch):
    cfg = registry.smoke_config(arch)
    p = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3),
                                        jreg.smoke_config(arch)))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 17)).astype(np.int32)
    x, y = toks[:, :-1], toks[:, 1:]
    ja, ta = j_lm_adapter(jreg.smoke_config(arch)), lm_adapter(cfg)
    jp, tp = jax.tree.map(jnp.asarray, p), from_numpy_tree(p)
    with torch.no_grad():
        np.testing.assert_allclose(
            float(ta.loss(tp, torch.tensor(x), torch.tensor(y))),
            float(jax.jit(ja.loss)(jp, jnp.asarray(x), jnp.asarray(y))),
            rtol=0, atol=1e-5)
        # the argmax of the same logits: equal unless two logits tie within
        # the matmuls' rounding, which these draws do not
        assert (float(ta.accuracy(tp, torch.tensor(x), torch.tensor(y)))
                == float(jax.jit(ja.accuracy)(jp, jnp.asarray(x),
                                              jnp.asarray(y))))
        # targets equal to the model's own argmax: accuracy 1
        logits, _ = forward(tp, cfg, Batch(tokens=torch.tensor(x)))
        assert float(ta.accuracy(tp, torch.tensor(x),
                                 logits.argmax(-1).to(torch.int32))) == 1.0
    params = ta.init(torch.Generator().manual_seed(0))
    assert registry.param_count(cfg) == sum(
        t.numel() for t in jax.tree.leaves(params))
