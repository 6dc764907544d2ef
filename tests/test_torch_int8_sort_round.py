"""An int8-chain round aggregated by the fused kernel's sort methods
(cwmed, trimmed_mean), the port against the reference.

Both ``build_runtime``s run one seeded round with ``quantize_chain=True,
use_kernels=True`` on the same synthetic community from the reference's
init (passed through ``initial_params=``), as ``tests/test_torch_round.py``
runs the fedavg round.  Config: width 8, k = 3, local_steps 2,
local_batch 8, val_batch 16, active_proportion 0.5, 24 clients, trim 1.

Held equal: ``RoundLog``s, the committee, and the chain's blocks (kind,
round, uploader, score): the packed uploader ids.  Held close: int8 blob
scales (rtol 1e-5) and q (within +-1: an update that differs in the last
bits can round across a half step), global params (atol 1e-5, the
convolutions' sum order).  Both chains must pass ``verify()``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import build_runtime as jax_build_runtime
from repro.data import make_femnist_like as jax_make_femnist_like
from repro.fl import femnist_adapter as jax_femnist_adapter
from repro_torch.api import build_runtime
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter

torch.set_num_threads(2)

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
CFG = dict(active_proportion=0.5, k_updates=3, local_steps=2, local_batch=8,
           val_batch=16, quantize_chain=True, use_kernels=True, trim=1,
           seed=0)


@pytest.fixture(scope="module")
def datasets():
    return jax_make_femnist_like(**DATA), make_femnist_like(**DATA)


@pytest.mark.parametrize("method", ("cwmed", "trimmed_mean"))
def test_int8_sort_round_matches_reference(datasets, method):
    jd, td = datasets
    cfg = dict(CFG, aggregation=method)
    init = jax_femnist_adapter(8).init(jax.random.PRNGKey(0))
    jrt = jax_build_runtime(jax_femnist_adapter(8), jd, cfg, initial_params=init)
    trt = build_runtime(femnist_adapter(8), td, cfg, device="cpu",
                        initial_params=from_numpy_tree(jax.tree.map(np.asarray, init)))
    jrt.run_round()
    trt.run_round()
    assert [dataclasses.asdict(l) for l in trt.logs] == \
           [dataclasses.asdict(l) for l in jrt.logs]
    assert trt.committee == jrt.committee
    assert jrt.chain.verify() and trt.chain.verify()
    assert trt.chain.height == jrt.chain.height
    updates = 0
    for jb, tb in zip(jrt.chain.blocks, trt.chain.blocks):
        assert (tb.kind, tb.round, tb.uploader, tb.score, tb.encoded) == \
               (jb.kind, jb.round, jb.uploader, jb.score, jb.encoded)
        if tb.kind == "update":
            updates += 1
            assert tb.encoded and tb.payload["d"] == jb.payload["d"]
            dq = (tb.payload["q"].numpy().astype(np.int32)
                  - np.asarray(jb.payload["q"]).astype(np.int32))
            assert np.abs(dq).max() <= 1
            np.testing.assert_allclose(tb.payload["scales"].numpy(),
                                       np.asarray(jb.payload["scales"]),
                                       rtol=1e-5)
    assert updates == CFG["k_updates"]
    want = jax.tree.map(np.asarray, jrt.global_params())
    got = to_numpy_tree(trt.global_params())
    for k in want:
        for kk in want[k]:
            np.testing.assert_allclose(got[k][kk], want[k][kk], rtol=0, atol=1e-5)
