"""A client's local update must not depend on how many clients share the
trainer's batched call: the port's mirror of the reference's
``tests/test_sharded_round.py::test_sharded_trainer_matches_vmapped``
(same inputs: FEMNIST CNN width 8, P = 8 and 5, 3 steps of batch 8, lr
0.05, momentum 0.9, numpy seed 7), at atol 0.

* ``make_local_train_fn`` on the whole cohort against the same program
  on consecutive calls of 1, 2 and 4 clients;
* ``make_sharded_local_train_fn`` on a gloo world of 2 CPU ranks
  (``hostdevices.spawn_world``), P padded to the world size as the round
  engine pads it, gathered and cut back to P, against the whole call.
  The ranks run at this process's CPU thread count: the CPU's sgemm
  blocks its sums by its thread count, so a product is the same bits
  only at the same count.

The card's twin is in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.client import make_local_train_fn
from repro_torch.hostdevices import spawn_world
from repro_torch.tree import tree_leaves, tree_map

WIDTH, STEPS, BATCH, LR, MOMENTUM, SEED = 8, 3, 8, 0.05, 0.9, 7


def cohort(P: int):
    rng = np.random.default_rng(SEED)
    xs = rng.normal(size=(P, STEPS, BATCH, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 62, (P, STEPS, BATCH))
    return xs, ys


def init_params():
    return femnist_adapter(WIDTH).init(torch.Generator().manual_seed(0))


def assert_rows_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("chunk", (1, 2, 4))
@pytest.mark.parametrize("P", (8, 5))
def test_trainer_rows_independent_of_call_size(P, chunk):
    train = make_local_train_fn(femnist_adapter(WIDTH), LR, MOMENTUM)
    params = init_params()
    xs, ys = (torch.from_numpy(a) for a in cohort(P))
    whole = train(params, xs, ys)
    parts = [train(params, xs[i:i + chunk], ys[i:i + chunk])
             for i in range(0, P, chunk)]
    assert_rows_equal(tree_map(lambda *l: torch.cat(l), *parts), whole)


def _world_rows(P: int, threads: int) -> dict:
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.client import make_sharded_local_train_fn
    from repro_torch.fl.sharded import _pad_clients
    from repro_torch.launch.mesh import make_round_mesh
    from repro_torch.launch.shardings import round_engine_pspecs

    torch.set_num_threads(threads)
    mesh = make_round_mesh(device="cpu")
    xs, ys, _ = _pad_clients(*cohort(P), mesh.size)
    block = make_sharded_local_train_fn(femnist_adapter(WIDTH), LR, mesh,
                                        MOMENTUM)(init_params(), xs, ys)
    split = round_engine_pspecs()["clients"]
    return {"block_rows": tree_leaves(block)[0].shape[0],
            "rows": tree_map(lambda x: mesh.gather(x, split)[:P].numpy(),
                             block)}


@pytest.fixture(scope="module")
def world2():
    return {P: spawn_world(2, _world_rows, P, torch.get_num_threads())
            for P in (8, 5)}


@pytest.mark.parametrize("P", (8, 5))     # 5: one padded row on rank 1
def test_sharded_trainer_rows_equal_whole_call(world2, P):
    train = make_local_train_fn(femnist_adapter(WIDTH), LR, MOMENTUM)
    xs, ys = (torch.from_numpy(a) for a in cohort(P))
    whole = train(init_params(), xs, ys)
    for rank in world2[P]:
        assert rank["block_rows"] == -(-P // 2)
        assert_rows_equal(tree_map(torch.from_numpy, rank["rows"]), whole)
