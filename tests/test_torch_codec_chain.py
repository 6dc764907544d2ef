"""The port's chain codec and flat chain against the reference.

* The ``Int8UpdateCodec`` blob (q, scales, d) of a width-8 FEMNIST param
  dict is bit-equal to the reference codec's blob — the flatten walks
  sorted keys, and 2048-lane tiles cross leaf boundaries exactly as
  ``ravel_pytree`` lays them out — and decode round-trips.
* The flat ``Chain``'s layout, ``verify``, tamper detection and ``prune``
  follow ``tests/test_blockchain.py``'s flat cases.
"""
import jax
import numpy as np
import pytest
import torch

from repro.fl.adapter import femnist_adapter as jax_femnist_adapter
from repro.kernels.ops import Int8UpdateCodec as JaxCodec
from repro_torch.convert import from_numpy_tree, to_numpy_tree
from repro_torch.core.blockchain import Chain, LayoutError, pytree_digest
from repro_torch.kernels.ops import Int8UpdateCodec
from repro_torch.tree import ravel_pytree

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params_np():
    """Width-8 reference params with every leaf nonzero (so each tile's
    scale is data-driven), as numpy."""
    p = jax.tree.map(np.asarray,
                     jax_femnist_adapter(8).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 1e-2).astype(np.float32), p
    )


def test_convert_round_trip_keeps_keys_shapes_layouts(params_np):
    tp = from_numpy_tree(params_np)
    assert tp["conv2"]["w"].shape == (3, 3, 8, 16)         # HWIO
    assert tp["fc1"]["w"].shape == (7 * 7 * 16, 128)       # (in, out)
    back = to_numpy_tree(tp)
    for k in params_np:
        for kk in params_np[k]:
            np.testing.assert_array_equal(back[k][kk], params_np[k][kk])


def test_flatten_order_matches_ravel_pytree(params_np):
    from jax.flatten_util import ravel_pytree as jax_ravel

    want = np.asarray(jax_ravel(params_np)[0])
    got = ravel_pytree(from_numpy_tree(params_np))[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_codec_blob_bit_equal_to_reference(params_np):
    jblob = JaxCodec(params_np).encode(params_np)
    codec = Int8UpdateCodec(from_numpy_tree(params_np))
    blob = codec.encode(from_numpy_tree(params_np))
    assert blob["d"] == jblob["d"] == codec.dim
    assert blob["q"].dtype == torch.int8 and blob["q"].shape[0] % 2048 == 0
    np.testing.assert_array_equal(blob["q"].numpy(), np.asarray(jblob["q"]))
    np.testing.assert_array_equal(blob["scales"].numpy(),
                                  np.asarray(jblob["scales"]))
    # decode round-trips to the reference's decode, leaf for leaf
    want = JaxCodec(params_np).decode(jblob)
    got = to_numpy_tree(codec.decode(blob))
    for k in want:
        for kk in want[k]:
            np.testing.assert_array_equal(got[k][kk], np.asarray(want[k][kk]))
            # and to within half a quantization step of the input
            step = float(blob["scales"].max())
            assert np.abs(got[k][kk] - params_np[k][kk]).max() <= 0.5 * step * 1.0001


# ----------------------------------------------------------------------
# flat chain (mirrors tests/test_blockchain.py)
# ----------------------------------------------------------------------
def model(v=0.0):
    return {"w": torch.full((4, 4), v), "b": torch.zeros((4,))}


def update(v=1.0):
    return {"w": torch.full((4, 4), v * 0.1), "b": torch.full((4,), v)}


def run_rounds(chain: Chain, rounds: int):
    for t in range(rounds):
        for i in range(chain.k):
            chain.append_update(update(i), uploader=i, score=0.5 + 0.01 * i)
        chain.append_model(model(t + 1), t + 1)


def test_layout_formula():
    chain = Chain(3)
    chain.append_model(model(), 0)
    run_rounds(chain, 2)
    for t in range(3):
        blk = chain.blocks[chain.model_index(t)]
        assert blk.kind == "model" and blk.round == t
    lo, hi = chain.update_index_range(0)
    assert (lo, hi) == (1, 3)
    assert all(chain.blocks[i].kind == "update" for i in range(lo, hi + 1))


def test_latest_model_and_layout_errors():
    chain = Chain(2)
    chain.append_model(model(0), 0)
    run_rounds(chain, 5)
    t, m = chain.latest_model()
    assert t == 5 and float(m["w"][0, 0]) == 5.0
    chain.append_update(update(), 0, 0.5)
    with pytest.raises(LayoutError):
        chain.append_model(model(6), 6)            # needs k updates first
    chain.append_update(update(), 1, 0.5)
    with pytest.raises(LayoutError):
        chain.append_update(update(), 2, 0.5)      # round already full


def test_verify_detects_tamper_and_reorder():
    chain = Chain(2)
    chain.append_model(model(), 0)
    run_rounds(chain, 2)
    assert chain.verify()
    saved = chain.blocks[1].payload
    chain.blocks[1].payload = update(99.0)
    assert not chain.verify()
    chain.blocks[1].payload = saved
    assert chain.verify()
    chain.blocks[1], chain.blocks[2] = chain.blocks[2], chain.blocks[1]
    assert not chain.verify()


def test_verify_covers_codec_flag_and_blob_bytes(params_np):
    tp = from_numpy_tree(params_np)
    chain = Chain(1, update_codec=Int8UpdateCodec(tp))
    chain.append_model(tp, 0)
    chain.append_update(tp, uploader=3, score=0.9)
    assert chain.blocks[1].encoded and chain.verify()
    chain.blocks[1].payload["q"][0] += 1                 # flip one int8 lane
    assert not chain.verify()
    chain.blocks[1].payload["q"][0] -= 1
    assert chain.verify()
    chain.blocks[1].encoded = False
    assert not chain.verify()


def test_prune_keeps_latest_and_headers():
    chain = Chain(2)
    chain.append_model(model(), 0)
    run_rounds(chain, 4)
    before = chain.storage_bytes()
    assert chain.prune(keep_rounds=1) > 0
    assert chain.storage_bytes() < before
    t, _ = chain.latest_model()
    assert t == 4
    with pytest.raises(KeyError):
        chain.model_at_round(0)
    assert chain.verify()


@pytest.mark.parametrize("k,rounds", [(1, 0), (2, 3), (5, 2)])
def test_chain_invariants(k, rounds):
    chain = Chain(k)
    chain.append_model(model(), 0)
    run_rounds(chain, rounds)
    assert chain.verify()
    assert chain.height == rounds * (k + 1) + 1
    assert chain.latest_model()[0] == rounds
    assert all(b.index % (k + 1) == 0 for b in chain.blocks if b.kind == "model")


def test_digest_covers_key_paths_dtype_and_values():
    a = {"x": torch.zeros(3), "y": torch.ones(2)}
    assert pytree_digest(a) == pytree_digest({"y": torch.ones(2), "x": torch.zeros(3)})
    assert pytree_digest(a) != pytree_digest({"x": torch.ones(2), "y": torch.zeros(3)})
    assert pytree_digest(a) != pytree_digest({"x": torch.zeros(3, dtype=torch.float64),
                                              "y": torch.ones(2)})
