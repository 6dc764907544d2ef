"""The port's checkpoints, off-chain store and Markov LM data against the
reference's.

The files are the reference's format (``repro/checkpoint/ckpt.py``), so a
file either package writes loads in the other with equal leaves (dtype
and bits) and structure; the port's pure-Python msgpack subset writes the
bytes ``msgpack.packb(..., use_bin_type=True)`` writes and reads what
``msgpack.unpackb(..., raw=True)`` reads.  ``MarkovLM`` is a numpy copy:
its draws are the reference's bit for bit.
"""
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import checkpoint as jckpt
from repro.configs import registry as jreg
from repro.core.storage import OffChainStore as JStore
from repro.data.lm_synthetic import MarkovLM as JMarkovLM
from repro.kernels.ops import Int8UpdateCodec as JCodec
from repro.models import init_model as j_init
from repro_torch.checkpoint import (
    is_quantized_blob,
    load_model_payload,
    load_pytree,
    save_pytree,
)
from repro_torch.checkpoint import _msgpack
from repro_torch.checkpoint.ckpt import payload_of
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.core.blockchain import Chain
from repro_torch.core.storage import OffChainStore
from repro_torch.data import MarkovLM
from repro_torch.kernels.ops import Int8UpdateCodec
from repro_torch.models import init_model
from repro_torch.tree import tree_leaves, tree_map, tree_paths


@pytest.fixture(scope="module")
def cfg():
    return registry.get_config(
        "olmo-1b", d_model=32, num_units=2, num_heads=2, num_kv_heads=2,
        d_ff=64, vocab_size=128,
    )


@pytest.fixture(scope="module")
def params(cfg):
    return init_model(torch.Generator().manual_seed(0), cfg)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def assert_trees_equal(a, b):
    """Equal leaves in sorted-key order: dtype, shape and bits."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _structure(tree):
    """Container skeleton: dict keys, list / tuple kinds, None."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_structure(v) for v in tree])
    return None if tree is None else "leaf"


# ---- ports of tests/test_checkpoint.py ----------------------------------


def test_f32_params_roundtrip_structure_rebuild(params, tmp_path):
    p = str(tmp_path / "m.msgpack")
    save_pytree(p, params)
    got = load_pytree(p)
    assert _structure(got) == _structure(params)
    assert tree_paths(got)[0][0] == tree_paths(params)[0][0]
    assert_trees_equal(got, params)


def test_f32_params_roundtrip_like(params, tmp_path):
    p = str(tmp_path / "m.msgpack")
    save_pytree(p, params)
    got = load_pytree(p, like=params)
    assert _structure(got) == _structure(params)
    assert_trees_equal(got, params)


def test_bf16_leaves_roundtrip(params, tmp_path):
    half = tree_map(lambda x: x.to(torch.bfloat16), params)
    p = str(tmp_path / "bf16.msgpack")
    save_pytree(p, half)
    got = load_pytree(p)
    for x, y in zip(tree_leaves(got), tree_leaves(half)):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))


def test_int8_blob_roundtrip_preserves_dtypes(params, tmp_path):
    codec = Int8UpdateCodec(params)
    blob = codec.encode(tree_map(lambda x: x * 0.5, params))
    assert is_quantized_blob(blob)
    p = str(tmp_path / "blob.msgpack")
    save_pytree(p, blob)
    got = load_pytree(p)
    assert is_quantized_blob(got)
    assert got["q"].dtype == torch.int8
    assert torch.equal(got["q"], blob["q"])
    assert torch.equal(got["scales"], blob["scales"])
    assert int(got["d"]) == int(blob["d"])


def test_tiered_layout_roundtrip(tmp_path):
    """Nested dict/tuple/list/None skeleton — the tiered chain record
    shapes (committee snapshots, per-tier aggregates) survive rebuild."""
    payload = {
        "tiers": (
            {"members": np.arange(5, dtype=np.int32),
             "scores": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3)},
            {"members": torch.arange(3, dtype=torch.int32),
             "scores": None},
        ),
        "meta": [np.asarray(7, np.int64), None],
        "accept": np.asarray([True, False, True]),
    }
    p = str(tmp_path / "tier.msgpack")
    save_pytree(p, payload)
    got = load_pytree(p)
    assert isinstance(got["tiers"], tuple) and len(got["tiers"]) == 2
    assert got["tiers"][1]["scores"] is None
    assert isinstance(got["meta"], list) and got["meta"][1] is None
    np.testing.assert_array_equal(got["tiers"][0]["scores"].numpy(),
                                  payload["tiers"][0]["scores"])
    assert got["accept"].dtype == torch.bool
    np.testing.assert_array_equal(got["accept"].numpy(), payload["accept"])
    assert int(got["meta"][0]) == 7


def test_load_model_payload_raw(params, tmp_path):
    p = str(tmp_path / "raw.msgpack")
    save_pytree(p, params)
    assert_trees_equal(load_model_payload(p), params)


def test_load_model_payload_blob_decodes(params, tmp_path):
    codec = Int8UpdateCodec(params)
    blob = codec.encode(tree_map(lambda x: x + 0.25, params))
    p = str(tmp_path / "blob.msgpack")
    save_pytree(p, blob)
    got = load_model_payload(p, codec=codec)
    # decoded-from-disk must be bit-identical to decoded-from-memory
    assert_trees_equal(got, codec.decode(blob))
    assert _structure(got) == _structure(params)


def test_load_model_payload_blob_requires_codec(params, tmp_path):
    blob = Int8UpdateCodec(params).encode(params)
    p = str(tmp_path / "blob.msgpack")
    save_pytree(p, blob)
    with pytest.raises(ValueError, match="int8 chain blob"):
        load_model_payload(p)


def test_is_quantized_blob_rejects_lookalikes(params):
    assert not is_quantized_blob(params)
    assert not is_quantized_blob({"q": 1, "scales": 2})
    # a params tree whose top-level keys collide but whose "d" is a subtree
    nested = {"q": np.zeros(2), "scales": np.zeros(2), "d": {"w": np.zeros(2)}}
    assert not is_quantized_blob(nested)


def test_checkpoint_roundtrip(tmp_path):
    """Port of tests/test_substrate.py::test_checkpoint_roundtrip."""
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2,), dtype=torch.bfloat16), "d": None},
        "e": (torch.zeros((1,)), torch.tensor(3, dtype=torch.int32)),
    }
    path = str(tmp_path / "ckpt.msgpack")
    save_pytree(path, tree)
    out = load_pytree(path)
    assert out["b"]["d"] is None
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16
    assert isinstance(out["e"], tuple)
    out2 = load_pytree(path, like=tree)
    assert int(out2["e"][1]) == 3 and out2["e"][1].dtype == torch.int32


# ---- across the two packages ---------------------------------------------


def _mixed_tree():
    rng = np.random.default_rng(3)
    return {
        "f32": rng.standard_normal((4, 5)).astype(np.float32),
        "bf16": rng.standard_normal((3,)).astype(ml_dtypes.bfloat16),
        "nest": ({"i8": rng.integers(-127, 128, (7,)).astype(np.int8),
                  "none": None},
                 [np.asarray(5, np.int64), np.zeros((0, 3), np.float32)]),
        "u8": np.arange(4, dtype=np.uint8),
        "f64": rng.standard_normal((2, 2)),
        "b": np.asarray([True, False]),
        "i16": np.arange(-3, 3, dtype=np.int16),
    }


def _to_port(tree):
    def leaf(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    if isinstance(tree, dict):
        return {k: _to_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_port(v) for v in tree)
    return leaf(tree)


@pytest.mark.parametrize("which", ["mixed", "lm"])
def test_reference_file_loads_in_port(which, tmp_path):
    if which == "mixed":
        tree = _mixed_tree()
    else:
        tree = j_init(jax.random.PRNGKey(1), jreg.smoke_config("gemma3-4b"))
    p = str(tmp_path / "ref.msgpack")
    jckpt.save_pytree(p, tree)
    got = load_pytree(p)
    assert _structure(got) == _structure(tree)
    assert_trees_equal(got, tree)
    like = _to_port(jax.tree.map(np.asarray, tree)) if which == "lm" else None
    if like is not None:
        assert_trees_equal(load_pytree(p, like=like), tree)


@pytest.mark.parametrize("which", ["mixed", "lm", "blob"])
def test_port_file_loads_in_reference(which, params, tmp_path):
    if which == "mixed":
        tree = _to_port(_mixed_tree())
    elif which == "lm":
        tree = params
    else:
        tree = Int8UpdateCodec(params).encode(params)
    p = str(tmp_path / "port.msgpack")
    save_pytree(p, tree)
    got = jckpt.load_pytree(p)
    assert _structure(got) == _structure(tree)
    # what the reference loads from its own file of the same tree (jnp
    # narrows 64-bit leaves to 32 bits on loading, as JAX does by default)
    own = str(tmp_path / "own.msgpack")
    jckpt.save_pytree(own, tree_map(
        lambda t: t if t is None or not isinstance(t, torch.Tensor) else _np(t),
        tree))
    assert_trees_equal(got, jckpt.load_pytree(own))
    if which == "blob":
        # the reference decodes the port's blob like its own
        jparams = jax.tree.map(jnp.asarray, jax.tree.map(_np, params))
        want = Int8UpdateCodec(params).decode(tree)
        assert_trees_equal(jckpt.load_model_payload(p, codec=JCodec(jparams)),
                           want)


def test_port_file_equals_reference_file_but_treedef(params, tmp_path):
    """The whole file, byte for byte, once the treedef strings agree."""
    jparams = jax.tree.map(jnp.asarray, jax.tree.map(_np, params))
    jp, tp = str(tmp_path / "ref.msgpack"), str(tmp_path / "port.msgpack")
    jckpt.save_pytree(jp, jparams)
    save_pytree(tp, params)
    ref = msgpack.unpackb(open(jp, "rb").read(), raw=True)
    ours = payload_of(params)
    ours[b"treedef"] = ref[b"treedef"]
    assert _msgpack.packb(ours) == open(jp, "rb").read()


def _edge_objects():
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    lens = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
    objs = ints + [None, True, False]
    objs += [b"x" * n for n in lens]
    objs += [list(range(n)) for n in (0, 15, 16, 65536)]
    objs += [tuple(range(3)), {b"k%d" % i: i for i in range(16)},
             {b"k%d" % i: None for i in range(15)}, {}]
    return objs


def test_encoder_matches_msgpack_bytes():
    for obj in _edge_objects():
        assert _msgpack.packb(obj) == msgpack.packb(obj, use_bin_type=True), obj
    whole = {b"a": _edge_objects(), b"b": {b"c": [b"\x00" * 70000, -5]}}
    assert _msgpack.packb(whole) == msgpack.packb(whole, use_bin_type=True)


def test_decoder_matches_msgpack_unpackb():
    whole = {b"a": _edge_objects(), b"b": {b"c": [b"\x00" * 70000, -5]}}
    data = msgpack.packb(whole, use_bin_type=True)
    ours = _msgpack.unpackb(data)
    assert ours == msgpack.unpackb(data, raw=True)
    # bin values are views into ``data``, map keys are bytes
    assert isinstance(ours[b"b"][b"c"][0], memoryview)
    assert all(type(k) is bytes for k in ours)


def test_codec_refuses_what_it_does_not_cover():
    for obj in (1.5, "text"):
        with pytest.raises(TypeError):
            _msgpack.packb(obj)
        with pytest.raises(ValueError):
            _msgpack.unpackb(msgpack.packb(obj, use_bin_type=True))
    with pytest.raises(ValueError):
        _msgpack.unpackb(msgpack.packb([1, 2]) + b"\x00")


# ---- the off-chain store ---------------------------------------------------


@pytest.mark.parametrize("on_disk", [False, True])
def test_off_chain_store(on_disk, params, tmp_path):
    directory = str(tmp_path / "store") if on_disk else None
    store, ref = OffChainStore(directory), JStore(
        str(tmp_path / "jstore") if on_disk else None)
    assert store.size() == 0 and "a" not in store
    jparams = jax.tree.map(jnp.asarray, jax.tree.map(_np, params))
    store.put("a", params)
    ref.put("a", jparams)
    blob = Int8UpdateCodec(params).encode(params)
    store.put("b", blob)
    assert "a" in store and "b" in store and store.size() == 2
    assert_trees_equal(store.get("a"), params)
    assert_trees_equal(store.get("b"), blob)
    assert_trees_equal(store.get("a"), ref.get("a"))
    if on_disk:
        # the on-disk files are each other's format
        assert_trees_equal(load_pytree(str(tmp_path / "jstore" / "a")), params)


def test_pruned_chain_reads_through_store(params, tmp_path):
    """A chain that hands its payloads to a disk store and prunes them
    still returns its model blocks, bit for bit."""
    store = OffChainStore(str(tmp_path / "store"))
    chain = Chain(k_updates_per_round=1, off_chain_store=store)
    chain.append_model(params, 0)
    assert chain.verify()
    got = chain.model_at_round(0)
    assert_trees_equal(got, params)


# ---- the Markov LM data ------------------------------------------------------


@pytest.mark.parametrize("vocab,branching,seed", [(128, 4, 0), (8192, 4, 1),
                                                  (512, 3, 5)])
def test_markov_lm_matches_reference(vocab, branching, seed):
    ours, ref = MarkovLM(vocab, branching=branching, seed=seed), JMarkovLM(
        vocab, branching=branching, seed=seed)
    np.testing.assert_array_equal(ours.succ, ref.succ)
    assert ours.entropy() == ref.entropy()
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for b, s in ((16, 257), (4, 33)):
        a, b_ = ours.batch(r1, b, s), ref.batch(r2, b, s)
        np.testing.assert_array_equal(a[0], b_[0])
        np.testing.assert_array_equal(a[1], b_[1])
    dialect = np.random.default_rng(2).permutation(branching)
    np.testing.assert_array_equal(ours.sample(r1, 3, 9, dialect),
                                  ref.sample(r2, 3, 9, dialect))


def test_markov_lm_learnable_structure():
    """Port of tests/test_substrate.py::test_markov_lm_learnable_structure."""
    lm = MarkovLM(128, branching=4, seed=0)
    rng = np.random.default_rng(0)
    toks, tgts = lm.batch(rng, 4, 64)
    assert toks.shape == (4, 64)
    legal = sum(tgts[b, t] in lm.succ[toks[b, t]]
                for b in range(4) for t in range(64))
    assert legal == 4 * 64
    assert lm.entropy() < np.log(128)
