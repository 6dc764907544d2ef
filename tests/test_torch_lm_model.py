"""The port's dense LM zoo against the reference's ``repro.models``.

Over the smoke configs of olmo-1b (non-parametric LayerNorm, tied
embeddings), qwen1.5-4b (QKV bias), phi4-mini (GQA, RMSNorm, SwiGLU) and
gemma3-4b (GeGLU, scaled embeddings, local / global attention with a
ring buffer, a tail), the reference's params are carried across through
``repro_torch.convert`` and the same numpy tokens go to both packages,
whose model functions run as the reference compiles them (``jax.jit``).

Tolerances: the matmuls sum in another order than XLA's, so logits agree
to ``atol=1e-5`` (they are O(1); the largest difference seen is about
1e-6), the prefill cache's keys and values to ``atol=1e-5`` and its
positions exactly, over a forward pass, a prefill
and 8 teacher-forced decode steps.  The int8 chain codec's blob of the
params is bit for bit the reference's: the sorted-key flatten walks the
same leaves in the same order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ops as jops
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_model as j_init
from repro.models import prefill as j_prefill
from repro.models.transformer import Batch as JBatch
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import ops as tops
from repro_torch.models import Batch, decode_step, forward, init_model, prefill
from repro_torch.tree import tree_paths

torch.set_num_threads(2)
DENSE = ("olmo-1b", "qwen1.5-4b", "phi4-mini-3.8b", "gemma3-4b")
# the six archs whose mixers, MLPs or frontends wait for item 12
NOT_YET = tuple(a for a in registry.ARCH_IDS if a not in DENSE)
ATOL = 1e-5
B, PROMPT, STEPS, MAX_LEN = 2, 20, 8, 32


def _key_path(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jreg.smoke_config(arch)
            cache[arch] = jax.tree.map(
                np.asarray, j_init(jax.random.PRNGKey(7), cfg))
        return cache[arch]

    return get


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_registry_matches_reference(arch):
    for port_cfg, ref_cfg in ((registry.get_config(arch), jreg.get_config(arch)),
                              (registry.smoke_config(arch),
                               jreg.smoke_config(arch))):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert port_cfg.num_layers == ref_cfg.num_layers
        assert registry.param_count(port_cfg) == jreg.param_count(ref_cfg)
        assert (registry.active_param_count(port_cfg)
                == jreg.active_param_count(ref_cfg))
    if arch == "olmo-1b":
        assert registry.param_count(registry.get_config(arch)) == 1_176_764_416


@pytest.mark.parametrize("arch", NOT_YET)
def test_unported_arch_raises_at_init(arch):
    with pytest.raises(NotImplementedError, match="item 12"):
        init_model(torch.Generator().manual_seed(0), registry.smoke_config(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_init_model_paths_and_shapes(arch, ref_params):
    cfg = registry.smoke_config(arch)
    port = init_model(torch.Generator().manual_seed(0), cfg)
    got = [(p, tuple(t.shape), t.dtype) for p, t in tree_paths(port)]
    want = [(_key_path(p), tuple(a.shape), torch.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(ref_params(arch))[0]]
    assert got == want
    assert sum(t.numel() for _, t in tree_paths(port)) == registry.param_count(cfg)


@pytest.mark.parametrize("arch", ("olmo-1b", "gemma3-4b"))
def test_converted_tree_keeps_reference_key_paths(arch, ref_params):
    ref = ref_params(arch)
    port = from_numpy_tree(ref)
    assert isinstance(port["units"], tuple) and isinstance(port["tail"], tuple)
    got = tree_paths(port)
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in got] == [_key_path(p) for p, _ in want]
    for (_, t), (_, a) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference(arch, ref_params):
    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    ref = ref_params(arch)
    jp, tp = jax.tree.map(jnp.asarray, ref), from_numpy_tree(ref)
    toks = _tokens(cfg)

    want, _ = jax.jit(lambda p, t: j_forward(p, jcfg, JBatch(tokens=t)))(jp, toks)
    got, _ = forward(tp, cfg, Batch(tokens=torch.from_numpy(toks)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)

    jl, jc = jax.jit(lambda p, t: j_prefill(p, jcfg, JBatch(tokens=t),
                                            MAX_LEN))(jp, toks[:, :PROMPT])
    tl, tc = prefill(tp, cfg, Batch(tokens=torch.from_numpy(toks[:, :PROMPT])),
                     MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)

    def check_cache(tc, jc):
        got, want = tree_paths(tc), jax.tree_util.tree_flatten_with_path(jc)[0]
        assert [p for p, _ in got] == [_key_path(p) for p, _ in want]
        for (path, t), (_, a) in zip(got, want):
            if path[-1] == "pos":
                np.testing.assert_array_equal(t.numpy(), np.asarray(a))
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0,
                                           atol=ATOL, err_msg=str(path))

    check_cache(tc, jc)
    jdec = jax.jit(lambda p, t, pos, c: j_decode(p, jcfg, t, pos, c))
    for i in range(STEPS):
        t = toks[:, PROMPT + i:PROMPT + i + 1]
        pos = np.full((B,), PROMPT + i, np.int32)
        jlog, jc = jdec(jp, t, pos, jc)
        tlog, tc = decode_step(tp, cfg, torch.from_numpy(t),
                               torch.from_numpy(pos), tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=ATOL, err_msg=f"decode step {i}")
    check_cache(tc, jc)


@pytest.mark.parametrize("arch", DENSE)
def test_codec_blob_bit_exact_to_reference(arch, ref_params):
    ref = ref_params(arch)
    want, _ = jops.quantize_pytree(jax.tree.map(jnp.asarray, ref))
    got, _ = tops.quantize_pytree(from_numpy_tree(ref))
    assert got["d"] == want["d"] == registry.param_count(registry.smoke_config(arch))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scales"].numpy().view(np.int32),
                                  np.asarray(want["scales"]).view(np.int32))
