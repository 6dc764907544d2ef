"""The port's LM zoo against the reference's ``repro.models``.

Over the smoke configs of all ten archs: olmo-1b (non-parametric
LayerNorm, tied embeddings), qwen1.5-4b (QKV bias), phi4-mini (GQA,
RMSNorm, SwiGLU), gemma3-4b (GeGLU, scaled embeddings, local / global
attention with a ring buffer, a tail), mixtral-8x7b (sliding-window
attention, MoE top 2 of 4), qwen3-moe-30b-a3b (MoE), rwkv6-7b (RWKV-6
time and channel mix, chunked prefill, recurrent decode state),
jamba-1.5-large-398b (the attention + Mamba / MoE hybrid unit, the Mamba
conv and SSM decode state), hubert-xlarge (the audio frontend: masked
frames, the conv position embedding, bidirectional attention, no decode
step) and qwen2-vl-7b (the vision frontend: patch embeddings over the
image slots, M-RoPE positions in prefill and decode), the reference's
params are carried across through ``repro_torch.convert`` and the same
numpy batches go to both packages (for hubert and qwen2-vl the
reference's own ``hubert_batch`` / ``vlm_batch``, as numpy), whose model
functions run as the reference compiles them (``jax.jit``).

Tolerances: the matmuls sum in another order than XLA's, so logits agree
to ``atol=1e-5`` (they are O(1); the largest difference seen is about
1e-6), the prefill cache's keys and values to ``atol=1e-5`` and its
positions exactly (the RWKV-6 wkv state, a sum over the tokens so far of
size O(10), and the Mamba SSM state to ``atol=1e-5`` of their largest
entries), over a forward pass,
a prefill
and 8 teacher-forced decode steps; the MoE routers' aux loss within
``atol=1e-6``.  The int8 chain codec's blob of the params is bit for bit
the reference's: the sorted-key flatten walks the same leaves in the same
order.

The reference's own model checks are ported as well: RWKV-6's prefill
state continued by decode equals one prefill of the whole sequence
(``tests/test_models.py:52``), and the MoE's output depends only on the
top-k experts (``:160``).
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
from repro.models.frontends import hubert_batch as j_hubert_batch
from repro.models.frontends import vlm_batch as j_vlm_batch
from repro.models.transformer import Batch as JBatch
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.kernels import ops as tops
from repro_torch.models import Batch, decode_step, forward, init_model, prefill
from repro_torch.tree import tree_paths

torch.set_num_threads(2)
DENSE = ("olmo-1b", "qwen1.5-4b", "phi4-mini-3.8b", "gemma3-4b")
HELD = DENSE + ("mixtral-8x7b", "qwen3-moe-30b-a3b", "rwkv6-7b",
                "jamba-1.5-large-398b", "hubert-xlarge", "qwen2-vl-7b")
ATOL = 1e-5
B, PROMPT, STEPS, MAX_LEN = 2, 20, 8, 32
# qwen2-vl's batch: text, a 3 x 4 patch grid, text; the image lies in the
# prompt and decode continues the text after it
IMAGE_PATCHES, GRID = 12, (3, 4)


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


def _batch_np(jcfg, seed=0) -> dict:
    """The (B, PROMPT + STEPS) batch of an arch as numpy fields: numpy
    tokens for a text model, the reference's own frontend batch for the
    audio and vision ones."""
    if jcfg.frontend == "audio":
        jb = j_hubert_batch(jax.random.PRNGKey(seed), jcfg, B, PROMPT + STEPS)
    elif jcfg.frontend == "vision":
        jb = j_vlm_batch(jax.random.PRNGKey(seed), jcfg, B, PROMPT + STEPS,
                         image_patches=IMAGE_PATCHES, grid=GRID)
    else:
        return {"tokens": _tokens(jcfg, seed)}
    return {k: np.asarray(v) for k, v in jb._asdict().items()
            if k in ("tokens", "embeds", "embed_mask", "positions")
            and v is not None}


def _upto(fields: dict, n: int) -> dict:
    """The first n positions of every field (M-RoPE positions on axis 2)."""
    return {k: v[:, :, :n] if k == "positions" and v.ndim == 3 else v[:, :n]
            for k, v in fields.items()}


def _batches(fields: dict):
    return (JBatch(**{k: jnp.asarray(v) for k, v in fields.items()}),
            Batch(**{k: torch.from_numpy(np.array(v))
                     for k, v in fields.items()}))


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


@pytest.mark.parametrize("arch", HELD)
def test_init_model_paths_and_shapes(arch, ref_params):
    cfg = registry.smoke_config(arch)
    port = init_model(torch.Generator().manual_seed(0), cfg)
    got = [(p, tuple(t.shape), t.dtype) for p, t in tree_paths(port)]
    want = [(_key_path(p), tuple(a.shape), torch.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(ref_params(arch))[0]]
    assert got == want
    assert sum(t.numel() for _, t in tree_paths(port)) == registry.param_count(cfg)


@pytest.mark.parametrize("arch", ("olmo-1b", "gemma3-4b", "mixtral-8x7b",
                                  "qwen3-moe-30b-a3b", "rwkv6-7b",
                                  "jamba-1.5-large-398b", "hubert-xlarge",
                                  "qwen2-vl-7b"))
def test_converted_tree_keeps_reference_key_paths(arch, ref_params):
    ref = ref_params(arch)
    port = from_numpy_tree(ref)
    assert isinstance(port["units"], tuple) and isinstance(port["tail"], tuple)
    got = tree_paths(port)
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in got] == [_key_path(p) for p, _ in want]
    for (_, t), (_, a) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), a)


@pytest.mark.parametrize("arch", HELD)
def test_forward_prefill_decode_match_reference(arch, ref_params):
    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    ref = ref_params(arch)
    jp, tp = jax.tree.map(jnp.asarray, ref), from_numpy_tree(ref)
    fields = _batch_np(jcfg)

    jb, tb = _batches(fields)
    want, jaux = jax.jit(lambda p, b: j_forward(p, jcfg, b))(jp, jb)
    got, aux = forward(tp, cfg, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    if cfg.num_experts:
        assert float(aux) > 0.0

    jb, tb = _batches(_upto(fields, PROMPT))
    jl, jc = jax.jit(lambda p, b: j_prefill(p, jcfg, b, MAX_LEN))(jp, jb)
    tl, tc = prefill(tp, cfg, tb, MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)

    def check_cache(tc, jc):
        got, want = tree_paths(tc), jax.tree_util.tree_flatten_with_path(jc)[0]
        assert [p for p, _ in got] == [_key_path(p) for p, _ in want]
        for (path, t), (_, a) in zip(got, want):
            assert t.dtype == torch.float32 or path[-1] == "pos", path
            if path[-1] == "pos":
                np.testing.assert_array_equal(t.numpy(), np.asarray(a))
            elif path[-1] in ("wkv", "ssm"):
                # a sum over the tokens so far: ATOL of its largest
                np.testing.assert_allclose(
                    t.numpy(), np.asarray(a), rtol=0,
                    atol=ATOL * float(np.abs(np.asarray(a)).max()),
                    err_msg=str(path))
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0,
                                           atol=ATOL, err_msg=str(path))

    check_cache(tc, jc)
    if not cfg.is_decoder():
        pos = np.full((B,), PROMPT, np.int32)
        t = fields["embeds"][:, PROMPT:PROMPT + 1]
        with pytest.raises(ValueError, match="no decode step"):
            j_decode(jp, jcfg, None, pos, jc)
        with pytest.raises(ValueError, match="no decode step"):
            decode_step(tp, cfg, None, torch.from_numpy(pos), tc,
                        embeds=torch.tensor(t))
        return
    toks = fields["tokens"]
    mrope = fields.get("positions")
    jdec = jax.jit(lambda p, t, pos, c, mp: j_decode(p, jcfg, t, pos, c,
                                                     mrope_position=mp))
    for i in range(STEPS):
        t = toks[:, PROMPT + i:PROMPT + i + 1]
        pos = np.full((B,), PROMPT + i, np.int32)
        mp = None if mrope is None else mrope[:, :, PROMPT + i:PROMPT + i + 1]
        jlog, jc = jdec(jp, t, pos, jc, mp)
        tlog, tc = decode_step(tp, cfg, torch.tensor(t),
                               torch.from_numpy(pos), tc,
                               mrope_position=None if mp is None
                               else torch.tensor(mp))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=ATOL, err_msg=f"decode step {i}")
    check_cache(tc, jc)


@pytest.mark.parametrize("arch", HELD)
def test_codec_blob_bit_exact_to_reference(arch, ref_params):
    ref = ref_params(arch)
    want, _ = jops.quantize_pytree(jax.tree.map(jnp.asarray, ref))
    got, _ = tops.quantize_pytree(from_numpy_tree(ref))
    assert got["d"] == want["d"] == registry.param_count(registry.smoke_config(arch))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scales"].numpy().view(np.int32),
                                  np.asarray(want["scales"]).view(np.int32))


def test_rwkv_prefill_then_decode_equals_one_prefill(ref_params):
    """tests/test_models.py:52 on the port: the state a prefill leaves,
    carried through teacher-forced decode steps, gives the logits of a
    prefill of the whole sequence; the reference's last logits agree."""
    arch = "rwkv6-7b"
    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    ref = ref_params(arch)
    tp = from_numpy_tree(ref)
    toks = _tokens(cfg, seed=3)
    whole, _ = prefill(tp, cfg, Batch(tokens=torch.from_numpy(toks)), MAX_LEN)
    logits, cache = prefill(tp, cfg, Batch(
        tokens=torch.from_numpy(toks[:, :PROMPT])), MAX_LEN)
    for i in range(STEPS):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        logits, cache = decode_step(
            tp, cfg, torch.from_numpy(toks[:, PROMPT + i:PROMPT + i + 1]),
            pos, cache)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), rtol=0,
                               atol=1e-4)
    jl, _ = jax.jit(lambda p, t: j_prefill(p, jcfg, JBatch(tokens=t),
                                           MAX_LEN))(
        jax.tree.map(jnp.asarray, ref), toks)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


def test_moe_output_depends_only_on_top_k_experts():
    """tests/test_models.py:160 on the port: zeroing an expert the router
    never picks changes nothing; zeroing a picked one changes the output."""
    from repro_torch.models.moe import init_moe, moe_dense, route

    cfg = registry.smoke_config("mixtral-8x7b")
    p = init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, _ = moe_dense(p, x, cfg)
    _, ids, _ = route(p, x.reshape(-1, cfg.d_model), cfg)
    used = set(ids.reshape(-1).tolist())
    unused = [e for e in range(cfg.num_experts) if e not in used]
    for e, changes in ([(unused[0], False)] if unused else []) + [(ids[0, 0].item(), True)]:
        q = {k: v.clone() for k, v in p.items()}
        for name in ("up", "down", "gate"):
            if name in q:
                q[name][e] = 0.0
        out2, _ = moe_dense(q, x, cfg)
        assert (not torch.equal(out, out2)) == changes
