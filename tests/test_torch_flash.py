"""The port's flash attention (``repro_torch.models.flash``) and the
attention path over ``DENSE_MAX`` against the reference.

The same numpy q, k, v and output cotangent, made from a seed, go to the
port's ``flash_attention``, to the reference's ``flash_attention`` (its
custom VJP, under ``jax.vjp``) and to dense attention, at S = 2560 (five
512-blocks, over ``DENSE_MAX``), causal, windowed and bidirectional, with
GQA (4 query heads over 2 KV heads).  Outputs and the gradients of q, k
and v are held to ``atol=1e-5`` of each tensor's largest entry (the
online softmax sums in another order than the dense one; about 1e-6 of
it is seen).  The reference's ``tests/test_models.py:74`` (the long-
sequence path equals the dense one) and ``:90`` (flash gradients equal
dense ones) are ported too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models.flash import flash_attention as j_flash
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.models import attention as tattn
from repro_torch.models import flash as tflash
from repro_torch.models.flash import flash_attention

torch.set_num_threads(2)
RTOL = 1e-5
B, S, H, KV, DH = 1, 2560, 4, 2, 16
MASKS = {"causal": (True, 0), "window": (True, 64), "bidirectional": (False, 0)}


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * scale, err_msg=what)


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, S, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    ct = rng.standard_normal((B, S, H, DH)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    return q, k, v, ct, pos


def _port(q, k, v, ct, pos, causal, window):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_attention(tq, tk, tv, torch.tensor(pos), torch.tensor(pos),
                          causal, window)
    return out, torch.autograd.grad(out, (tq, tk, tv), torch.tensor(ct))


@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_matches_reference_flash(qkv, mask):
    q, k, v, ct, pos = qkv
    causal, window = MASKS[mask]
    jout, vjp = jax.vjp(
        lambda q, k, v: j_flash(q, k, v, pos, pos, causal, window), q, k, v)
    jgrads = vjp(ct)
    out, grads = _port(q, k, v, ct, pos, causal, window)
    _close(out, jout, "out")
    for name, g, jg in zip("qkv", grads, jgrads):
        _close(g, jg, f"d{name}")


@pytest.mark.parametrize("mask", list(MASKS))
def test_flash_matches_dense_attention(qkv, mask):
    """tests/test_models.py:90 at S = 2560: the reference's dense attention
    (scores materialized, plain autograd) gives the same output and
    gradients."""
    q, k, v, ct, pos = qkv
    causal, window = MASKS[mask]
    m = jattn._pair_mask(pos, pos, causal=causal, window=window)
    jout, vjp = jax.vjp(lambda q, k, v: jattn._dense_attention(q, k, v, m, 0.0),
                        q, k, v)
    jgrads = vjp(ct)
    out, grads = _port(q, k, v, ct, pos, causal, window)
    _close(out, jout, "out")
    for name, g, jg in zip("qkv", grads, jgrads):
        _close(g, jg, f"d{name}")


def test_backward_keeps_no_score_block(qkv):
    """The autograd graph saves (q, k, v, positions, out, lse) and nothing
    of P: under saved-tensor hooks its bytes stay below one (QB, KB) score
    block a head."""
    q, k, v, _, pos = qkv
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        flash_attention(tq, tk, tv, torch.tensor(pos), torch.tensor(pos),
                        True, 0)
    inputs = sum(a.nbytes for a in (q, k, v, pos, pos)) + q.nbytes
    lse = 4 * B * H * S
    assert sum(saved) == inputs + lse
    assert sum(saved) < 4 * B * H * 512 * tflash.KV_BLOCK


@pytest.mark.parametrize("seq", [2100, 2600])
def test_ragged_sequence_raises(seq):
    """The reference needs S to be a multiple of 512 on this path; the port
    raises ValueError there and never falls back to the dense path."""
    x = torch.zeros((1, seq, 2, 8))
    pos = torch.arange(seq)[None]
    with pytest.raises(ValueError, match="512"):
        flash_attention(x, x, x, pos, pos, True, 0)
    cfg = registry.smoke_config("phi4-mini-3.8b")
    p = tattn.init_attention(torch.Generator().manual_seed(0), cfg,
                             torch.float32)
    with pytest.raises(ValueError, match="512"):
        tattn.attention_forward(p, torch.zeros((1, seq, cfg.d_model)),
                                pos.to(torch.int32), cfg, "attn")


def test_softcap_raises_over_dense_max():
    """The flash path has no logit softcap (the reference asserts)."""
    cfg = registry.smoke_config("phi4-mini-3.8b").replace(
        attn_logit_softcap=50.0)
    p = tattn.init_attention(torch.Generator().manual_seed(0), cfg,
                             torch.float32)
    pos = torch.arange(S, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="softcap"):
        tattn.attention_forward(p, torch.zeros((1, S, cfg.d_model)), pos, cfg,
                                "attn")


@pytest.mark.parametrize("arch,mixer", [("phi4-mini-3.8b", "attn"),
                                        ("mixtral-8x7b", "attn_swa"),
                                        ("hubert-xlarge", "attn"),
                                        ("qwen2-vl-7b", "attn")])
def test_attention_forward_over_dense_max_matches_reference(arch, mixer):
    """``attention_forward`` at S = 2560 (the flash path in both packages,
    K and V expanded to the query heads) on the smoke configs' attention:
    causal GQA with RoPE, sliding-window, bidirectional, and M-RoPE (3, B,
    S) positions; the output and the gradients of x and of every weight."""
    jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
    rng = np.random.default_rng(1)
    p = jax.tree.map(np.asarray,
                     jattn.init_attention(jax.random.PRNGKey(2), jcfg,
                                          jnp.float32))
    if "bq" in p:      # non-zero biases, so their gradients are exercised
        p = {k: (0.1 * rng.standard_normal(a.shape).astype(np.float32)
                 if k.startswith("b") else a) for k, a in p.items()}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    if cfg.rope == "mrope":
        pos = np.stack([pos, pos // 2, pos // 3])       # (3, B, S) streams

    def jfn(p, x):
        return jattn.attention_forward(p, x, pos, jcfg, mixer)

    jout, vjp = jax.vjp(jfn, p, x)
    jgp, jgx = vjp(ct)
    tp = {k: t.requires_grad_(True) for k, t in from_numpy_tree(p).items()}
    tx = torch.tensor(x, requires_grad=True)
    out = tattn.attention_forward(tp, tx, torch.tensor(pos), cfg, mixer)
    grads = torch.autograd.grad(out, [tx] + [tp[k] for k in sorted(tp)],
                                torch.tensor(ct))
    _close(out, jout, "out")
    _close(grads[0], jgx, "dx")
    for key, g in zip(sorted(tp), grads[1:]):
        _close(g, jgp[key], f"d{key}")


def test_long_path_equals_dense_path(monkeypatch):
    """tests/test_models.py:74 on the port: with DENSE_MAX lowered to 256
    a forward of S = 1024 goes through flash attention and gives the dense
    path's logits."""
    from repro_torch.models import Batch, forward, init_model

    cfg = registry.smoke_config("phi4-mini-3.8b")
    params = init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 1024)).astype(np.int32))
    dense, _ = forward(params, cfg, Batch(tokens=toks))
    calls = []
    real = tattn.flash_attention
    monkeypatch.setattr(tattn, "DENSE_MAX", 256)
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    flash, _ = forward(params, cfg, Batch(tokens=toks))
    assert len(calls) == cfg.num_layers
    torch.testing.assert_close(flash, dense, rtol=0, atol=5e-5)

