"""The audio and vision frontends, M-RoPE and the conv position embedding
(``repro_torch.models.frontends`` / ``layers``) against the reference.

``mrope_positions_for_image`` draws nothing and equals the reference's
exactly.  The batch makers draw from a ``torch.Generator``, so their
parity runs take the reference's batches across as numpy; the port's own
batches are checked for their layout.  Values are held to ``atol=1e-5``
of each tensor's largest entry unless stated (the conv and the matmuls
sum in another order than XLA's).  The reference's ``tests/
test_models.py:114`` (M-RoPE reduces to RoPE on text), ``:125`` (image
positions change the output) and ``:140`` (the encoder's masked
prediction is bidirectional) are ported.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import forward as j_forward
from repro.models import init_model as j_init
from repro.models import layers as jlayers
from repro.models.frontends import hubert_batch as j_hubert_batch
from repro.models.frontends import mrope_positions_for_image as j_mrope_pos
from repro.models.frontends import vlm_batch as j_vlm_batch
from repro.models.transformer import embed_inputs as j_embed_inputs
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.launch import steps
from repro_torch.models import Batch, decode_step, forward, init_cache
from repro_torch.models import hubert_batch, lm_batch, vlm_batch
from repro_torch.models import layers
from repro_torch.models.frontends import mrope_positions_for_image
from repro_torch.models.transformer import embed_inputs
from repro_torch.serve import ServeEngine

torch.set_num_threads(2)
RTOL = 1e-5
HUBERT, QWEN_VL = "hubert-xlarge", "qwen2-vl-7b"


def _close(got, want, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=RTOL * scale, err_msg=what)


def _port_batch(jb) -> Batch:
    return Batch(**{k: None if v is None else torch.from_numpy(np.array(v))
                    for k, v in jb._asdict().items()})


@pytest.fixture(scope="module")
def ref_params():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jax.tree.map(np.asarray, j_init(
                jax.random.PRNGKey(4), jreg.smoke_config(arch)))
        return cache[arch]

    return get


# ---- M-RoPE ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 3, 4, 8), (1, 2, 2, 0), (0, 5, 3, 4),
                                   (16, 16, 16, 16)])
def test_mrope_positions_for_image_equal_reference(shape):
    got = mrope_positions_for_image(*shape)
    want = np.asarray(j_mrope_pos(*shape))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_apply_mrope_matches_reference(sections):
    rng = np.random.default_rng(0)
    Dh = 2 * sum(sections)
    x = rng.standard_normal((2, 24, 3, Dh)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 24)).astype(np.int32)
    want = jlayers.apply_mrope(x, pos, 1e6, sections)
    got = layers.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, sections)
    _close(got, want)


def test_apply_mrope_reduces_to_rope_on_text():
    """Three equal streams rotate exactly as standard RoPE, bit for bit."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 24, 3, 32)).astype(np.float32))
    pos = torch.tensor(rng.integers(0, 5000, (2, 24)).astype(np.int32))
    got = layers.apply_mrope(x, pos[None].expand(3, 2, 24), 1e4, (4, 6, 6))
    assert torch.equal(got, layers.apply_rope(x, pos, 1e4))


def test_mrope_sections_must_cover_half_the_head():
    x = torch.zeros((1, 2, 1, 32))
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(x, torch.zeros((3, 1, 2), dtype=torch.int32), 1e4,
                           (4, 6, 4))


def test_mrope_reduces_to_rope_on_text_model(ref_params):
    """tests/test_models.py:114 on the port: a text-only vlm_batch through
    the M-RoPE model gives the logits of the standard-RoPE model on its
    first position stream."""
    cfg = registry.smoke_config(QWEN_VL)
    p = from_numpy_tree(ref_params(QWEN_VL))
    bv = vlm_batch(torch.Generator().manual_seed(0), cfg, 2, 32)
    lv, _ = forward(p, cfg, bv)
    ls, _ = forward(p, cfg.replace(rope="standard"),
                    bv._replace(positions=bv.positions[0]))
    torch.testing.assert_close(lv, ls, rtol=0, atol=1e-5)


def test_mrope_image_positions_change_output(ref_params):
    """tests/test_models.py:125 on the port."""
    cfg = registry.smoke_config(QWEN_VL)
    p = from_numpy_tree(ref_params(QWEN_VL))
    b_img = vlm_batch(torch.Generator().manual_seed(0), cfg, 2, 32,
                      image_patches=12, grid=(3, 4))
    b_txt = b_img._replace(positions=torch.arange(
        32, dtype=torch.int32)[None, None].expand(3, 2, 32))
    l_img, _ = forward(p, cfg, b_img)
    l_txt, _ = forward(p, cfg, b_txt)
    assert float((l_img - l_txt).abs().max()) > 1e-4


# ---- the conv position embedding ------------------------------------------------


def test_conv_pos_matches_reference():
    jcfg, cfg = jreg.smoke_config(HUBERT), registry.smoke_config(HUBERT)
    ref = jlayers.init_conv_pos(jax.random.PRNGKey(0), jcfg, jnp.float32)
    port = layers.init_conv_pos(torch.Generator().manual_seed(0), cfg,
                                torch.float32)
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(v.shape) for k, v in ref.items()} == {
        "w": (31, cfg.d_model // 16, cfg.d_model), "b": (cfg.d_model,)}
    rng = np.random.default_rng(2)
    params = {"w": np.asarray(ref["w"]),
              "b": 0.1 * rng.standard_normal(cfg.d_model).astype(np.float32)}
    for S in (5, 40):       # shorter and longer than the 31-tap kernel
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        want = jlayers.apply_conv_pos(params, x)
        got = layers.apply_conv_pos(from_numpy_tree(params), torch.tensor(x))
        _close(got, want, f"S = {S}")


# ---- embedding, loss and decode of the frontends ----------------------------------


def test_vision_embed_inputs_equal_reference(ref_params):
    """Patch embeddings replace the token embeddings on the image slots,
    bit for bit (a gather and a select)."""
    jcfg, cfg = jreg.smoke_config(QWEN_VL), registry.smoke_config(QWEN_VL)
    jb = j_vlm_batch(jax.random.PRNGKey(1), jcfg, 2, 32, image_patches=12,
                     grid=(3, 4))
    p = ref_params(QWEN_VL)
    want = np.asarray(j_embed_inputs(jax.tree.map(jnp.asarray, p), jcfg, jb))
    got = embed_inputs(from_numpy_tree(p), cfg, _port_batch(jb))
    np.testing.assert_array_equal(got.numpy(), want)
    mask = np.asarray(jb.embed_mask)
    np.testing.assert_array_equal(got.numpy()[mask], np.asarray(jb.embeds)[mask])


def test_audio_embed_inputs_match_reference(ref_params):
    jcfg, cfg = jreg.smoke_config(HUBERT), registry.smoke_config(HUBERT)
    jb = j_hubert_batch(jax.random.PRNGKey(2), jcfg, 2, 48)
    p = ref_params(HUBERT)
    want = j_embed_inputs(jax.tree.map(jnp.asarray, p), jcfg, jb)
    _close(embed_inputs(from_numpy_tree(p), cfg, _port_batch(jb)), want)


def test_encoder_masked_prediction_loss_matches_reference(ref_params):
    """HuBERT's masked-prediction loss (tokens None, the loss on the masked
    frames only) and its gradients, against the reference's standard
    loss."""
    from repro.launch.mesh import make_host_mesh
    from repro.launch.shardings import ShardingPolicy

    jcfg, cfg = jreg.smoke_config(HUBERT), registry.smoke_config(HUBERT)
    jb = j_hubert_batch(jax.random.PRNGKey(3), jcfg, 4, 32)
    assert jb.tokens is None and 0 < float(jb.loss_mask.mean()) < 1
    p = ref_params(HUBERT)
    ctx = jsteps.make_moe_ctx(jcfg, make_host_mesh(1, 1), ShardingPolicy(
        dp_axes=("data",), model_axis_size=1, fsdp=False), batch_sharded=True)
    (jtot, jce), jg = jax.jit(jax.value_and_grad(
        lambda p: jsteps.standard_loss(p, jcfg, jb, ctx), has_aux=True))(
        jax.tree.map(jnp.asarray, p))
    g, tot, ce = steps.make_grad_fn(cfg, mode="standard")(
        from_numpy_tree(p), _port_batch(jb))
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)
    np.testing.assert_allclose(float(tot), float(jtot), rtol=1e-6)
    for key in ("mask_emb", "conv_pos"):
        for sub, want in (jax.tree.map(np.asarray, jg[key]).items()
                          if key == "conv_pos" else [(None, np.asarray(jg[key]))]):
            _close(g[key] if sub is None else g[key][sub], want, f"{key} {sub}")


def test_encoder_is_bidirectional(ref_params):
    """tests/test_models.py:140 on the port: perturbing row 0's last
    unmasked frame moves its first position's logits; perturbing a masked
    frame moves nothing (the mask embedding replaced it)."""
    cfg = registry.smoke_config(HUBERT)
    p = from_numpy_tree(ref_params(HUBERT))
    b = hubert_batch(torch.Generator().manual_seed(0), cfg, 2, 32)
    logits, _ = forward(p, cfg, b)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert torch.isfinite(logits).all()
    unmasked = torch.nonzero(~b.embed_mask[0]).flatten()
    masked = torch.nonzero(b.embed_mask[0]).flatten()
    assert len(unmasked) and len(masked)
    col = int(unmasked.max())
    assert col > 0
    moved = b.embeds.clone()
    moved[0, col] += 10.0
    l2, _ = forward(p, cfg, b._replace(embeds=moved))
    assert float((l2[0, 0] - logits[0, 0]).abs().max()) > 1e-5
    moved = b.embeds.clone()
    moved[0, int(masked[0])] += 10.0
    l3, _ = forward(p, cfg, b._replace(embeds=moved))
    assert torch.equal(l3, logits)


def test_hubert_has_no_decode_step(ref_params):
    cfg = registry.smoke_config(HUBERT)
    p = from_numpy_tree(ref_params(HUBERT))
    cache = init_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(ValueError, match="no decode step"):
        decode_step(p, cfg, None, torch.zeros((1,), dtype=torch.int32), cache,
                    embeds=torch.zeros((1, 1, cfg.d_model)))
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(cfg, p, device="cpu")


def test_vlm_decode_takes_embeds_and_mrope_position(ref_params):
    """After a text prefill, ``decode_step``'s ``embeds`` replace the token
    embedding (the token then does not matter), an explicit (3, B, 1)
    ``mrope_position`` equal to the position on all three streams is its
    default, and other streams rotate otherwise."""
    from repro_torch.models import prefill

    cfg = registry.smoke_config(QWEN_VL)
    p = from_numpy_tree(ref_params(QWEN_VL))
    toks = torch.tensor([[4, 8, 15, 16], [23, 42, 4, 8]], dtype=torch.int32)
    text = torch.arange(4, dtype=torch.int32)[None, None].expand(3, 2, 4)
    emb = torch.randn((2, 1, cfg.d_model),
                      generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([4, 4], dtype=torch.int32)

    def step(tok, mp):
        _, cache = prefill(p, cfg, Batch(tokens=toks, positions=text), 8)
        return decode_step(p, cfg, torch.tensor(tok, dtype=torch.int32), pos,
                           cache, mrope_position=mp, embeds=emb)[0]

    default = step([[1], [2]], None)
    assert torch.equal(default, step([[7], [9]],
                                     pos[None, :, None].expand(3, 2, 1)))
    other = step([[1], [2]], torch.stack([pos, pos + 3, pos + 5])[:, :, None])
    assert float((other - default).abs().max()) > 1e-4


# ---- the port's batch makers -------------------------------------------------------


def test_vlm_batch_layout():
    cfg = registry.smoke_config(QWEN_VL)
    b = vlm_batch(torch.Generator().manual_seed(0), cfg, 3, 40,
                  image_patches=12, grid=(3, 4))
    before = (40 - 12) // 2
    assert b.tokens.shape == (3, 40) and b.tokens.dtype == torch.int32
    assert b.positions.shape == (3, 3, 40) and b.positions.dtype == torch.int32
    for row in range(3):
        assert torch.equal(b.positions[:, row],
                           mrope_positions_for_image(before, 3, 4, 40 - 12 - before))
    assert b.embed_mask[:, before:before + 12].all()
    assert int(b.embed_mask.sum()) == 3 * 12
    assert torch.equal(b.loss_mask, (~b.embed_mask).to(torch.float32))
    assert torch.equal(b.targets, torch.roll(b.tokens, -1, 1))
    assert b.embeds.shape == (3, 40, cfg.d_model)
    text = vlm_batch(torch.Generator().manual_seed(0), cfg, 2, 16)
    assert not text.embed_mask.any() and not text.embeds.any()
    assert torch.equal(text.positions, torch.arange(
        16, dtype=torch.int32)[None, None].expand(3, 2, 16))
    with pytest.raises(ValueError, match="patches"):
        vlm_batch(torch.Generator(), cfg, 1, 40, image_patches=12, grid=(3, 3))


def test_hubert_and_lm_batch_layout():
    cfg = registry.smoke_config(HUBERT)
    b = hubert_batch(torch.Generator().manual_seed(0), cfg, 4, 200)
    assert b.tokens is None and b.embeds.shape == (4, 200, cfg.d_model)
    assert b.targets.dtype == torch.int32
    assert 0 <= int(b.targets.min()) and int(b.targets.max()) < cfg.vocab_size
    assert torch.equal(b.loss_mask, b.embed_mask.to(torch.float32))
    assert 0.2 < float(b.loss_mask.mean()) < 0.9      # spans of 10 at p 0.08
    assert torch.equal(b.positions, torch.arange(
        200, dtype=torch.int32)[None].expand(4, 200))
    lcfg = registry.smoke_config("olmo-1b")
    lb = lm_batch(torch.Generator().manual_seed(0), lcfg, 2, 9)
    assert lb.embeds is None and lb.embed_mask is None
    assert torch.equal(lb.targets, torch.roll(lb.tokens, -1, 1))
    assert torch.equal(lb.loss_mask, torch.ones((2, 9)))


def test_reference_batches_run_on_the_port(ref_params):
    """The reference's vision and audio batches, carried across as numpy,
    give the reference's logits (the model parity tests in
    test_torch_lm_model.py hold the rest)."""
    for arch, make in ((QWEN_VL, lambda k, c: j_vlm_batch(
            k, c, 2, 24, image_patches=6, grid=(2, 3))),
                       (HUBERT, lambda k, c: j_hubert_batch(k, c, 2, 24))):
        jcfg, cfg = jreg.smoke_config(arch), registry.smoke_config(arch)
        jb = make(jax.random.PRNGKey(5), jcfg)
        p = ref_params(arch)
        want, _ = j_forward(jax.tree.map(jnp.asarray, p), jcfg, jb)
        got, _ = forward(from_numpy_tree(p), cfg, _port_batch(jb))
        _close(got, want, arch)
