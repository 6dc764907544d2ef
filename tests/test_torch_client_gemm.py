"""The local trainer's per-client products (``kernels/client_gemm.py``) on
the CPU.

The CUDA kernel computes every output as one f32 FMA chain over k in
order (K >= SPLIT_K in chunks of K_CHUNK added in order, then the bias);
``client_gemm_ordered_ref`` computes those chains exactly, and the card
tests (``tests/test_torch_cuda.py``) hold the kernel to it bit for bit.
Here it is held to float64 products within the f32 dot-product bound
K * 2^-23 * sum |a||b| (+ |bias|), a client's rows are shown not to
depend on P, and the folded ones row (a linear layer's bias gradient) to
be the unfolded ``ones @ g`` bit for bit.  ``ClientLinear``'s gradients
(the CPU path, ``client_gemm_ref``) are held to autograd through
``client_gemm_ref`` and, through the FEMNIST CNN's ``stacked_loss``, to
the reference's per-client ``jax.grad``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import client_gemm as cg
from repro_torch.kernels.client_gemm import (
    K_CHUNK, SPLIT_K, ClientLinear, client_gemm_kernel,
    client_gemm_ordered_ref, client_gemm_path, client_gemm_ref, k_splits,
)

# every side of the split (SPLIT_K = 2048) and the trainer's K values
KS = (9, 288, 2047, 2048, 2049, 3136)


def operands(P, M, K, N, a_t=True, b_t=True, bias=True, seed=0):
    """numpy-seeded f32 operands; A (B) as a transposed view of a (P, K, M)
    ((P, N, K)) array when a_t (b_t), as the backward reads them."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(P, K, M) if a_t else (P, M, K))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(P, N, K) if b_t else (P, K, N))
                         .astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(P, N)).astype(np.float32))
    return (a.transpose(1, 2) if a_t else a, b.transpose(1, 2) if b_t else b,
            c if bias else None)


def f32_bound(a, b, bias=None, ones_row=False):
    """K * 2^-23 * (sum_k |a||b| + |bias|) for every output, in float64."""
    scale = client_gemm_ref(a.abs().double(), b.abs().double(), ones_row=ones_row)
    if bias is not None:
        scale = scale + bias.abs().double()[:, None]
    return a.shape[2] * 2.0 ** -23 * scale


@pytest.mark.parametrize("ones_row", (False, True))
@pytest.mark.parametrize("K", KS)
def test_ordered_ref_within_f32_bound(K, ones_row):
    a, b, bias = operands(3, 5, K, 7, seed=K)
    got = client_gemm_ordered_ref(a, b, bias, ones_row=ones_row)
    assert got.dtype == torch.float32 and got.shape == (3, 5 + ones_row, 7)
    want = client_gemm_ref(a.double(), b.double(), bias.double(),
                           ones_row=ones_row)
    err = (got.double() - want).abs()
    assert bool((err <= f32_bound(a, b, bias, ones_row)).all())


@pytest.mark.parametrize("K", (9, 2049))
def test_ordered_ref_is_the_chunked_fma_chain(K):
    """One output by hand: scalar fma_f32 over k in order, chunks of
    K_CHUNK added in order from K = SPLIT_K on, the bias last."""
    from repro_torch.numerics import fma_f32

    a, b, bias = operands(1, 2, K, 3, seed=K + 1)
    chunk = K_CHUNK if K >= SPLIT_K else K
    total = None
    for k0 in range(0, K, chunk):
        acc = torch.zeros(())
        for k in range(k0, min(K, k0 + chunk)):
            acc = fma_f32(a[0, 1, k], b[0, k, 2], acc)
        total = acc if total is None else total + acc
    got = client_gemm_ordered_ref(a, b, bias)[0, 1, 2]
    assert torch.equal(got, total + bias[0, 2])
    assert k_splits(K) == -(-K // chunk)


@pytest.mark.parametrize("ones_row", (False, True))
@pytest.mark.parametrize("K", (288, 2049))
def test_ordered_ref_rows_independent_of_P(K, ones_row):
    a, b, bias = operands(5, 6, K, 4, seed=3 * K)
    whole = client_gemm_ordered_ref(a, b, bias, ones_row=ones_row)
    for p in range(5):
        alone = client_gemm_ordered_ref(a[p:p + 1], b[p:p + 1],
                                        bias[p:p + 1], ones_row=ones_row)
        assert torch.equal(alone.view(torch.int32), whole[p:p + 1].view(torch.int32))


@pytest.mark.parametrize("K", (288, 2049))
def test_folded_ones_row_is_the_unfolded_product(K):
    """The folded row is ones @ g bit for bit, and the rows above it are
    the product without the fold, in the exact-order version and in the
    CPU path that ClientLinear takes."""
    x, g, _ = operands(3, 9, K, 5, bias=False, seed=K)
    ones = torch.ones((3, 1, K))
    folded = client_gemm_ordered_ref(x, g, ones_row=True)
    bits = lambda t: t.contiguous().view(torch.int32)
    assert torch.equal(bits(folded[:, -1:]), bits(client_gemm_ordered_ref(ones, g)))
    assert torch.equal(bits(folded[:, :-1]), bits(client_gemm_ordered_ref(x, g)))
    cpu = client_gemm_kernel(x, g, ones_row=True)
    unfolded_ones = g.new_ones(()).expand(3, 1, K)
    assert torch.equal(bits(cpu[:, -1:]), bits(client_gemm_kernel(unfolded_ones, g)))
    assert torch.equal(bits(cpu[:, :-1]), bits(client_gemm_kernel(x, g)))


@pytest.mark.parametrize("shape", ((3, 70, 9, 32), (2, 5, 2049, 62),
                                   (2, 288, 64, 24)))
def test_client_linear_grads_match_autograd(shape):
    P, M, K, N = shape
    x, w, b = operands(P, M, K, N, a_t=False, b_t=False, seed=M + K)
    gout = torch.from_numpy(np.random.default_rng(1).normal(size=(P, M, N))
                            .astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ClientLinear.apply(*leaves).backward(gout)
    got = [t.grad for t in leaves]
    ref = [t.clone().requires_grad_() for t in (x, w, b)]
    (client_gemm_ref(*ref[:2]) + ref[2][:, None]).backward(gout)
    assert got[1].shape == (P, K, N) and got[2].shape == (P, N)
    # each gradient is a product: dx = g w^T (K over N), dw = x^T g and
    # db = ones g (K over M)
    bounds = (f32_bound(gout, w.transpose(1, 2)),
              f32_bound(x.transpose(1, 2), gout),
              f32_bound(torch.ones((P, 1, M)), gout)[:, 0])
    for g_, r_, bound in zip(got, ref, bounds):
        assert bool(((g_.double() - r_.grad.double()).abs() <= bound).all())


def test_stacked_loss_grads_match_reference_per_client():
    """The FEMNIST CNN's stacked loss (every product through ClientLinear)
    against the reference's jax.grad of one client's loss, client by
    client, at width 8 (numpy-seeded inputs, the reference's init)."""
    from repro.configs import femnist_cnn as ref_cnn
    from repro_torch.configs import femnist_cnn as cnn
    from repro_torch.tree import tree_leaves, tree_map

    P, B = 2, 4
    rng = np.random.default_rng(5)
    images = rng.normal(size=(P, B, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 62, (P, B))
    init = ref_cnn.init_params(jax.random.PRNGKey(0), width=8)
    # a non-zero output layer, so every product's gradient is non-zero
    init["fc2"]["w"] = jnp.asarray(rng.normal(size=(128, 62)).astype(np.float32) * 0.05)
    stacked = tree_map(lambda a: torch.from_numpy(np.stack([np.asarray(a)] * P))
                       .requires_grad_(), init)
    loss = cnn.stacked_loss(stacked, torch.from_numpy(images),
                            torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, tree_leaves(stacked))
    for p in range(P):
        want = jax.grad(ref_cnn.loss_fn)(init, jnp.asarray(images[p]),
                                         jnp.asarray(labels[p]))
        for g_, w_ in zip(grads, jax.tree_util.tree_leaves(want)):
            w_ = np.asarray(w_)
            np.testing.assert_allclose(g_[p].numpy(), w_, rtol=0,
                                       atol=2e-5 * max(np.abs(w_).max(), 1e-3))


def test_stacked_loss_makes_eleven_products_a_step(monkeypatch):
    """A step of the FEMNIST CNN: 4 forwards, 3 input gradients (not
    conv1's: the images need none) and 4 weight gradients with their bias
    gradients folded in."""
    from repro_torch.configs import femnist_cnn as cnn
    from repro_torch.tree import tree_leaves, tree_map

    calls = []
    real = cg.client_gemm_kernel

    def counting(a, b, bias=None, *, ones_row=False):
        calls.append(ones_row)
        return real(a, b, bias, ones_row=ones_row)

    monkeypatch.setattr(cg, "client_gemm_kernel", counting)
    P = 2
    params = tree_map(lambda a: a[None].expand(P, *a.shape).clone().requires_grad_(),
                      cnn.init_params(torch.Generator().manual_seed(0), width=4))
    images = torch.randn((P, 3, 28, 28, 1), generator=torch.Generator().manual_seed(1))
    loss = cnn.stacked_loss(params, images, torch.zeros((P, 3), dtype=torch.long))
    torch.autograd.grad(loss, tree_leaves(params))
    assert len(calls) == 11 and sum(calls) == 4


def test_kernel_wrapper_raises_on_what_it_does_not_take():
    a, b, bias = operands(2, 3, 4, 5, a_t=False, b_t=False)
    with pytest.raises(ValueError):
        client_gemm_kernel(a, b[:, :3])
    with pytest.raises(TypeError):
        client_gemm_kernel(a.double(), b)
    with pytest.raises(ValueError):
        client_gemm_kernel(a, b, bias[:, :4])
    out = client_gemm_kernel(a, b, bias, ones_row=True)
    assert out.shape == (2, 4, 5)
    with pytest.raises(ValueError):     # the path is the card's alone
        client_gemm_path(a, b)
