"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: these skip without a GPU (the check runs inside a fixture,
never at import).  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

The plain versions run on CPU copies of the same inputs.  quantize,
dequantize, the fused candidates and the f32 fedavg (given the same
weights) and trimmed mean are bit-exact; the f32 median is equal by value
(+0.0 and -0.0 tie in a sort); the fused aggregation is exact for cwmed
and trimmed_mean and within rtol 1e-6 for fedavg (normalized weights).
"""
import pytest
import torch

from repro_torch.core.aggregation import normalize_weights
from repro_torch.kernels import ops
from repro_torch.kernels.fused_agg import METHODS
from repro_torch.kernels.quantize import quantize_stack_kernel

F32_KS = (1, 2, 3, 8, 17, 90)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _stack(K, D, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((K, D), generator=g) * 1e-3
    x[0] = torch.arange(D, dtype=torch.float32) % 251 - 125.5
    x[0, ::2048] = 127.0
    if D > 4096:
        x[:, 2048:4096] = 0.0
    return x


@pytest.mark.parametrize("K", (1, 3, 8, 17))
@pytest.mark.parametrize("D", (2048, 5000, 6145))
def test_quantize_stack_and_dequantize_bit_exact(cuda, K, D):
    x = _stack(K, D, K * 13 + D)
    q, s, d = ops.quantize_stack(x.to(cuda))
    rq, rs, rd = ops.quantize_stack(x)
    assert d == rd
    assert torch.equal(q.cpu(), rq) and torch.equal(s.cpu(), rs)
    for k in range(K):
        assert torch.equal(ops.dequantize(q[k], s[k], d).cpu(),
                           ops.dequantize(rq[k], rs[k], d))


@pytest.mark.parametrize("K", (1, 3, 8, 17))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("quantize_out", (False, True))
def test_fused_agg_matches_plain(cuda, K, method, quantize_out):
    q, s, d = ops.quantize_stack(_stack(K, 6145, K))
    w = torch.rand((K,), generator=torch.Generator().manual_seed(K))
    kw = dict(method=method, trim=(K - 1) // 2, quantize_out=quantize_out)
    got = ops.aggregate_quantized(q.to(cuda), s.to(cuda), d, weights=w.to(cuda), **kw)
    want = ops.aggregate_quantized(q, s, d, weights=w, **kw)
    if quantize_out:
        assert (got[0].cpu().int() - want[0].int()).abs().max() <= (
            0 if method != "fedavg" else 1)
        torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-6, atol=0)
    elif method == "fedavg":
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
    else:
        assert torch.equal(got.cpu(), want)


def _signed_zero_stack(K, D, seed):
    """(K, D) normals with, in every lane of the first tile, ties of +0.0
    and -0.0 (half the rows each), as a sign-flip attack leaves them."""
    x = _stack(K, D, seed)
    x[:, :2048] = 0.0
    x[K // 2:, :2048] = -0.0
    return x


@pytest.mark.parametrize("K", (1, 3, 17, 54))
@pytest.mark.parametrize("D", (2048, 5000, 6145))
def test_fused_candidates_bit_exact(cuda, K, D):
    q, s, d = ops.quantize_stack(_stack(K, D, K + D))
    base = torch.randn((D,), generator=torch.Generator().manual_seed(D)) * 0.05
    got = ops.candidates_from_quantized(base.to(cuda), q.to(cuda), s.to(cuda), d)
    want = ops.candidates_from_quantized(base, q, s, d)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("K", F32_KS)
@pytest.mark.parametrize("D", (2048, 5000, 6145))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("zeros", (False, True), ids=("normal", "signed_zero"))
def test_f32_aggregate_matches_plain(cuda, K, D, method, zeros):
    x = (_signed_zero_stack if zeros else _stack)(K, D, 3 * K + D)
    w = torch.rand((K,), generator=torch.Generator().manual_seed(K))
    trim = (K - 1) // 2
    got = ops.aggregate(x.to(cuda), method, weights=w.to(cuda), trim=trim).cpu()
    w_cpu = normalize_weights(K, w.to(cuda), cuda).cpu()   # same weights
    if method == "fedavg":
        want = ops.fedavg_agg(x, w_cpu)
    else:
        want = ops.aggregate(x, method, trim=trim)
    if method == "cwmed" or zeros:
        assert torch.equal(got, want)                 # by value
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_kernel_counts_its_launches(cuda):
    before = quantize_stack_kernel.launches
    quantize_stack_kernel(torch.zeros((2, 2048), device=cuda))
    assert quantize_stack_kernel.launches == before + 1


def test_round_on_the_card_matches_the_cpu_port(cuda):
    from repro_torch.api import build_runtime
    from repro_torch.data import make_femnist_like
    from repro_torch.fl.adapter import femnist_adapter

    ds = make_femnist_like(num_clients=24, mean_samples=40, test_size=200, seed=3)
    cfg = dict(active_proportion=0.5, k_updates=3, local_steps=2,
               local_batch=8, val_batch=16, quantize_chain=True,
               use_kernels=True)
    init = femnist_adapter(8).init(torch.Generator().manual_seed(0))
    gpu = build_runtime(femnist_adapter(8), ds, cfg, initial_params=init,
                        device="cuda")
    cpu = build_runtime(femnist_adapter(8), ds, cfg, initial_params=init,
                        device="cpu")
    for _ in range(2):
        assert gpu.run_round() == cpu.run_round()
    assert gpu.chain.verify() and cpu.chain.verify()
    for k, leaves in cpu.global_params().items():
        for kk, v in leaves.items():
            torch.testing.assert_close(gpu.global_params()[k][kk].cpu(), v,
                                       rtol=0, atol=1e-5)
