"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: these skip without a GPU (the check runs inside a fixture,
never at import).  On a machine with one:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q

The plain versions run on CPU copies of the same inputs.  quantize,
dequantize, the fused candidates and the f32 fedavg (given the same
weights) and trimmed mean are bit-exact; the f32 median is equal by value
(+0.0 and -0.0 tie in a sort); the fused aggregation is exact for cwmed
and trimmed_mean and within rtol 1e-6 for fedavg when each device
normalizes the weights itself, and bit-exact for every method at every K
given the same normalized weights.
The trimmed mean of a lane whose zeros carry random signs is held by
value: where the trim cuts a run of tied zeros, which zeros are kept
depends on the sort's tie order (K = 3 over +0, -0, +0 keeps either), and
torch.sort's tie order is not defined.
"""
import pytest
import torch

from repro_torch.core.aggregation import normalize_weights
from repro_torch.kernels import ops
from repro_torch.kernels.cwmed import (
    _CWMED, _TRIMMED_MEAN, _launch_sort, cwmed_kernel, median_of_sorted,
    sort_design, trimmed_mean_kernel, trimmed_mean_of_sorted,
)
from repro_torch.kernels.fused_agg import (
    METHODS, _fused_path, _launch_fused, fused_agg_kernel, fused_agg_ref,
    fused_design,
)
from repro_torch.kernels.quantize import (
    dequantize_kernel, dequantize_ref, quantize_kernel, quantize_stack_kernel,
)

F32_KS = (1, 2, 3, 8, 17, 90)
# the fused kernel's K: every side of its network widths (8, 16, 32), of the
# run merge's runs (32, 64, 96) and of its largest K (128, the insertion
# sort above), the tiered path's slices (44-51) and chip_smoke.py's edge list
FUSED_KS = (1, 3, 8, 16, 17, 31, 32, 33, 44, 51, 63, 64, 65, 90, 96, 127,
            128, 129, 200)
# the same sides for the f32 sorts
SORT_KS = (1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 44, 51, 63, 64, 65, 90,
           96, 127, 128, 129, 200)
# K of the sorts' designs on adversarial columns: every K > 32 side above
DESIGN_KS = (33, 44, 51, 63, 64, 65, 90, 127, 128, 129)
COLUMNS = ("ascending", "descending", "equal", "duplicate_runs",
           "signed_zeros", "outlier")
SORT_DS = (1, 255, 257, 6145, 428350)

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


def _bits(t):
    return t.cpu().view(torch.int32)


def _sort_stacks(K, D, seed):
    """(K, D) update-sized normals whose lanes cycle through four kinds:
    i % 4 == 1 all zeros, the first K // 2 rows +0.0 and the rest -0.0 (a
    sign-flip attack's ties); i % 4 == 2 zeros of random sign among
    normals; i % 4 == 3 half the rows equal to row 0 (ties of one value).
    Returns it and a copy with +inf in some rows of lanes i % 8 == 0 and
    -inf in some rows of lanes i % 8 == 4, for the median only (a trimmed
    mean over both infinities is NaN)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((K, D), generator=g) * 1e-3
    lane = torch.arange(D)
    split = lane % 4 == 1
    x[:, split] = 0.0
    x[K // 2:, split] = -0.0
    rand = lane % 4 == 2
    zero = (torch.rand((K, D), generator=g) < 0.5) & rand
    sign = torch.where(torch.rand((K, D), generator=g) < 0.5, -1.0, 1.0)
    x = torch.where(zero, 0.0 * sign, x)
    dup = lane % 4 == 3
    x[1::2, dup] = x[0, dup]
    inf = x.clone()
    rows = torch.arange(K)[:, None]
    inf[(rows % 3 == 0) & (lane % 8 == 0)] = float("inf")
    inf[(rows % 3 == 1) & (lane % 8 == 4)] = float("-inf")
    return x, inf, rand


@pytest.mark.parametrize("K", SORT_KS)
@pytest.mark.parametrize("D", SORT_DS)
def test_sort_kernels_match_plain(cuda, K, D):
    x, inf, rand = _sort_stacks(K, D, 7 * K + D)
    srt = torch.sort(x, dim=0).values
    assert torch.equal(cwmed_kernel(x.to(cuda)).cpu(), median_of_sorted(srt))
    assert torch.equal(cwmed_kernel(inf.to(cuda)).cpu(),
                       median_of_sorted(torch.sort(inf, dim=0).values))
    for trim in sorted({t for t in (1, (K - 1) // 2) if 2 * t < K}):
        got = trimmed_mean_kernel(x.to(cuda), trim=trim).cpu()
        want = trimmed_mean_of_sorted(srt, trim)
        assert torch.equal(got, want), trim
        assert torch.equal(_bits(got[~rand]), _bits(want[~rand])), trim


@pytest.mark.parametrize("K", range(1, 21))
def test_sort_network_on_every_zero_one_column(cuda, K):
    """Column c holds the bits of c: all 2**K 0/1 patterns.  By the 0-1
    principle a comparator network that puts the right value at a sorted
    position for every 0/1 input does so for every input, so the median's
    agreement here is a proof for its positions at this K."""
    c = torch.arange(2 ** K)
    x = ((c[None, :] >> torch.arange(K)[:, None]) & 1).to(torch.float32)
    srt = torch.sort(x, dim=0).values
    assert torch.equal(cwmed_kernel(x.to(cuda)).cpu(), median_of_sorted(srt))
    for trim in range(1, (K - 1) // 2 + 1):
        got = trimmed_mean_kernel(x.to(cuda), trim=trim).cpu()
        assert torch.equal(_bits(got), _bits(trimmed_mean_of_sorted(srt, trim))), trim


@pytest.mark.parametrize("K", FUSED_KS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("quantize_out", (False, True), ids=("f32", "qout"))
def test_fused_agg_bit_exact_at_every_K(cuda, K, method, quantize_out):
    """Given the same normalized weights the kernel is its plain version bit
    for bit: fedavg is one FMA chain in both, the sorts' order statistics
    carry no -0.0 (an int8 zero dequantizes to +0.0)."""
    q, s, _ = ops.quantize_stack(_stack(K, 6145, 5 * K))
    w = normalize_weights(K, torch.rand((K,), generator=torch.Generator().manual_seed(K)))
    trim = (K - 1) // 2
    kw = dict(method=method, trim=trim, quantize_out=quantize_out)
    got = fused_agg_kernel(q.to(cuda), s.to(cuda), w.to(cuda), **kw)
    want = fused_agg_ref(q, s, w, method, trim, quantize_out)
    for g, h in zip(got if quantize_out else (got,), want if quantize_out else (want,)):
        assert torch.equal(g.cpu(), h)
        if g.dtype == torch.float32:
            assert torch.equal(_bits(g), _bits(h))


def _columns(K, D, kind, seed):
    """(K, D) f32 whose every column is of one kind, and the lanes whose
    zeros carry random signs (a trimmed mean there is held by value)."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.arange(K, dtype=torch.float32)[:, None]
    scale = (torch.rand(D, generator=g) * 1.5 + 0.5) * 1e-3
    rand = torch.zeros(D, dtype=torch.bool)
    if kind in ("ascending", "descending"):
        x = (rows - K / 2) * scale + torch.randn(D, generator=g) * 1e-3
        if kind == "descending":
            x = x.flip(0)
    elif kind == "equal":
        x = (torch.randn(D, generator=g) * 1e-3).expand(K, D).clone()
    elif kind == "duplicate_runs":
        levels = torch.randn((3, D), generator=g) * 1e-3
        pick = torch.randint(0, 3, (K, D), generator=g)
        x = torch.gather(levels, 0, pick)
    elif kind == "signed_zeros":
        x = torch.randn((K, D), generator=g) * 1e-3
        rand = torch.arange(D) % 2 == 1
        zero = (torch.rand((K, D), generator=g) < 0.4) & rand
        sign = torch.where(torch.rand((K, D), generator=g) < 0.5, -1.0, 1.0)
        x = torch.where(zero, 0.0 * sign, x)
        x[:, : D // 4 * 2: 2] = 0.0          # whole lanes of zeros,
        x[K // 2:, : D // 4 * 2: 2] = -0.0   # the later rows -0.0
    else:  # outlier: one row a lane 1000 times the rest, of either sign
        x = torch.randn((K, D), generator=g) * 1e-3
        at = torch.randint(0, K, (D,), generator=g)
        x[at, torch.arange(D)] = torch.where(torch.rand(D, generator=g) < 0.5,
                                              -1.0, 1.0)
    return x.contiguous(), rand


@pytest.mark.parametrize("kind", COLUMNS)
@pytest.mark.parametrize("K", DESIGN_KS)
def test_sort_designs_bit_exact_on_adversarial_columns(cuda, K, kind):
    """Columns that stress a merge of sorted runs (ascending, descending,
    all equal, long runs of one value, +-0.0 ties, one huge outlier),
    through the design each C entry picks at K and through the insertion
    sort (its `insertion` flag): the f32 median by value,
    its trimmed mean bit for bit (by value where zeros carry random signs);
    the fused forms, with and without quantize_out, bit for bit."""
    D = 6144
    x, rand = _columns(K, D, kind, 11 * K + COLUMNS.index(kind))
    srt = torch.sort(x, dim=0).values
    q, s, _ = ops.quantize_stack(x)
    w = torch.full((K,), 1.0 / K)
    xg, qg, sg, wg = x.to(cuda), q.to(cuda), s.to(cuda), w.to(cuda)
    for ins in (False, True):
        got = _launch_sort(xg, _CWMED, 0, insertion=ins).cpu()
        assert torch.equal(got, median_of_sorted(srt)), ins
        for trim in sorted({1, (K - 1) // 2}):
            got = _launch_sort(xg, _TRIMMED_MEAN, trim, insertion=ins).cpu()
            want = trimmed_mean_of_sorted(srt, trim)
            assert torch.equal(got, want), (ins, trim)
            assert torch.equal(_bits(got[~rand]), _bits(want[~rand])), (ins, trim)
        for method, trim in (("cwmed", 0), ("trimmed_mean", 1),
                             ("trimmed_mean", (K - 1) // 2)):
            for qout in (False, True):
                got = _launch_fused(qg, sg, wg, method, trim, qout, insertion=ins)
                want = fused_agg_ref(q, s, w, method, trim, qout)
                for a, b in zip(got if qout else (got,), want if qout else (want,)):
                    assert torch.equal(a.cpu(), b), (ins, method, trim, qout)
                    if b.dtype == torch.float32:
                        assert torch.equal(_bits(a), _bits(b)), (ins, method, trim)


# the design each C entry reports for K rows (csrc/sort_net.cuh sort_path)
REPORTED = {1: "register network W=8", 8: "register network W=8",
            9: "register network W=16", 16: "register network W=16",
            17: "register network W=32", 32: "register network W=32",
            33: "run merge R=2", 64: "run merge R=2", 65: "run merge R=3",
            96: "run merge R=3", 97: "run merge R=4", 128: "run merge R=4",
            129: "insertion sort in shared memory",
            200: "insertion sort in shared memory"}


@pytest.mark.parametrize("K", sorted(REPORTED))
def test_sort_entries_report_their_design(cuda, K):
    """Both C entries report the same design for K, the insertion sort
    with the `insertion` flag, and the fused entry asks for f32 scratch
    only where the run merge requantizes (fedavg never sorts)."""
    assert sort_design(K) == REPORTED[K]
    assert sort_design(K, insertion=True) == "insertion sort in shared memory"
    for method in ("cwmed", "trimmed_mean"):
        assert fused_design(K, method) == REPORTED[K]
        assert fused_design(K, method, insertion=True) == sort_design(K, True)
        for qout in (False, True):
            scratch = _fused_path(K, method, qout, False)[2]
            assert scratch == (qout and REPORTED[K].startswith("run merge"))
    assert fused_design(K, "fedavg") == "fedavg"


@pytest.mark.parametrize("K", range(1, 21))
def test_fused_sort_on_every_zero_one_column(cuda, K):
    """The 0-1 proof of the fused kernel's network (see the f32 test
    above): int8 columns holding the bits of their index, scales 1.0."""
    n = 2 ** K
    D = -(-n // 2048) * 2048
    c = torch.arange(D) % n
    q = ((c[None, :] >> torch.arange(K)[:, None]) & 1).to(torch.int8)
    s = torch.ones((K, D // 2048))
    w = torch.full((K,), 1.0 / K)
    srt = torch.sort(q.to(torch.float32), dim=0).values
    got = fused_agg_kernel(q.to(cuda), s.to(cuda), w.to(cuda), method="cwmed")
    assert torch.equal(got.cpu(), median_of_sorted(srt))
    for trim in range(1, (K - 1) // 2 + 1):
        got = fused_agg_kernel(q.to(cuda), s.to(cuda), w.to(cuda),
                               method="trimmed_mean", trim=trim)
        assert torch.equal(_bits(got), _bits(trimmed_mean_of_sorted(srt, trim))), trim


@pytest.mark.parametrize("K", (1, 3, 8, 17))
@pytest.mark.parametrize("D", (1, 2047, 2049, 6145))
def test_quantize_bit_exact_on_ragged_zero_and_signed_zero(cuda, K, D):
    """Ragged D (padded once by ops), an all-zero tile of +0.0 and -0.0 in
    every row (scale 1.0, q 0), signed zeros among normals, and exact half
    steps; the single-vector launch on every row."""
    x = _stack(K, D, 17 * K + D)
    if D > 2048:
        x[:, :2048] = 0.0
        x[K // 2:, :2048:3] = -0.0
    x[:, -1] = -0.0
    q, s, d = ops.quantize_stack(x.to(cuda))
    rq, rs, rd = ops.quantize_stack(x)
    assert d == rd
    assert torch.equal(q.cpu(), rq) and torch.equal(_bits(s), _bits(rs))
    for k in range(K):
        q1, s1, _ = ops.quantize(x[k].to(cuda))
        assert torch.equal(q1.cpu(), rq[k]) and torch.equal(_bits(s1), _bits(rs[k]))


@pytest.mark.parametrize("n", (2048, 4096, 6144, 430080))
def test_dequantize_bit_exact(cuda, n):
    """All-zero tiles (scale 1.0), tiles that reach +-127, random tiles."""
    g = torch.Generator().manual_seed(n)
    nblk = n // 2048
    q = torch.randint(-127, 128, (n,), generator=g, dtype=torch.int8)
    s = torch.rand((nblk,), generator=g) * 1e-4
    q[:2048] = 0
    s[0] = 1.0
    q[2048::2048] = 127
    q[2049::2048] = -127
    want = dequantize_ref(q, s)
    assert torch.equal(_bits(dequantize_kernel(q.to(cuda), s.to(cuda))), _bits(want))


def test_kernel_counts_its_launches(cuda):
    before = quantize_stack_kernel.launches
    quantize_stack_kernel(torch.zeros((2, 2048), device=cuda))
    assert quantize_stack_kernel.launches == before + 1
    before = dequantize_kernel.launches
    dequantize_kernel(torch.zeros(2048, dtype=torch.int8, device=cuda),
                      torch.ones(1, device=cuda))
    assert dequantize_kernel.launches == before + 1
    before = quantize_kernel.launches
    quantize_kernel(torch.zeros(2048, device=cuda))
    assert quantize_kernel.launches == before + 1
    for K in (8, 33):                    # a register network, the run merge
        design = sort_design(K)
        for qout in (False, True):       # (and its requantizing pass)
            before = fused_agg_kernel.launches
            by = fused_agg_kernel.designs.get(design, 0)
            fused_agg_kernel(torch.zeros((K, 2048), dtype=torch.int8, device=cuda),
                             torch.ones((K, 1), device=cuda),
                             torch.ones(K, device=cuda) / K, method="cwmed",
                             quantize_out=qout)
            assert fused_agg_kernel.launches == before + 1
            assert fused_agg_kernel.designs[design] == by + 1
    for K in (8, 33):                    # a register network, the run merge
        x = torch.zeros((K, 300), device=cuda)
        design = sort_design(K)
        for fn, kw in ((cwmed_kernel, {}), (trimmed_mean_kernel, {"trim": 1})):
            before, by = fn.launches, fn.designs.get(design, 0)
            fn(x, **kw)
            assert fn.launches == before + 1
            assert fn.designs[design] == by + 1


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


def test_tiered_round_on_the_card_stores_the_plain_slice_blobs(cuda):
    """One tiers=2 int8 cwmed round over 120 virtual clients, everyone
    active: round committee 30, 2 slices of 45 (11-member sub-committees,
    34 trainers), so a slice that accepts more than 32 updates runs the
    fused kernel's K > 32 column form with quantize_out.  Every slice's
    blob equals, bit for bit, fused_agg_ref(..., quantize_out=True) over
    the slice's own rows."""
    from repro_torch.api import build_runtime
    from repro_torch.core.aggregation import flatten_updates
    from repro_torch.data import VirtualFederatedDataset, make_femnist_like
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.pipeline import resolve
    from repro_torch.kernels.quantize import quantize_stack_ref
    from torch.nn import functional as F

    ds = VirtualFederatedDataset(make_femnist_like(
        num_clients=24, mean_samples=40, test_size=200, seed=3), 120)
    inner, packer = resolve("validator", "committee"), resolve("packer", "hier")
    rows, packed = [], []

    class Spy:
        def prepare(self, ctx):
            inner.prepare(ctx)

        def __call__(self, ctx):
            inner(ctx)
            rows.append(dict(ctx.updates))

    def spy_packer(ctx):
        packed.append((list(ctx.hier.sub_blobs),
                       [list(c) for c in ctx.hier.sub_contributors]))
        packer(ctx)

    cfg = dict(active_proportion=1.0, committee_fraction=0.25, local_steps=2,
               local_batch=8, val_batch=16, quantize_chain=True,
               use_kernels=True, aggregation="cwmed")
    rt = build_runtime(femnist_adapter(8), ds, cfg, tiers=2, device="cuda",
                       initial_params=femnist_adapter(8).init(
                           torch.Generator().manual_seed(0)),
                       stages={"validator": Spy(), "packer": spy_packer})
    before = fused_agg_kernel.launches
    rt.run_round()
    assert fused_agg_kernel.launches == before + 3     # 2 slices + tier 2
    assert rt.chain.verify()
    (blobs, contributors), = packed
    assert max(len(ids) for ids in contributors) > 32
    for updates, ids, blob in zip(rows, contributors, blobs):
        stack, _ = flatten_updates([updates[u] for u in ids])
        q, s = quantize_stack_ref(F.pad(stack.cpu(), (0, (-stack.shape[1]) % 2048)))
        w = torch.full((len(ids),), 1.0 / len(ids))
        pq, ps = fused_agg_ref(q, s, w, "cwmed", 1, quantize_out=True)
        assert torch.equal(blob["q"].cpu(), pq)
        assert torch.equal(_bits(blob["scales"].cpu()), _bits(ps))


def test_async_round_pair_on_the_card_is_bit_identical(cuda):
    """One small tiers=2 int8 round pair (``committee_int8`` inside) under
    both schedules from the same init: the same RoundLogs, committees,
    ``hier_logs``, chain payloads and params, bit for bit, and the same
    kernel launches; slice 1's training is dispatched before slice 0's
    validation finalizes."""
    from repro_torch.api import build_runtime
    from repro_torch.data import make_femnist_like
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_leaves

    ds = make_femnist_like(num_clients=24, mean_samples=40, test_size=200,
                           seed=3)
    cfg = dict(active_proportion=1.0, committee_fraction=0.3, k_updates=4,
               local_steps=3, local_batch=8, quantize_chain=True,
               use_kernels=True, seed=0)
    init = femnist_adapter(8).init(torch.Generator().manual_seed(0))
    rts, launches = {}, {}
    for schedule in ("sequential", "async"):
        rt = build_runtime(femnist_adapter(8), ds, cfg, tiers=2, device="cuda",
                           schedule=schedule, initial_params=init,
                           stages={"validator": "committee_int8"})
        before = launch_counts()
        rt.run(2, eval_every=2)
        after = launch_counts()
        rts[schedule] = rt
        launches[schedule] = {k: after[k] - before[k] for k in after}
    seq, asy = rts["sequential"], rts["async"]
    assert launches["sequential"] == launches["async"]
    assert seq.logs == asy.logs and seq.committee == asy.committee
    assert seq.hier_logs == asy.hier_logs
    assert seq.chain.verify() and asy.chain.verify()
    assert [b.hash for b in seq.chain.blocks] == [b.hash for b in asy.chain.blocks]
    for bs, ba in zip(seq.chain.blocks, asy.chain.blocks):
        if bs.kind != "committee":
            for x, y in zip(tree_leaves(seq.chain.raw_payload(bs)),
                            tree_leaves(asy.chain.raw_payload(ba))):
                assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    for x, y in zip(tree_leaves(seq.global_params()),
                    tree_leaves(asy.global_params())):
        assert torch.equal(_bits(x.cpu()), _bits(y.cpu()))
    order = asy.pipeline.last_order
    assert order.index("train_dispatch[1]") < order.index("validate_finalize[0]")


def test_committee_finalize_waits_for_its_score_copy(cuda):
    """``dispatch`` returns with the score program still running, and
    ``finalize`` reads the same (P, Q) matrix a blocking ``.cpu()`` of the
    scores reads: the host waits on the copy's event before it reads."""
    import types

    import numpy as np

    from repro_torch.core.consensus import CommitteeConsensus
    from repro_torch.fl.pipeline import CommitteeValidator, RoundContext

    P, Q = 54, 36
    src = torch.rand((P, Q), generator=torch.Generator().manual_seed(0)).to(cuda)
    want = src.cpu().numpy()

    class Delayed(CommitteeValidator):
        def _scores_device(self, ctx):
            torch.cuda._sleep(200_000_000)     # about 0.1 s of device time
            return src * 1.0

    cfg = types.SimpleNamespace(collusion=False, k_updates=8)
    ctx = RoundContext(cfg=cfg, rng=np.random.default_rng(0), adapter=None,
                       data=None, params=None, round=0, device=cuda,
                       trainers=list(range(P)),
                       round_committee=list(range(100, 100 + Q)),
                       cohort_updates=[None] * P)
    ctx.consensus = CommitteeConsensus(ctx.round_committee)
    ctx.consensus.bind_score_table(ctx.score_table)
    validator = Delayed()
    validator.dispatch(ctx)
    assert not torch.cuda.current_stream().query()     # still in flight
    validator.finalize(ctx)
    np.testing.assert_array_equal(ctx.cohort_scores, want)
    for i, uploader in enumerate(ctx.trainers):
        assert [ctx.score_table[uploader][m] for m in ctx.round_committee] == \
               [float(v) for v in want[i]]


@pytest.mark.parametrize("mode", ["standard", "bflc"])
def test_train_step_on_the_card_matches_the_cpu(cuda, mode):
    """One AdamW step of a smoke config on the card against the same port
    step on the CPU from the same params and batch: the loss within rtol
    1e-5 and each gradient leaf (the first moment over 0.1 after one step)
    within 1e-3 of its largest |g| (float32 GEMMs of other kernels)."""
    from repro_torch.configs import registry
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.models import init_model
    from repro_torch.models.transformer import Batch
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.tree import tree_map, tree_paths

    cfg = registry.smoke_config("phi4-mini-3.8b")
    opt = adamw(linear_warmup_cosine(1e-3, 1, 3))
    p = init_model(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (12, 33), generator=g,
                         dtype=torch.int32)
    pos = torch.arange(32, dtype=torch.int32)[None].expand(12, 32)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        b = Batch(tokens=toks[:8, :-1].to(dev), positions=pos[:8].to(dev),
                  targets=toks[:8, 1:].to(dev),
                  loss_mask=torch.ones((8, 32), device=dev))
        v = Batch(tokens=toks[8:, :-1].to(dev), positions=pos[8:].to(dev),
                  targets=toks[8:, 1:].to(dev),
                  loss_mask=torch.ones((4, 32), device=dev))
        params = tree_map(lambda t: t.to(dev), p)
        step = make_train_step(cfg, opt, mode=mode, num_cohorts=4,
                               committee_size=4)
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        out[dev.type] = step(state, b, v)
    (cpu_state, cpu_m), (gpu_state, gpu_m) = out["cpu"], out["cuda"]
    assert abs(float(gpu_m["loss"]) - float(cpu_m["loss"])) <= \
        1e-5 * abs(float(cpu_m["loss"]))
    for (path, a), (_, b) in zip(tree_paths(gpu_state.opt_state["m"]),
                                 tree_paths(cpu_state.opt_state["m"])):
        scale = float(b.abs().max())
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * scale, path
    assert int(gpu_state.step) == 1


def test_checkpoint_roundtrip_from_the_card(cuda, tmp_path):
    """CUDA tensors save as their host bits and load back onto the card
    (f32, bf16, int8 blob), and a blob decodes there by the dequantize
    kernel to the plain decode's bits."""
    from repro_torch.checkpoint import load_model_payload, load_pytree, save_pytree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn((300, 17), generator=gen, device=cuda),
            "h": torch.randn((9,), generator=gen, device=cuda).to(torch.bfloat16),
            "i": (torch.arange(5, device=cuda, dtype=torch.int32), None)}
    path = str(tmp_path / "t.msgpack")
    save_pytree(path, tree)
    got = load_pytree(path, device=cuda)
    assert got["i"][1] is None
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        if b is None:
            continue
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.uint8) if a.dtype != torch.bool else a,
                           b.view(torch.uint8) if b.dtype != torch.bool else b)
    params = {"a": tree["w"], "b": torch.randn((5000,), generator=gen,
                                               device=cuda)}
    codec = ops.Int8UpdateCodec(params)
    blob = codec.encode(params)
    save_pytree(str(tmp_path / "blob.msgpack"), blob)
    reset_launch_counts()
    decoded = load_model_payload(str(tmp_path / "blob.msgpack"), codec=codec,
                                 device=cuda)
    assert launch_counts()["dequantize"] == 1
    plain = ops.Int8UpdateCodec({k: v.cpu() for k, v in params.items()}).decode(
        {"q": blob["q"].cpu(), "scales": blob["scales"].cpu(), "d": blob["d"]})
    for k in params:
        assert torch.equal(decoded[k].cpu(), plain[k])


@pytest.mark.parametrize("chunk", (1, 2, 4))
@pytest.mark.parametrize("P", (8, 5))
def test_trainer_rows_on_the_card_independent_of_call_size(cuda, P, chunk):
    """test_torch_trainer_invariance's check on the card, at atol 0."""
    import numpy as np

    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.client import make_local_train_fn
    from repro_torch.tree import tree_leaves, tree_map

    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.normal(size=(P, 3, 8, 28, 28, 1))
                          .astype(np.float32)).to(cuda)
    ys = torch.from_numpy(rng.integers(0, 62, (P, 3, 8))).to(cuda)
    adapter = femnist_adapter(8)
    params = tree_map(lambda a: a.to(cuda),
                      adapter.init(torch.Generator().manual_seed(0)))
    train = make_local_train_fn(adapter, 0.05, 0.9)
    whole = train(params, xs, ys)
    parts = tree_map(lambda *l: torch.cat(l), *[
        train(params, xs[i:i + chunk], ys[i:i + chunk])
        for i in range(0, P, chunk)])
    for a, b in zip(tree_leaves(parts), tree_leaves(whole)):
        assert torch.equal(a, b)


# (P, M, K, N): every path of the kernel (csrc/client_gemm.cu
# `launch_layout`): the stream pass (K <= 16), the 128 x 64 and 128 x 96
# tiles (M >= 512), the 32 x 128 thin forward tile, the 48 x 64, 64 x 64
# and 16 x 32 weight-gradient tiles (A transposed),
# the 32 x 64 tile for the rest; M = 1 and 9, K on every side of the split
# (SPLIT_K = 2048) and conv1's 25,088, N = 62 and 288
GEMM_SHAPES = ((3, 70, 9, 32), (2, 5, 3136, 128), (4, 288, 130, 64),
               (2, 1, 2047, 62), (2, 9, 2048, 288), (2, 9, 2049, 62),
               (2, 9, 25088, 32), (3, 600, 288, 64), (2, 700, 64, 288),
               (2, 128, 100, 64), (2, 40, 300, 288))


def _offset(t):
    """A contiguous copy of t whose base is 4 bytes past a 16-byte line."""
    out = torch.empty(t.numel() + 1, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


@pytest.mark.parametrize("layout", ("nn", "tn", "nt", "tt", "offset"))
@pytest.mark.parametrize("ones_row", (False, True))
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_client_gemm_matches_per_client_mm(cuda, shape, ones_row, layout):
    """Every path equals the exact-order plain version by value (a zero
    sum's sign may differ), is within the f32 dot-product bound of a
    float64 product, and gives one client alone the same bits."""
    from repro_torch.kernels.client_gemm import (
        client_gemm_kernel, client_gemm_ordered_ref, client_gemm_ref,
    )

    P, M, K, N = shape
    g = torch.Generator().manual_seed(M + K + N)
    a = (torch.randn((P, K, M), generator=g).transpose(1, 2)
         if layout[0] == "t" else torch.randn((P, M, K), generator=g))
    b = (torch.randn((P, N, K), generator=g).transpose(1, 2)
         if layout[1:] == "t" else torch.randn((P, K, N), generator=g))
    bias = torch.randn((P, N), generator=g)
    ag, bg = a.to(cuda), b.to(cuda)
    if layout == "offset":
        ag, bg = _offset(ag), _offset(bg)
    got = client_gemm_kernel(ag, bg, bias.to(cuda), ones_row=ones_row).cpu()
    exact = client_gemm_ordered_ref(a, b, bias, ones_row=ones_row)
    assert torch.equal(got, exact)
    want = client_gemm_ref(a.double(), b.double(), bias.double(), ones_row=ones_row)
    scale = (client_gemm_ref(a.abs().double(), b.abs().double(), ones_row=ones_row)
             + bias.abs().double()[:, None])
    assert float(((got.double() - want).abs() / scale).max()) <= K * 2 ** -23
    # one client's rows alone are the same bits
    alone = client_gemm_kernel(ag[1:2], bg[1:2], bias[1:2].to(cuda),
                               ones_row=ones_row)
    assert torch.equal(alone.cpu().view(torch.int32), got[1:2].view(torch.int32))


# the trainer's eleven products a step at width 32, batch 32: (M, K, N) a
# client, A transposed, B transposed, ones row, and the path each takes
TRAINER_GEMM_PATHS = (
    ((25088, 9, 32), False, False, False, "stream, A along k 16 B, B along n 16 B, 1 chunk"),
    ((9, 25088, 32), True, False, True, "tile 16x32, A along m, B along n 16 B, 49 chunks"),
    ((6272, 288, 64), False, False, False, "tile 128x64, A along k 16 B, B along n 16 B, 1 chunk"),
    ((6272, 64, 288), False, True, False, "tile 128x96, A along k 16 B, B along k 16 B, 1 chunk"),
    ((288, 6272, 64), True, False, True, "tile 48x64, A along m 16 B, B along n 16 B, 13 chunks"),
    ((32, 3136, 128), False, False, False, "tile 32x128, A along k 16 B, B along n 16 B, 7 chunks"),
    ((32, 128, 3136), False, True, False, "tile 32x64, A along k 16 B, B along k 16 B, 1 chunk"),
    ((3136, 32, 128), True, False, True, "tile 64x64, A along m 16 B, B along n 16 B, 1 chunk"),
    ((32, 128, 62), False, False, False, "tile 32x64, A along k 16 B, B along n, 1 chunk"),
    ((32, 62, 128), False, True, False, "tile 32x64, A along k, B along k, 1 chunk"),
    ((128, 32, 62), True, False, True, "tile 32x64, A along m 16 B, B along n, 1 chunk"),
)


@pytest.mark.parametrize("form", TRAINER_GEMM_PATHS)
def test_client_gemm_path_of_the_trainer_forms(cuda, form):
    """The kernel's entry picks each trainer product's path from its shape
    and layout, the same at P = 1, 2 and 54."""
    from repro_torch.kernels.client_gemm import client_gemm_path

    (M, K, N), a_t, b_t, ones_row, want = form
    got = set()
    for P in (1, 2, 54):
        a = (torch.empty((P, K, M), device=cuda).transpose(1, 2) if a_t
             else torch.empty((P, M, K), device=cuda))
        b = (torch.empty((P, N, K), device=cuda).transpose(1, 2) if b_t
             else torch.empty((P, K, N), device=cuda))
        got.add(client_gemm_path(a, b, ones_row))
    assert got == {want}


def test_client_gemm_path_reads_16_bytes_only_where_aligned(cuda):
    from repro_torch.kernels.client_gemm import client_gemm_path

    a = torch.empty((2, 64, 288), device=cuda)
    b = torch.empty((2, 288, 64), device=cuda)
    assert "A along k 16 B, B along n 16 B" in client_gemm_path(a, b)
    off = torch.empty(a.numel() + 1, device=cuda)[1:].view(a.shape)
    assert "A along k, B along n 16 B" in client_gemm_path(off, b)
    odd = torch.empty((2, 64, 287), device=cuda)[:, :, :286]     # rows of 287
    assert "A along k," in client_gemm_path(odd, torch.empty((2, 286, 64), device=cuda))


@pytest.mark.parametrize("chunk", (1, 1000, 4096, 64 << 20))
def test_chain_digest_of_device_leaves_streams_the_host_bytes(cuda, chunk):
    """Device leaves go to the hash through the pinned buffers, ``chunk``
    bytes at a time: the digest is the one of the same leaves on the host."""
    from repro_torch.core.blockchain import pytree_digest

    g = torch.Generator().manual_seed(chunk)
    host = {"w": torch.randn(300, 7, generator=g).t(), "s": torch.tensor(2.5),
            "q": torch.randint(-127, 128, (3, 2048), generator=g).to(torch.int8),
            "m": torch.rand(9, generator=g) > 0.5, "e": torch.zeros(0, 4),
            "b": torch.arange(6, dtype=torch.float64)}
    dev = {k: v.to(cuda) for k, v in host.items()}
    dev["w"] = dev["w"].t().contiguous().t()      # strided on the card too
    assert pytree_digest(dev, chunk) == pytree_digest(host)
