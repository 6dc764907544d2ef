"""The port's continuous-batching serve engine: the reference's serve tests
mirrored on ``repro_torch.serve``, the engine against the reference's on
the same traces, and a hot swap to a model block that an int8 round
commits through the ``top_k_int8`` packer and the ``fused_int8``
aggregator.

Oracles.  The reference pins every served request to a batch-1 greedy
oracle bit for bit, which holds there because XLA on the CPU gives a row
the same result at any batch size.  PyTorch's CPU matmul does not: one
row and four rows take other kernels, and most logits differ in their
last bits.  So every request is held to two oracles of the port's own
steps (``repro_torch.serve.engine.greedy_oracle``): decoding alone in row
``slot`` of the engine's batch shape, which is bit for bit by
construction, and the batch-1 oracle as the reference states it, whose
tokens agree on these traces because no top-2 logit margin comes near
the last-bit differences (PERF.md §6).

Against the reference engine (same weights, carried across through
numpy; the same ``VirtualClock`` trace): identical traces, admission /
first-token / finish times, versions and swap records, and equal token
ids; where a token differed, the failure names the reference's top-2
logit margin at that step.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.core.blockchain import Chain as JChain
from repro.launch.mesh import make_host_mesh
from repro.launch.shardings import ShardingPolicy
from repro.launch.steps import make_decode_step as j_make_decode
from repro.launch.steps import make_prefill_step as j_make_prefill
from repro.models import init_model as j_init
from repro.models.transformer import Batch as JBatch
from repro.serve import ChainParamSource as JChainParamSource
from repro.serve import ServeEngine as JServeEngine
from repro.serve import VirtualClock as JVirtualClock
from repro.serve import make_poisson_trace as j_make_poisson_trace
from repro_torch.configs import registry
from repro_torch.convert import from_numpy_tree
from repro_torch.core.blockchain import Chain
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.fused_agg import fused_agg_ref
from repro_torch.kernels.ops import Int8UpdateCodec
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import init_cache
from repro_torch.models.cache import insert_slot_cache
from repro_torch.checkpoint import save_pytree
from repro_torch.serve import (
    CKPT_RE,
    ChainParamSource,
    CheckpointParamSource,
    FifoScheduler,
    Request,
    ServeEngine,
    SlotTable,
    VirtualClock,
    checkpoint_name,
    make_poisson_trace,
)
from repro_torch.serve.engine import greedy_oracle
from repro_torch.tree import ravel_pytree, tree_leaves, tree_map

# the card's round commit, from chip_smoke.py at the repository root
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)
commit_scored_round = chip_smoke.commit_scored_round

torch.set_num_threads(2)
MAX_LEN = 48
CPU = torch.device("cpu")
SHAPE = dict(d_model=64, num_units=2, num_heads=2, num_kv_heads=2, d_ff=128,
             vocab_size=512)


@pytest.fixture(scope="module")
def cfg():
    return registry.get_config("olmo-1b", **SHAPE)


@pytest.fixture(scope="module")
def jcfg():
    return jreg.get_config("olmo-1b", **SHAPE)


@pytest.fixture(scope="module")
def ref_np(jcfg):
    """The reference's params v0 and v1, as numpy."""
    return [jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(k), jcfg))
            for k in (0, 9)]


@pytest.fixture(scope="module")
def params(ref_np):
    return from_numpy_tree(ref_np[0])


@pytest.fixture(scope="module")
def params1(ref_np):
    return from_numpy_tree(ref_np[1])


def test_greedy_oracle_logits(cfg, params):
    """``return_logits=True`` returns the same tokens and, beside them, the
    (max_new, V) logits each one is the argmax of."""
    req = make_poisson_trace(num_requests=1, rate=10.0, prompt_lens=(12,),
                             gen_lens=(6,), vocab_size=cfg.vocab_size,
                             seed=5)[0]
    for rows in (1, 3):
        plain = greedy_oracle(cfg, params, req.prompt, req.max_new,
                              max_len=MAX_LEN, rows=rows, row=rows - 1)
        tokens, logits = greedy_oracle(cfg, params, req.prompt, req.max_new,
                                       max_len=MAX_LEN, rows=rows,
                                       row=rows - 1, return_logits=True)
        assert tokens == plain
        assert logits.shape == (req.max_new, cfg.vocab_size)
        assert logits.argmax(-1).tolist() == tokens


def oracles_hold(cfg, params, result, req, num_slots):
    """The request's tokens equal both oracles (see the module docstring)."""
    same_row = greedy_oracle(cfg, params, req.prompt, req.max_new,
                             max_len=MAX_LEN, rows=num_slots,
                             row=max(result.slot, 0))
    batch1 = greedy_oracle(cfg, params, req.prompt, req.max_new,
                           max_len=MAX_LEN)
    return result.tokens == same_row and result.tokens == batch1


def mixed_trace(cfg, *, seed=1):
    rng = np.random.default_rng(seed)
    shapes = [(8, 5), (16, 12), (8, 1), (12, 3), (16, 8), (8, 6), (12, 10)]
    return [
        Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32),
            max_new=g,
            arrival=float(i),
        )
        for i, (s, g) in enumerate(shapes)
    ]


# ----------------------------------------------------------------------------
# building blocks
# ----------------------------------------------------------------------------


def test_insert_slot_cache_writes_one_row(cfg):
    big = init_cache(cfg, 3, MAX_LEN, torch.float32)
    before = tree_map(lambda t: t.clone(), big)
    small = tree_map(lambda t: torch.full_like(t, 7),
                     init_cache(cfg, 1, MAX_LEN, torch.float32))
    out = insert_slot_cache(big, small, 1)
    # unit leaves: stacked (num_units, B, ...) — batch axis 1
    for old, new in zip(tree_leaves(before["units"]), tree_leaves(out["units"])):
        assert torch.equal(new[:, 1], torch.full_like(old[:, 1], 7))
        assert torch.equal(new[:, 0], old[:, 0])
        assert torch.equal(new[:, 2], old[:, 2])
    # tail leaves: plain (B, ...) — batch axis 0
    for old, new in zip(tree_leaves(before["tail"]), tree_leaves(out["tail"])):
        assert torch.equal(new[1], torch.full_like(old[1], 7))
        assert torch.equal(new[0], old[0])


def test_insert_slot_cache_overwrites_a_recurrent_state():
    """An RWKV-6 cache's rows hold a state, not positions: inserting a
    request overwrites every leaf of its row (time-mix shift and wkv,
    channel-mix shift), so nothing of the slot's last request is left."""
    rcfg = registry.smoke_config("rwkv6-7b")
    big = tree_map(lambda t: torch.full_like(t, 3),
                   init_cache(rcfg, 3, MAX_LEN, torch.float32))
    small = tree_map(lambda t: torch.full_like(t, 7),
                     init_cache(rcfg, 1, MAX_LEN, torch.float32))
    out = insert_slot_cache(big, small, 2)
    leaves = tree_leaves(out["units"])
    assert len(leaves) == 3 and leaves[0].dtype == torch.float32
    for leaf in leaves:
        assert torch.equal(leaf[:, 2], torch.full_like(leaf[:, 2], 7))
        assert torch.equal(leaf[:, :2], torch.full_like(leaf[:, :2], 3))


def test_insert_slot_cache_overwrites_a_mamba_state():
    """A jamba cache's Mamba layer holds a conv window and an f32 SSM
    state, no positions: inserting a request overwrites both leaves of its
    row (and the attention layer's k / v / pos), so nothing of the slot's
    last request is left."""
    jcfg = registry.smoke_config("jamba-1.5-large-398b")
    big = tree_map(lambda t: torch.full_like(t, 3),
                   init_cache(jcfg, 3, MAX_LEN, torch.float32))
    small = tree_map(lambda t: torch.full_like(t, 7),
                     init_cache(jcfg, 1, MAX_LEN, torch.float32))
    out = insert_slot_cache(big, small, 1)
    mamba = out["units"][1]
    assert sorted(mamba) == ["conv", "ssm"]
    assert mamba["ssm"].dtype == torch.float32
    for leaf in tree_leaves(out["units"]):
        assert torch.equal(leaf[:, 1], torch.full_like(leaf[:, 1], 7))
        assert torch.equal(leaf[:, 0], torch.full_like(leaf[:, 0], 3))
        assert torch.equal(leaf[:, 2], torch.full_like(leaf[:, 2], 3))


def test_decode_step_logits_optin(cfg, params):
    with_logits = make_decode_step(cfg)
    no_logits = make_decode_step(cfg, return_logits=False)
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = torch.tensor([4, 9], dtype=torch.int32)
    t3, logits, _ = with_logits(params, toks, pos,
                                init_cache(cfg, 2, MAX_LEN, torch.float32))
    out = no_logits(params, toks, pos, init_cache(cfg, 2, MAX_LEN, torch.float32))
    assert len(out) == 2, "logits must be dropped when opted out"
    assert torch.equal(out[0], t3) and out[0].dtype == torch.int32
    assert logits.shape == (2, 1, cfg.vocab_size)


def test_scheduler_static_barrier():
    reqs = [Request(rid=i, prompt=np.zeros((4,), np.int32), max_new=2,
                    arrival=0.0) for i in range(4)]
    table = SlotTable(2)
    sched = FifoScheduler(reqs, policy="static")
    first = sched.admissions(table, 0.0)
    assert [b for b, _ in first] == [0, 1]
    for b, r in first:
        table.occupy(b, r.rid, r.max_new)
    table.release(0)
    # one slot free, one busy: static admits nothing until the batch drains
    assert sched.admissions(table, 0.0) == []
    table.release(1)
    assert len(sched.admissions(table, 0.0)) == 2


def test_scheduler_continuous_fills_any_free_slot():
    reqs = [Request(rid=i, prompt=np.zeros((4,), np.int32), max_new=2,
                    arrival=float(i)) for i in range(3)]
    table = SlotTable(2)
    sched = FifoScheduler(reqs, policy="continuous")
    got = sched.admissions(table, 0.0)
    assert len(got) == 1                      # only rid 0 has arrived
    table.occupy(got[0][0], 0, 2)
    got = sched.admissions(table, 5.0)        # rids 1,2 arrived; 1 slot free
    assert len(got) == 1 and got[0][1].rid == 1
    assert sched.queued == 1


def test_poisson_trace_shapes_and_reference_equal():
    kw = dict(num_requests=32, rate=10.0, prompt_lens=(4, 8), gen_lens=(2, 6),
              vocab_size=100, seed=3)
    trace = make_poisson_trace(**kw)
    assert len(trace) == 32
    arrivals = [r.arrival for r in trace]
    assert arrivals == sorted(arrivals) and arrivals[0] > 0
    assert all(r.prompt_len in (4, 8) and r.max_new in (2, 6) for r in trace)
    assert all(0 <= r.prompt.min() and r.prompt.max() < 100 for r in trace)
    for a, b in zip(trace, j_make_poisson_trace(**kw)):
        assert (a.rid, a.arrival, a.max_new) == (b.rid, b.arrival, b.max_new)
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_engine_rejects_oversized_request(cfg, params):
    eng = ServeEngine(cfg, params, num_slots=2, max_len=16, device="cpu")
    bad = [Request(rid=0, prompt=np.zeros((12,), np.int32), max_new=8)]
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.run(bad, clock=VirtualClock())


def test_engine_defaults_to_cuda(cfg, params):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, params)


# ----------------------------------------------------------------------------
# oracle parity
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_matches_single_request_oracle(cfg, params, policy):
    trace = mixed_trace(cfg)
    eng = ServeEngine(cfg, params, num_slots=3, max_len=MAX_LEN, device="cpu")
    rep = eng.run(trace, policy=policy, clock=VirtualClock())
    assert rep.policy == policy
    for res, req in zip(rep.results, trace):
        assert len(res.tokens) == req.max_new
        assert oracles_hold(cfg, params, res, req, 3), (policy, res.rid)
    m = rep.metrics()
    assert m["requests"] == len(trace)
    assert m["generated_tokens"] == sum(r.max_new for r in trace)
    assert 0.0 < rep.occupancy <= 1.0


def test_continuous_frees_slots_static_stalls(cfg, params):
    """One long request pins a slot; short requests keep arriving.  The
    continuous engine serves them through the freed slot while the long one
    decodes; the static barrier parks them until the whole batch drains."""
    rng = np.random.default_rng(0)

    def mk(rid, gen, arrival):
        return Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32),
            max_new=gen, arrival=arrival,
        )

    trace = [mk(0, 30, 0.0), mk(1, 4, 0.0), mk(2, 4, 1.0), mk(3, 4, 2.0)]
    eng = ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN, device="cpu")
    cont = eng.run(trace, policy="continuous", clock=VirtualClock()).by_rid()
    stat = eng.run(trace, policy="static", clock=VirtualClock()).by_rid()
    assert stat[2].admitted > stat[1].finished
    assert cont[2].admitted < stat[2].admitted
    assert cont[3].first_token < stat[3].first_token
    assert cont[3].finished < stat[3].finished


# ----------------------------------------------------------------------------
# hot swap
# ----------------------------------------------------------------------------


def _swap_trace(cfg):
    rng = np.random.default_rng(4)

    def mk(rid, gen, arrival):
        return Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab_size, (8,)).astype(np.int32),
            max_new=gen, arrival=arrival,
        )

    # rid 0 finishes before the swap; rid 1 spans it; rid 2 starts after
    return [mk(0, 3, 0.0), mk(1, 24, 0.0), mk(2, 5, 10.0)]


SWAP_TICK = 6


def check_swap(cfg, rep, trace, v0, v1, num_slots):
    """One swap, nothing dropped, requests wholly on one side equal to their
    version's oracles, the spanning request's pre-swap prefix kept."""
    assert len(rep.swaps) == 1 and rep.swaps[0]["round"] == 1
    by = rep.by_rid()
    for req in trace:
        assert len(by[req.rid].tokens) == req.max_new
    assert by[0].version_admitted == 0 and by[0].version_finished == 0
    assert oracles_hold(cfg, v0, by[0], trace[0], num_slots)
    assert by[2].version_admitted == 1 and by[2].version_finished == 1
    assert oracles_hold(cfg, v1, by[2], trace[2], num_slots)
    assert by[1].spans_swap
    v0_tokens = greedy_oracle(cfg, v0, trace[1].prompt, 24, max_len=MAX_LEN)
    assert by[1].tokens[:4] == v0_tokens[:4]


def test_chain_hot_swap_keeps_untouched_slots_oracle_exact(cfg, params, params1):
    trace = _swap_trace(cfg)
    chain = Chain(k_updates_per_round=1)
    chain.append_model(params, 0)

    def commit(tick):
        if tick == SWAP_TICK and chain.current_round == 0:
            chain.append_update(tree_map(torch.zeros_like, params),
                                uploader=0, score=1.0)
            chain.append_model(params1, 1)

    eng = ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN,
                      param_source=ChainParamSource(chain), device="cpu")
    rep = eng.run(trace, policy="continuous", clock=VirtualClock(),
                  on_tick=commit)
    check_swap(cfg, rep, trace, params, params1, 2)
    assert chain.verify()


def test_int8_round_hot_swap(cfg, params):
    """The card's hot swap at this size: at a fixed tick one round commits
    K = 2 deltas as int8 update blocks (top_k_int8) and their fused fedavg
    (fused_int8) as the model block the engine swaps to."""
    trace = _swap_trace(cfg)
    chain = Chain(k_updates_per_round=2, update_codec=Int8UpdateCodec(params))
    chain.append_model(params, 0)
    gen = torch.Generator().manual_seed(3)
    deltas = {u: tree_map(lambda t: torch.randn(t.shape, generator=gen)
                          * (1e-3 * float(t.abs().mean()) + 1e-6), params)
              for u in (4, 11)}
    committed = []

    def commit(tick):
        if tick == SWAP_TICK and not committed:
            committed.append(commit_scored_round(
                chain, params, deltas, {4: 0.9, 11: 0.6}, round_t=0,
                device=CPU))

    reset_launch_counts()
    eng = ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN,
                      param_source=ChainParamSource(chain), device="cpu")
    rep = eng.run(trace, policy="continuous", clock=VirtualClock(),
                  on_tick=commit)
    assert not any(launch_counts().values())     # the CPU ran plain versions
    v1 = committed[0].new_params
    check_swap(cfg, rep, trace, params, v1, 2)
    assert rep.swaps[0]["tick"] == SWAP_TICK
    assert chain.verify() and chain.height == 4
    # read-back: each block within one quantization step of its delta, and
    # the model block = v0 + the plain fused fedavg of the stored blobs
    blobs = chain.update_payloads_at_round(0, decode=False)
    for blk, blob, decoded in zip(chain.updates_at_round(0), blobs,
                                  chain.update_payloads_at_round(0)):
        err = (ravel_pytree(decoded)[0] - ravel_pytree(deltas[blk.uploader])[0])
        assert float(err.abs().max()) <= float(blob["scales"].max())
    w = torch.tensor([0.9, 0.6]) / torch.tensor([0.9, 0.6]).sum()
    agg = fused_agg_ref(torch.stack([b["q"] for b in blobs]),
                        torch.stack([b["scales"] for b in blobs]), w)
    want = ravel_pytree(params)[0] + agg[:blobs[0]["d"]]
    got = ravel_pytree(chain.latest_model()[1])[0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_checkpoint_param_source_roundtrip(cfg, params, params1, tmp_path):
    """Port of tests/test_serve_engine.py::
    test_checkpoint_param_source_roundtrip: an f32 snapshot loads bit for
    bit, the same round is not swapped twice, and an int8 chain blob
    snapshot is decoded through the codec."""
    src = CheckpointParamSource(str(tmp_path), start_round=0, device="cpu")
    assert src.poll() is None

    save_pytree(str(tmp_path / checkpoint_name(1)), params1)
    ver, got = src.poll()
    assert ver == 1
    for a, b in zip(tree_leaves(got), tree_leaves(params1)):
        assert torch.equal(a, b)
    assert src.poll() is None                 # same round: no re-swap

    # int8-codec chain blob snapshot: decoded through the codec
    codec = Int8UpdateCodec(params)
    blob = codec.encode(params1)
    save_pytree(str(tmp_path / checkpoint_name(2)), blob)
    src2 = CheckpointParamSource(str(tmp_path), codec=codec, start_round=1,
                                 device="cpu")
    ver, got = src2.poll()
    assert ver == 2
    for a, b in zip(tree_leaves(got), tree_leaves(codec.decode(blob))):
        assert torch.equal(a, b)
    assert CKPT_RE.match("model_round_12.msgpack")
    assert not CKPT_RE.match("model_round_12.msgpack.tmp")


def test_checkpoint_source_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckpointParamSource(str(tmp_path))


def test_checkpoint_hot_swaps(cfg, params, params1, tmp_path):
    """chip_smoke.py's serve_checkpoint at this size: round 1 (an f32
    snapshot) appears in the watched directory at one tick and round 2 (an
    int8 blob of the same params) at a later one; the engine swaps to
    each in turn, drops nothing, and every request decoded wholly under
    one version equals that version's oracle."""
    trace = _swap_trace(cfg)
    codec = Int8UpdateCodec(params)
    blob = codec.encode(params1)
    v2 = codec.decode(blob)
    ticks = {SWAP_TICK: (1, params1), SWAP_TICK + 4: (2, blob)}

    def write(tick):
        if tick in ticks:
            round_t, tree = ticks[tick]
            save_pytree(str(tmp_path / checkpoint_name(round_t)), tree)

    src = CheckpointParamSource(str(tmp_path), codec=codec, start_round=0,
                                device="cpu")
    eng = ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN,
                      param_source=src, device="cpu")
    rep = eng.run(trace, policy="continuous", clock=VirtualClock(),
                  on_tick=write)
    assert [(s["round"], s["tick"]) for s in rep.swaps] == [
        (1, SWAP_TICK), (2, SWAP_TICK + 4)]
    by = rep.by_rid()
    for req in trace:
        assert len(by[req.rid].tokens) == req.max_new
    versions = {0: params, 1: params1, 2: v2}
    for req in trace:
        res = by[req.rid]
        if not res.spans_swap:
            assert oracles_hold(cfg, versions[res.version_admitted], res, req,
                                2)
    assert by[0].version_finished == 0 and by[2].version_admitted == 2
    assert by[1].spans_swap
    v0_tokens = greedy_oracle(cfg, params, trace[1].prompt, 24,
                              max_len=MAX_LEN)
    assert by[1].tokens[:4] == v0_tokens[:4]
    for a, b in zip(tree_leaves(eng.params), tree_leaves(v2)):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------------
# against the reference engine
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_steps(jcfg):
    mesh = make_host_mesh(1, 1)
    pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(1,),
                         model_axis_size=1, fsdp=False)
    return (jax.jit(j_make_prefill(jcfg, mesh, pol, max_len=MAX_LEN)),
            jax.jit(j_make_decode(jcfg, mesh, pol)))


def ref_margin(ref_steps, jparams, prompt, step):
    """The reference's top-2 logit margin at generated token ``step`` of its
    batch-1 greedy run."""
    prefill, decode = ref_steps
    S = len(prompt)
    logits, cache = prefill(jparams, JBatch(
        tokens=jnp.asarray(prompt, jnp.int32)[None],
        positions=jnp.arange(S, dtype=jnp.int32)[None]))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    pos = jnp.asarray([S], jnp.int32)
    for _ in range(step):
        tok, logits, cache = decode(jparams, tok, pos, cache, None)
        pos = pos + 1
    top2 = np.sort(np.asarray(logits[0, -1]))[-2:]
    return float(top2[1] - top2[0])


def assert_same_service(port_rep, ref_rep, ref_steps, jparams_by_version,
                        trace):
    assert port_rep.ticks == ref_rep.ticks
    assert port_rep.swaps == ref_rep.swaps
    for a, b in zip(port_rep.results, ref_rep.results):
        assert ((a.rid, a.admitted, a.first_token, a.finished,
                 a.version_admitted, a.version_finished)
                == (b.rid, b.admitted, b.first_token, b.finished,
                    b.version_admitted, b.version_finished))
        if a.tokens != b.tokens:
            i = next(i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                     if x != y)
            margin = ref_margin(ref_steps, jparams_by_version[b.version_admitted],
                                trace[b.rid].prompt, i) if not b.spans_swap else None
            pytest.fail(f"request {a.rid}: token {i} is {a.tokens[i]} here and "
                        f"{b.tokens[i]} in the reference, whose top-2 logit "
                        f"margin there is {margin}")
    assert port_rep.metrics()["generated_tokens"] == ref_rep.metrics()["generated_tokens"]


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_matches_reference_engine(cfg, jcfg, params, ref_np, ref_steps,
                                         policy):
    kw = dict(num_requests=10, rate=0.5, prompt_lens=(8, 16), gen_lens=(3, 12),
              vocab_size=cfg.vocab_size, seed=0)
    trace, jtrace = make_poisson_trace(**kw), j_make_poisson_trace(**kw)
    jp = jax.tree.map(jnp.asarray, ref_np[0])
    ref_rep = JServeEngine(jcfg, jp, num_slots=3, max_len=MAX_LEN).run(
        jtrace, policy=policy, clock=JVirtualClock())
    port_rep = ServeEngine(cfg, params, num_slots=3, max_len=MAX_LEN,
                           device="cpu").run(trace, policy=policy,
                                             clock=VirtualClock())
    assert_same_service(port_rep, ref_rep, ref_steps, {0: jp}, jtrace)


def test_hot_swap_matches_reference_engine(cfg, jcfg, params, params1, ref_np,
                                           ref_steps):
    jp0, jp1 = (jax.tree.map(jnp.asarray, p) for p in ref_np)
    trace = _swap_trace(cfg)

    jchain, chain = JChain(k_updates_per_round=1), Chain(k_updates_per_round=1)
    jchain.append_model(jp0, 0)
    chain.append_model(params, 0)

    def commit_ref(tick):
        if tick == SWAP_TICK and jchain.current_round == 0:
            jchain.append_update(jax.tree.map(np.zeros_like, ref_np[0]),
                                 uploader=0, score=1.0)
            jchain.append_model(jp1, 1)

    def commit_port(tick):
        if tick == SWAP_TICK and chain.current_round == 0:
            chain.append_update(tree_map(torch.zeros_like, params),
                                uploader=0, score=1.0)
            chain.append_model(params1, 1)

    ref_rep = JServeEngine(jcfg, jp0, num_slots=2, max_len=MAX_LEN,
                           param_source=JChainParamSource(jchain)).run(
        trace, policy="continuous", clock=JVirtualClock(), on_tick=commit_ref)
    port_rep = ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN,
                           param_source=ChainParamSource(chain),
                           device="cpu").run(
        trace, policy="continuous", clock=VirtualClock(), on_tick=commit_port)
    assert_same_service(port_rep, ref_rep, ref_steps, {0: jp0, 1: jp1}, trace)


# ----------------------------------------------------------------------------
# the serving CLI
# ----------------------------------------------------------------------------


def test_serve_cli_on_cpu(capsys):
    import json

    from repro_torch.launch.serve import main

    main(["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--requests",
          "5", "--prompt-lens", "8", "16", "--gen-lens", "4", "6",
          "--max-len", "24", "--static"])
    out = capsys.readouterr().out
    assert out.startswith("# static serving, gemma3-4b (smoke), slots=4")
    metrics = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert metrics["requests"] == 5 and metrics["generated_tokens"] >= 20
    assert metrics["swaps"] == 0


def test_serve_cli_needs_cuda_unless_told_cpu():
    from repro_torch.launch.serve import main

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke"])


# ----------------------------------------------------------------------------
# recurrent and MoE models behind the engine
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-7b", "qwen3-moe-30b-a3b",
                                  "jamba-1.5-large-398b", "qwen2-vl-7b",
                                  "qwen3-moe-30b-a3b@auto",
                                  "jamba-1.5-large-398b@auto"])
def test_rwkv_and_moe_engines_match_reference(arch):
    """The smoke configs of RWKV-6 (a recurrent decode state), the MoE,
    the jamba hybrid (attention and a Mamba conv / SSM state, MoE) and
    qwen2-vl (M-RoPE: text prompts with (3, 1, S) positions, each tick's
    position on all three streams) behind both engines on one
    VirtualClock trace of two slots, each slot serving several requests
    in turn, and the reference's service tick for tick, token for token.

    The MoE archs run twice.  With ``moe_impl="dense"`` set on both
    packages every request equals its oracles (a finished request's
    state leaks into no later one).  At ``@auto``, both packages'
    default, the engines take the expert-parallel path on their 1 x 1
    meshes, whose capacity dispatch lets one row's routing drop another
    row's assignment: there every request equals the replay oracle
    (``replay_ticks``), and the service the reference's."""
    import dataclasses

    from repro_torch.serve.engine import replay_ticks

    arch, _, impl = arch.partition("@")
    cfg = registry.smoke_config(arch)
    jcfg = jreg.smoke_config(arch)
    if jcfg.num_experts and impl != "auto":
        jcfg = dataclasses.replace(jcfg, moe_impl="dense")
        cfg = cfg.replace(moe_impl="dense")
    ref_np = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3), jcfg))
    jp, params = jax.tree.map(jnp.asarray, ref_np), from_numpy_tree(ref_np)
    kw = dict(num_requests=6, rate=1.0, prompt_lens=(8, 12), gen_lens=(3, 8),
              vocab_size=cfg.vocab_size, seed=4)
    trace, jtrace = make_poisson_trace(**kw), j_make_poisson_trace(**kw)
    engine = ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN,
                         device="cpu")
    record = []
    port_rep = engine.run(trace, policy="continuous", clock=VirtualClock(),
                          record=record)
    slots = [r.slot for r in port_rep.results]
    assert max(slots.count(s) for s in set(slots)) >= 3   # slots are reused
    if impl == "auto":
        replay = replay_ticks(engine, trace, record)
        for res in port_rep.results:
            assert res.tokens == replay[res.rid], (arch, res.rid)
    else:
        for res, req in zip(port_rep.results, trace):
            assert oracles_hold(cfg, params, res, req, 2), (arch, res.rid)
    ref_rep = JServeEngine(jcfg, jp, num_slots=2, max_len=MAX_LEN).run(
        jtrace, policy="continuous", clock=JVirtualClock())
    mesh = make_host_mesh(1, 1)
    pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(1,), model_axis_size=1,
                         fsdp=False)
    steps = (jax.jit(j_make_prefill(jcfg, mesh, pol, max_len=MAX_LEN)),
             jax.jit(j_make_decode(jcfg, mesh, pol)))
    assert_same_service(port_rep, ref_rep, steps, {0: jp}, jtrace)


def test_run_counts_drops_only_when_recording(monkeypatch):
    """A plain ``run`` enters no drop counter, so the expert-parallel MoE
    launches nothing for a count nobody reads; ``run(..., record=)``
    counts a step's drops once per admission and tick, and serves the
    same tokens."""
    from repro_torch.models import init_model
    from repro_torch.serve import engine as serve_engine

    entered = []
    real = serve_engine.count_drops

    def spy():
        entered.append(1)
        return real()

    monkeypatch.setattr(serve_engine, "count_drops", spy)
    cfg = registry.smoke_config("qwen3-moe-30b-a3b")
    params = init_model(torch.Generator().manual_seed(0), cfg)
    trace = make_poisson_trace(num_requests=4, rate=1.0, prompt_lens=(8,),
                               gen_lens=(3,), vocab_size=cfg.vocab_size,
                               seed=1)
    engine = ServeEngine(cfg, params, num_slots=2, max_len=MAX_LEN,
                         device="cpu")
    plain = engine.run(trace, policy="continuous", clock=VirtualClock())
    assert entered == []
    record = []
    counted = engine.run(trace, policy="continuous", clock=VirtualClock(),
                         record=record)
    assert len(entered) == len(record) > 0
    assert ([r.tokens for r in plain.results]
            == [r.tokens for r in counted.results])


@pytest.mark.parametrize("arch", ["rwkv6-7b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b", "qwen2-vl-7b"])
def test_serve_cli_serves_recurrent_and_moe_archs(arch, capsys):
    import json

    from repro_torch.launch.serve import main

    main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
          "--prompt-lens", "8", "16", "--gen-lens", "4", "6", "--max-len",
          "24"])
    out = capsys.readouterr().out
    assert out.startswith(f"# continuous serving, {arch} (smoke), slots=4")
    metrics = json.loads(out[out.index("{"):out.rindex("}") + 1])
    assert metrics["requests"] == 4 and metrics["generated_tokens"] >= 16
