"""The port's sharded round engine (``repro_torch.fl.sharded``) on CPU ranks.

Each world is spawned once for the module by
``repro_torch.hostdevices.spawn_world`` (gloo, a FileStore in a temporary
directory): world 1, world 2 and world 4 start together, and each rank
runs every config of its world through ``build_runtime(..., mesh=
make_round_mesh(device="cpu"))`` and returns numpy summaries.  Meanwhile
this process runs the reference on the forced host devices of
``tests/conftest.py``.  The rank function lives in this module, which
imports neither ``jax`` nor ``repro`` at its top: the reference runs only
inside ``_reference_runs``.

Configs are the reference's (``tests/test_sharded_round.py``: 24
clients, width 8, its ``CFG`` with P = 8 trainers, and
active_proportion 1/3 for P = 5; the tiered run takes
``tests/test_hier_round.py``'s config), 2 rounds each, from the
reference's init through ``initial_params=``.

* World 2 against the reference's own 2-device mesh (f32, int8,
  ``committee_int8_sharded``, P = 5, the baseline, ``tiers=2``,
  ``schedule="async"``): RoundLogs, committees, packed uploader ids and
  scores, malicious sets, round-0 committees and sampled trainers equal;
  blobs ``padded_dim_sharded(d, 2)`` lanes wide; params and f32 blocks
  within atol 1e-5 (on a tiered int8 chain, plus one quantization step a
  lane, as ``tests/test_torch_hier_round.py`` holds them), blob scales
  within rtol 1e-5 and q within +-1 (``tests/test_torch_round.py``'s
  tolerances), and the scales also within atol 1e-9.  That atol is the
  training's: this config's 3 momentum steps leave the two packages'
  updates up to 3e-8 apart (convolution sum order), so a tile of tiny
  updates (scale 1.6e-6) has its scale 2e-10 = 1.3e-5 relative apart;
  the port's single-device round shows the same against the reference's.
* World 4 at P = 5 (three padded rows a cohort) against the port's world
  1 and the reference's 1-device run, at the same tolerances; the wider
  blobs' extra lanes must be q = 0, scale 1.0.
* Every world: each rank's chain bit for bit equal to rank 0's (block
  hashes and payload bytes), async bit for bit equal to sequential, the
  sharded stages wired, the programs' local outputs split as
  ``round_engine_pspecs`` / ``score_matrix_pspecs`` name (and gathered,
  bit for bit the single-device programs' outputs), and an oversized
  ``make_round_mesh`` refused.
"""
import concurrent.futures
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.hostdevices import spawn_world
from repro_torch.kernels.ops import padded_dim, padded_dim_sharded
from repro_torch.kernels.tiling import BLOCK_D
from repro_torch.launch.shardings import round_engine_pspecs, score_matrix_pspecs

DATA = dict(num_clients=24, mean_samples=40, test_size=200, seed=3)
CFG = dict(active_proportion=0.5, committee_fraction=0.3, k_updates=4,
           local_steps=3, local_batch=8, malicious_fraction=0.25,
           attack_sigma=1.5, seed=0)
CFG5 = dict(CFG, active_proportion=1 / 3)        # 8 active, Q = 3: P = 5
HCFG = dict(active_proportion=1.0, committee_fraction=0.25, k_updates=4,
            local_steps=3, local_batch=8, malicious_fraction=0.25,
            attack_sigma=1.5, seed=0)
BASE = dict(active_proportion=0.4, local_steps=3, local_batch=8,
            aggregation="cwmed", malicious_fraction=0.25, seed=0)
INT8 = dict(quantize_chain=True, use_kernels=True)
ROUNDS = 2
# run -> (config, validator, build_runtime keywords)
RUNS = {
    "f32": (CFG, None, {}),
    "int8": ({**CFG, **INT8}, None, {}),
    "int8_committee": ({**CFG, **INT8}, "committee_int8_sharded", {}),
    "int8_committee_nocache": ({**CFG, **INT8}, "committee_int8_sharded", {}),
    "int8_p5": ({**CFG5, **INT8}, None, {}),
    "f32_p5": (CFG5, None, {}),
    "async_p5": ({**CFG5, **INT8}, None, {"schedule": "async"}),
    "baseline": (BASE, None, {"baseline": True}),
    "tiered": ({**HCFG, **INT8}, None, {"tiers": 2}),
    "async": ({**CFG, **INT8}, None, {"schedule": "async"}),
}
WORLDS = {
    1: ("f32_p5", "int8_p5", "async_p5"),
    2: ("f32", "int8", "int8_committee", "int8_committee_nocache", "int8_p5",
        "baseline", "tiered", "async"),
    4: ("f32_p5", "int8_p5", "async_p5"),
}
# async run -> its sequential twin in the same world
ASYNC_TWINS = {"async": "int8", "async_p5": "int8_p5"}
# runs held against the reference, by device count (the 1-device
# reference for world 4)
AGAINST_REF = {2: [r for r in WORLDS[2] if r != "int8_committee_nocache"],
               4: ["f32_p5", "int8_p5", "async_p5"]}
SPLIT_P = 5          # rows the programs' split checks run on


# ----------------------------------------------------------------------
# summaries (numpy), shared by the ranks and the reference side
# ----------------------------------------------------------------------
def _np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flat_payload(tree, prefix=""):
    """Nested dict payload -> {key path: numpy array}, sorted keys."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_payload(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: _np(tree)}


def _block_digest(block, payload) -> str:
    h = hashlib.sha256(block.hash.encode())
    for path, a in _flat_payload(payload).items():
        h.update(f"{path}|{a.dtype}|{a.shape}".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _recording(sampler, seen):
    def sample(ctx):
        sampler(ctx)
        seen.append(list(ctx.trainers))
    return sample


def _summary(rt, seen, full: bool) -> dict:
    """What a run is held to.  ``full``: with every payload (rank 0 and
    the reference); other ranks send digests only."""
    out = {"malicious": sorted(int(i) for i, n in rt.manager.nodes.items()
                               if n.is_malicious),
           "trainers": seen,
           "logs": [dataclasses.asdict(l) for l in rt.logs],
           "hier_logs": rt.hier_logs,
           "verify": rt.chain.verify(),
           "meta": [(b.kind, b.round, b.uploader, b.score, b.encoded)
                    for b in rt.chain.blocks],
           "digest": [_block_digest(b, rt.chain.raw_payload(b))
                      for b in rt.chain.blocks]}
    if full:
        out["payloads"] = [_flat_payload(rt.chain.raw_payload(b))
                           for b in rt.chain.blocks]
        out["tokens"] = {int(i): float(n.tokens)
                         for i, n in rt.manager.nodes.items()}
    return out


def _baseline_summary(rt) -> dict:
    return {"malicious": sorted(int(i) for i in rt.malicious),
            "accuracies": [float(a) for a in rt.accuracies],
            "params": _flat_payload(rt.params)}


# ----------------------------------------------------------------------
# the ranks (spawned; this module imports no jax)
# ----------------------------------------------------------------------
def _no_cache_packer(ctx):
    """top_k_int8_sharded with the row-quant cache dropped: the packer
    quantizes the packed stack itself."""
    from repro_torch.fl.pipeline import resolve

    ctx.row_quant.clear()
    resolve("packer", "top_k_int8_sharded")(ctx)


def _stage_names(rt) -> dict:
    from repro_torch.fl.pipeline import REGISTRIES

    def name(kind, stage):
        return next((n for n, s in REGISTRIES[kind].items() if s is stage),
                    None)

    names = {kind: name(kind, getattr(rt.pipeline, kind))
             for kind in REGISTRIES}
    inner = getattr(rt, "_hier_inner", None)
    if inner is not None:
        names["inner_validator"] = name("validator", inner)
    return names


def _run_port(ds, init, run: str, mesh, rank: int) -> dict:
    from repro_torch.api import build_runtime
    from repro_torch.convert import from_numpy_tree
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.pipeline import sample_active

    cfg, validator, kw = RUNS[run]
    kw = dict(kw)
    stages, seen = {}, []
    if validator:
        stages["validator"] = validator
    if run.endswith("nocache"):
        stages["packer"] = _no_cache_packer
    flat_bflc = not kw.get("baseline") and "tiers" not in kw
    if flat_bflc:
        stages["sampler"] = _recording(sample_active, seen)
    rt = build_runtime(femnist_adapter(8), ds, dict(cfg),
                       initial_params=from_numpy_tree(init), stages=stages,
                       mesh=mesh, device="cpu", **kw)
    if kw.get("baseline"):
        names = _stage_names(rt)
        rt.run(ROUNDS, eval_every=ROUNDS)
        return {**_baseline_summary(rt), "stages": names}
    names = _stage_names(rt)
    committee0 = list(rt.committee)
    committees = []
    for _ in range(ROUNDS):
        rt.run_round()
        committees.append(list(rt.committee))
    return {**_summary(rt, seen, full=rank == 0), "committee0": committee0,
            "committees": committees, "stages": names}


def _split_checks(mesh, init) -> dict:
    """Each sharded program on this rank's block: the local shapes, and
    whether the gathered blocks equal the single-device program's output
    bit for bit."""
    import torch.nn.functional as F

    from repro_torch.convert import from_numpy_tree
    from repro_torch.core.aggregation import flatten_updates, normalize_weights
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.client import (
        make_local_train_fn, make_score_from_int8_fn, make_score_matrix_fn,
        make_sharded_local_train_fn, make_sharded_score_from_int8_fn,
        make_sharded_score_matrix_fn,
    )
    from repro_torch.fl.sharded import _pad_clients
    from repro_torch.kernels.ops import (
        Int8UpdateCodec, aggregate_quantized, make_aggregate_quantized_sharded,
        make_quantize_stack_sharded, quantize_stack,
    )
    from repro_torch.tree import tree_leaves, tree_map, tree_unstack

    eng, sm = round_engine_pspecs(), score_matrix_pspecs()
    adapter = femnist_adapter(8)
    params = from_numpy_tree(init)
    rng = np.random.default_rng(7)
    xs = rng.normal(size=(SPLIT_P, 2, 8, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 62, (SPLIT_P, 2, 8))
    vx = torch.from_numpy(rng.normal(size=(3, 16, 28, 28, 1)).astype(np.float32))
    vy = torch.from_numpy(rng.integers(0, 62, (3, 16)))
    xs_p, ys_p, _ = _pad_clients(xs, ys, mesh.size)

    def equal(a, b):
        return a.shape == b.shape and torch.equal(a, b)

    block = make_sharded_local_train_fn(adapter, 0.05, mesh, 0.9)(
        params, xs_p, ys_p)
    single = make_local_train_fn(adapter, 0.05, 0.9)(
        params, torch.from_numpy(xs), torch.from_numpy(ys))
    gathered = tree_map(lambda x: mesh.gather(x, eng["clients"])[:SPLIT_P],
                        block)
    out = {"train_rows": sorted({l.shape[eng["clients"]]
                                 for l in tree_leaves(block)}),
           "train_equal": all(equal(a, b) for a, b in zip(
               tree_leaves(gathered), tree_leaves(single)))}

    scores = make_sharded_score_matrix_fn(adapter)(params, block, vx, vy)
    want = make_score_matrix_fn(adapter)(params, single, vx, vy)
    out["score_shape"] = tuple(scores.shape)
    out["score_equal"] = equal(mesh.gather(scores, sm["scores"])[:SPLIT_P],
                               want)

    codec = Int8UpdateCodec(params)
    s8, q8, sc8 = make_sharded_score_from_int8_fn(adapter, codec.unravel)(
        params, block, vx, vy)
    stack, _ = flatten_updates(tree_unstack(single, SPLIT_P))
    w8, wq, ws = make_score_from_int8_fn(adapter, codec.unravel)(
        params, stack, vx, vy)
    out["int8_shapes"] = [tuple(t.shape) for t in (s8, q8, sc8)]
    out["int8_equal"] = all(
        equal(mesh.gather(g, dim)[:SPLIT_P], w) for g, dim, w in (
            (s8, sm["scores"], w8), (q8, sm["int8_rows"], wq),
            (sc8, sm["int8_rows"], ws)))

    d = stack.shape[1]
    dpad = padded_dim_sharded(d, mesh.size)
    q, s = make_quantize_stack_sharded(mesh)(stack)
    wq, ws, _ = quantize_stack(F.pad(stack, (0, dpad - d)))
    qg, sg = mesh.gather(q, eng["dshard"]), mesh.gather(s, eng["dshard"])
    out["quantize_shapes"] = [tuple(q.shape), tuple(s.shape)]
    out["quantize_equal"] = equal(qg, wq) and equal(sg, ws)
    out["d"] = d
    scores = [0.9, 0.5, 0.7, 0.2, 0.6]
    w = normalize_weights(SPLIT_P, scores)
    out["agg_shape"] = {}
    out["agg_equal"] = {}
    for method in ("fedavg", "cwmed", "trimmed_mean"):
        agg = make_aggregate_quantized_sharded(mesh, method, 1)(qg, sg, w)
        want = aggregate_quantized(qg, sg, dpad, method=method,
                                   weights=scores)
        out["agg_shape"][method] = tuple(agg.shape)
        out["agg_equal"][method] = equal(mesh.gather(agg, eng["dvec"]), want)
    return out


def _refuses_oversized(mesh) -> bool:
    from repro_torch.launch.mesh import make_round_mesh

    try:
        make_round_mesh(mesh.size + 1, device="cpu")
    except ValueError:
        return True
    return False


def run_world(runs, init) -> dict:
    """One rank: every run of its world, the split checks, the refusal."""
    torch.set_num_threads(1)
    from repro_torch.data import make_femnist_like
    from repro_torch.launch.mesh import make_round_mesh

    mesh = make_round_mesh(device="cpu")
    ds = make_femnist_like(**DATA)
    return {"rank": mesh.rank, "size": mesh.size,
            "runs": {r: _run_port(ds, init, r, mesh, mesh.rank) for r in runs},
            "split": _split_checks(mesh, init),
            "oversized_refused": _refuses_oversized(mesh)}


# ----------------------------------------------------------------------
# the reference (this process only)
# ----------------------------------------------------------------------
def _reference_runs(init, runs, ndev: int) -> dict:
    from repro.api import build_runtime
    from repro.data import make_femnist_like
    from repro.fl import femnist_adapter
    from repro.fl.pipeline import sample_active
    from repro.launch.mesh import make_round_mesh

    ds = make_femnist_like(**DATA)
    mesh = make_round_mesh(ndev) if ndev > 1 else None
    out = {}
    for run in runs:
        cfg, validator, kw = RUNS[run]
        kw = dict(kw)
        stages, seen = {}, []
        if validator:
            stages["validator"] = validator if mesh is not None else \
                validator.replace("_sharded", "")
        flat_bflc = not kw.get("baseline") and "tiers" not in kw
        if flat_bflc:
            stages["sampler"] = _recording(sample_active, seen)
        rt = build_runtime(femnist_adapter(8), ds, dict(cfg),
                           initial_params=init, stages=stages, mesh=mesh, **kw)
        if kw.get("baseline"):
            rt.run(ROUNDS, eval_every=ROUNDS)
            out[run] = _baseline_summary(rt)
            continue
        committee0 = list(rt.committee)
        committees = []
        for _ in range(ROUNDS):
            rt.run_round()
            committees.append(list(rt.committee))
        out[run] = {**_summary(rt, seen, full=True), "committee0": committee0,
                    "committees": committees}
    return out


@pytest.fixture(scope="module")
def worlds():
    """{"port": {world: [rank results]}, "ref": {world: {run: summary}}}:
    the three worlds spawned at once, the reference run meanwhile."""
    import jax

    from repro.fl import femnist_adapter

    init = jax.tree.map(np.asarray, femnist_adapter(8).init(
        jax.random.PRNGKey(CFG["seed"])))
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {n: pool.submit(spawn_world, n, run_world, runs, init,
                                  timeout=240.0)
                   for n, runs in WORLDS.items()}
        ref = {2: _reference_runs(init, AGAINST_REF[2], 2),
               4: _reference_runs(init, AGAINST_REF[4], 1)}
        port = {n: f.result() for n, f in futures.items()}
    return {"port": port, "ref": ref}


# ----------------------------------------------------------------------
# comparisons
# ----------------------------------------------------------------------
def _lane_steps(payloads, meta, t, d):
    """Per-lane quantization step of round t's int8 update blocks."""
    scales = [p["/scales"] for p, m in zip(payloads, meta)
              if m[0] == "update" and m[1] == t]
    return np.repeat(np.max(scales, axis=0), BLOCK_D)[:d]


def _assert_chains_close(got, want, width, tiered=False):
    """``got`` (the port) against ``want`` at the module's tolerances;
    ``width`` is the lanes the port's blobs must have."""
    assert got["meta"] == want["meta"]
    assert got["verify"] and want["verify"]
    for meta, g, w in zip(got["meta"], got["payloads"], want["payloads"]):
        kind, t, _, _, encoded = meta
        assert sorted(g) == sorted(w)
        if kind == "committee":
            for key in g:
                np.testing.assert_array_equal(g[key], w[key])
        elif kind == "update" and encoded:
            d = int(g["/d"])
            assert d == int(w["/d"])
            assert g["/q"].shape == (width,)
            n = w["/q"].shape[0]
            dq = g["/q"][:n].astype(np.int32) - w["/q"].astype(np.int32)
            assert np.abs(dq).max() <= 1
            assert not g["/q"][n:].any()
            np.testing.assert_allclose(g["/scales"][:n // BLOCK_D],
                                       w["/scales"], rtol=1e-5, atol=1e-9)
            assert np.all(g["/scales"][n // BLOCK_D:] == 1.0)
        else:
            slack = 0.0
            if kind == "model" and tiered and t > 0:
                d = sum(a.size for a in g.values())
                slack = _lane_steps(got["payloads"], got["meta"], t - 1, d)
            gf = np.concatenate([g[k].ravel() for k in sorted(g)])
            wf = np.concatenate([w[k].ravel() for k in sorted(w)])
            assert np.all(np.abs(gf - wf) <= 1e-5 + slack)


def _assert_bflc_equal(got, want):
    for key in ("malicious", "committee0", "committees", "trainers", "logs",
                "hier_logs"):
        assert got[key] == want[key], key


# ----------------------------------------------------------------------
# world 2 against the reference's 2-device mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("run", [r for r in AGAINST_REF[2] if r != "baseline"])
def test_world2_logs_committees_and_rng_equal_reference(worlds, run):
    _assert_bflc_equal(worlds["port"][2][0]["runs"][run],
                       worlds["ref"][2][run])


@pytest.mark.parametrize("run", [r for r in AGAINST_REF[2] if r != "baseline"])
def test_world2_blocks_and_params_close_to_reference(worlds, run):
    got = worlds["port"][2][0]["runs"][run]
    d = worlds["port"][2][0]["split"]["d"]
    tiered = "tiers" in RUNS[run][2]
    # a tiered round stores the sub-aggregates' blobs, quantized whole
    width = padded_dim(d) if tiered else padded_dim_sharded(d, 2)
    _assert_chains_close(got, worlds["ref"][2][run], width, tiered=tiered)
    for g, w in zip(got["tokens"].values(), worlds["ref"][2][run]["tokens"].values()):
        assert g == pytest.approx(w, abs=1e-12)


@pytest.mark.parametrize("run", ["int8", "int8_committee", "int8_p5",
                                 "async"])
def test_world2_blobs_are_shard_padded(worlds, run):
    got = worlds["port"][2][0]["runs"][run]
    blobs = [p for p, m in zip(got["payloads"], got["meta"])
             if m[0] == "update"]
    assert blobs
    for b in blobs:
        d = int(b["/d"])
        assert b["/q"].shape == (padded_dim_sharded(d, 2),)
        assert b["/scales"].shape == (padded_dim_sharded(d, 2) // BLOCK_D,)


def test_world2_baseline_equals_reference(worlds):
    got, want = worlds["port"][2][0]["runs"]["baseline"], \
        worlds["ref"][2]["baseline"]
    assert got["malicious"] == want["malicious"]
    np.testing.assert_allclose(got["accuracies"], want["accuracies"],
                               atol=1e-6)
    for key in want["params"]:
        np.testing.assert_allclose(got["params"][key], want["params"][key],
                                   atol=1e-5)


def test_row_quant_cache_changes_no_chain_bit(worlds):
    """Packing the int8 validator's cached rows (widened to the shard
    boundary) equals quantizing the packed stack D-slice by D-slice."""
    runs = worlds["port"][2][0]["runs"]
    assert runs["int8_committee"]["digest"] == \
        runs["int8_committee_nocache"]["digest"]
    assert runs["int8_committee"]["logs"] == runs["int8_committee_nocache"]["logs"]


# ----------------------------------------------------------------------
# world 4 (P = 5, padded) against world 1 and the 1-device reference
# ----------------------------------------------------------------------
@pytest.mark.parametrize("run", AGAINST_REF[4])
@pytest.mark.parametrize("other", ("port_world1", "reference_1device"))
def test_world4_padded_cohorts_agree(worlds, run, other):
    got = worlds["port"][4][0]["runs"][run]
    want = (worlds["port"][1][0]["runs"][run] if other == "port_world1"
            else worlds["ref"][4][run])
    assert len(got["trainers"][0]) % 4 != 0
    _assert_bflc_equal(got, want)
    d = worlds["port"][4][0]["split"]["d"]
    _assert_chains_close(got, want, padded_dim_sharded(d, 4))


def test_world4_blobs_are_wider_than_one_device(worlds):
    d = worlds["port"][4][0]["split"]["d"]
    assert padded_dim_sharded(d, 4) > padded_dim(d)


# ----------------------------------------------------------------------
# every world
# ----------------------------------------------------------------------
@pytest.mark.parametrize("world", (2, 4))
def test_every_rank_chain_equals_rank0(worlds, world):
    ranks = worlds["port"][world]
    assert [r["rank"] for r in ranks] == list(range(world))
    for r in ranks[1:]:
        for run, res in r["runs"].items():
            want = ranks[0]["runs"][run]
            if "digest" in res:
                assert res["digest"] == want["digest"], run
                assert res["logs"] == want["logs"], run
            else:
                assert res["accuracies"] == want["accuracies"], run


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_async_equals_sequential_bit_for_bit(worlds, world):
    runs = worlds["port"][world][0]["runs"]
    pairs = [(a, s) for a, s in ASYNC_TWINS.items() if a in runs]
    assert pairs
    for a, s in pairs:
        assert runs[a]["digest"] == runs[s]["digest"]
        assert runs[a]["logs"] == runs[s]["logs"]
        assert runs[a]["committees"] == runs[s]["committees"]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_chains_verify(worlds, world):
    for r in worlds["port"][world]:
        for run, res in r["runs"].items():
            assert res.get("verify", True), run


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_stages_ran(worlds, world):
    want_flat = {"local_trainer": "local_sgd_sharded",
                 "validator": "committee_sharded", "packer": "top_k",
                 "aggregator": "pytree"}
    want_int8 = dict(want_flat, packer="top_k_int8_sharded",
                     aggregator="fused_int8_sharded")
    for run, res in worlds["port"][world][0]["runs"].items():
        cfg, validator, kw = RUNS[run]
        names = res["stages"]
        if kw.get("baseline"):
            assert names["local_trainer"] == "local_sgd_sharded"
            continue
        want = dict(want_int8 if cfg.get("quantize_chain") else want_flat)
        if run.endswith("nocache"):
            want.pop("packer")
            assert names["packer"] is None
        if validator:
            want["validator"] = validator
        if "tiers" in kw:
            want.update(validator="hier", packer="hier",
                        inner_validator="committee_sharded")
        assert {k: names[k] for k in want} == want, run


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_local_outputs_have_the_named_split(worlds, world):
    rows = (SPLIT_P + (-SPLIT_P) % world) // world
    for r in worlds["port"][world]:
        sp = r["split"]
        d = sp["d"]
        dpad = padded_dim_sharded(d, world)
        assert sp["train_rows"] == [rows] and sp["train_equal"]
        assert sp["score_shape"] == (rows, 3) and sp["score_equal"]
        assert sp["int8_shapes"] == [(rows, 3), (rows, padded_dim(d)),
                                     (rows, padded_dim(d) // BLOCK_D)]
        assert sp["int8_equal"]
        assert sp["quantize_shapes"] == [(SPLIT_P, dpad // world),
                                         (SPLIT_P, dpad // BLOCK_D // world)]
        assert sp["quantize_equal"]
        for method in ("fedavg", "cwmed", "trimmed_mean"):
            assert sp["agg_shape"][method] == (dpad // world,)
            assert sp["agg_equal"][method], method


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_round_mesh_rejects_oversized_request(worlds, world):
    assert all(r["oversized_refused"] for r in worlds["port"][world])


def test_round_mesh_needs_a_process_group():
    from repro_torch.launch.mesh import make_round_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_round_mesh(1, device="cpu")
