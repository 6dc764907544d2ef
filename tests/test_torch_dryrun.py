"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's.

* ``shape_applicable``'s skips equal the reference's for every arch x
  shape of the registry.
* Matmul FLOPs a device: olmo-1b's smoke config in bfloat16 with remat,
  on a (2, 4) mesh at batch 8 x 64 tokens, standard train, prefill and
  decode.  The port traces its sharded steps on fake tensors over a fake
  world of 8 ranks (``trace_step``); the reference compiles the same
  steps with the same policy on the suite's 8 CPU devices and counts
  them with ``hlo_compute_stats``.
  - prefill: equal.
  - train: equal but for one named term, token_ce's one-hot product in
    the backward: XLA writes the cotangent of ``one_hot . z`` as a
    broadcast multiply, the port's einsum backward is a (rows, 1) x
    (1, V) product of 2 * (B * S / data) * V FLOPs (V whole).
  - decode: equal.  The decode state is sharded as the reference's
    ``in_shardings`` lay it out (the cache by ``cache_pspecs``, tokens and
    positions by ``decode_pspecs``), so each rank attends over its rows
    and KV heads only; the same step on one device (a ``LocalMesh``)
    counts more.
* Argument bytes a device of the decode step at (2, 4), batch 8 x 64
  slots: olmo-1b (KV heads over model) and gemma3-4b (2 KV heads, so the
  sequence over model) against the reference's compiled
  ``memory_analysis().argument_size_in_bytes``: equal but for a named
  padding term.  XLA pads every block of an uneven split to the largest,
  torch gives the first ranks the extra rows, so rank 0's block (the one
  the dry run counts) is XLA's size and the term is 0; these arguments
  split evenly besides (``jit`` refuses an argument sharding that does
  not divide its dimension).
* The vocabulary on the mesh (olmo-1b and gemma3-4b smoke, bf16, remat,
  (2, 4)): a decode of one row does the reference's matmul FLOPs a
  device (the MLP's ``down`` keeps D split over data); the decode's
  all-gather bytes a device are within twice the reference's at batch 1
  and no more than the reference's at batch 8, and none of its
  collectives is as large as the embedding table; the lookup's forward
  and backward (FSDP on and off, batch 1 and 8) make no collective as
  large as the table.
* ``dryrun_one`` on the 16 x 16 fake mesh (the smoke config and a small
  shape in place of the production ones): a record with the reference's
  keys, no ``error``, the roofline of rank 0's counts on H100 constants,
  and a skipped pair recorded as skipped.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import registry as jax_registry
from repro.launch import hlo_stats as jax_hlo_stats
from repro.launch import mesh as jax_mesh
from repro.launch import shardings as jax_shardings
from repro.launch import steps as jax_steps
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models.transformer import Batch as JaxBatch
from repro.optim import adamw as jax_adamw
from repro.optim import linear_warmup_cosine as jax_schedule
from repro_torch.configs import registry
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.mesh import LocalMesh, make_host_mesh
from repro_torch.launch.shardings import ShardingPolicy
from repro_torch.launch.steps import one_device_policy

ARCH, B, S, DATA, MODEL = "olmo-1b", 8, 64, 2, 4


def _reference_dryrun_module():
    """``repro.launch.dryrun`` imported with this process's XLA_FLAGS kept
    (the module prepends 512 host devices for a process of its own)."""
    jax.devices()                   # the backend exists before the import
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return ref


def test_shape_applicable_matches_reference():
    ref = _reference_dryrun_module()
    assert list(dryrun.SHAPES) == list(ref.SHAPES)
    assert dryrun.SHAPES == ref.SHAPES
    assert registry.ARCH_IDS == jax_registry.ARCH_IDS
    skipped = 0
    for arch in registry.ARCH_IDS:
        cfg, jcfg = registry.get_config(arch), jax_registry.get_config(arch)
        for shape in dryrun.SHAPES:
            got = dryrun.shape_applicable(cfg, shape)
            assert got == ref.shape_applicable(jcfg, shape), (arch, shape)
            skipped += got is not None
    assert skipped > 0


def _sds(shape, dtype):
    return jax.ShapeDtypeStruct(shape, dtype)


def _reference_flops() -> dict:
    """hlo_compute_stats of the reference's three steps on a (2, 4) mesh."""
    cfg = dataclasses.replace(jax_registry.smoke_config(ARCH),
                              dtype="bfloat16", remat=True)
    mesh = jax_mesh.make_host_mesh(DATA, MODEL)
    pol = jax_shardings.ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                                       model_axis_size=MODEL)
    params = jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0), cfg))
    pspecs = jax_shardings.param_pspecs(cfg, params, pol)
    psh = jax_shardings.named(mesh, pspecs)
    rows = (B, S)
    batch = JaxBatch(tokens=_sds(rows, jnp.int32),
                     positions=_sds(rows, jnp.int32),
                     targets=_sds(rows, jnp.int32),
                     loss_mask=_sds(rows, jnp.float32))
    bsh = jax_shardings.named(mesh, jax_shardings.batch_pspecs(
        cfg, pol, batch_sharded=True))
    whole = NamedSharding(mesh, P())
    opt = jax_adamw(jax_schedule(3e-4, 100, 10_000), weight_decay=0.1)
    state = jax_steps.TrainState(params=params,
                                 opt_state=jax.eval_shape(opt.init, params),
                                 step=_sds((), jnp.int32))
    ssh = jax_steps.TrainState(
        params=psh,
        opt_state=jax_shardings.named(mesh, {"m": pspecs, "v": pspecs}),
        step=whole)
    train = jax.jit(jax_steps.make_train_step(cfg, opt, mesh, pol,
                                              mode="standard"),
                    in_shardings=(ssh, bsh, None),
                    out_shardings=(ssh, whole)).lower(state, batch, None)
    prefill = jax.jit(jax_steps.make_prefill_step(cfg, mesh, pol, max_len=S),
                      in_shardings=(psh, bsh)).lower(params, batch)
    out = {kind: jax_hlo_stats.hlo_compute_stats(
               lowered.compile().as_text())["dot_flops"]
           for kind, lowered in (("train", train), ("prefill", prefill))}
    out["decode"] = _reference_decode(ARCH, S)["flops"]
    return out


def _reference_decode(arch: str, seq: int, rows: int = B) -> dict:
    """The reference dry run's decode step at (2, 4), batch ``rows`` (the
    batch over data when more than one): its ``in_shardings`` /
    ``out_shardings``, compiled; matmul FLOPs, argument bytes and
    all-gather bytes a device."""
    cfg = dataclasses.replace(jax_registry.smoke_config(arch),
                              dtype="bfloat16", remat=True)
    mesh = jax_mesh.make_host_mesh(DATA, MODEL)
    pol = jax_shardings.ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                                       model_axis_size=MODEL)
    params = jax.eval_shape(lambda: jax_init_model(jax.random.PRNGKey(0), cfg))
    psh = jax_shardings.named(mesh, jax_shardings.param_pspecs(cfg, params,
                                                               pol))
    bs = rows > 1
    dp = "data" if bs else None
    cache = jax.eval_shape(lambda: jax_init_cache(cfg, rows, seq,
                                                  jnp.bfloat16))
    csh = jax_shardings.named(mesh, jax_shardings.cache_pspecs(
        cfg, cache, pol, batch_sharded=bs))
    tok = NamedSharding(mesh, P(dp, None))
    compiled = jax.jit(
        jax_steps.make_decode_step(cfg, mesh, pol, batch_sharded=bs),
        in_shardings=(psh, tok, NamedSharding(mesh, P(dp)), csh, None),
        out_shardings=(tok, NamedSharding(mesh, P(dp, None, "model")),
                       csh),
    ).lower(params, _sds((rows, 1), jnp.int32), _sds((rows,), jnp.int32),
            cache, None).compile()
    text = compiled.as_text()
    return {"flops": jax_hlo_stats.hlo_compute_stats(text)["dot_flops"],
            "args": compiled.memory_analysis().argument_size_in_bytes,
            "all_gather": jax_hlo_stats.collective_stats(
                text).bytes_by_kind.get("all-gather", 0)}


@pytest.fixture(scope="module")
def flops():
    cfg = registry.smoke_config(ARCH).replace(dtype="bfloat16", remat=True)
    pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                         model_axis_size=MODEL)
    port = {}
    with dryrun.fake_world(DATA * MODEL):
        mesh = make_host_mesh(DATA, MODEL, device="cpu")
        for kind in ("train", "prefill", "decode"):
            traced = dryrun.trace_step(cfg, mesh, pol, kind=kind, seq=S,
                                       batch=B, mode="standard")
            port[kind] = hlo_stats.compute_stats(traced["record"])["dot_flops"]
    one_device = dryrun.trace_step(cfg, LocalMesh(), one_device_policy(),
                                   kind="decode", seq=S, batch=B)
    return {"cfg": cfg, "port": port, "reference": _reference_flops(),
            "one_device": hlo_stats.compute_stats(
                one_device["record"])["dot_flops"]}


def test_prefill_flops_match_reference(flops):
    assert flops["port"]["prefill"] == flops["reference"]["prefill"]


def test_train_flops_match_reference_but_the_one_hot_backward(flops):
    cfg = flops["cfg"]
    one_hot_backward = 2 * (B * S // DATA) * cfg.vocab_size
    assert flops["port"]["train"] == \
        flops["reference"]["train"] + one_hot_backward


def test_decode_flops_between_reference_and_one_device(flops):
    ref, port, one = (flops["reference"]["decode"], flops["port"]["decode"],
                      flops["one_device"])
    # the sharded decode state: the reference's count exactly
    assert port == ref
    assert port < one


# rank 0's block of an uneven split is the largest, the size XLA pads
# every block to: no bytes between the two counts
XLA_PADDING = 0


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma3-4b"])
def test_decode_argument_bytes_match_reference(arch):
    seq = S
    cfg = registry.smoke_config(arch).replace(dtype="bfloat16", remat=True)
    pol = ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                         model_axis_size=MODEL)
    with dryrun.fake_world(DATA * MODEL):
        mesh = make_host_mesh(DATA, MODEL, device="cpu")
        traced = dryrun.trace_step(cfg, mesh, pol, kind="decode", seq=seq,
                                   batch=B)
        _, _, cache, _ = dryrun.make_inputs(cfg, "decode", seq, B, mesh, pol)
        # gemma3's unit: a local-window layer, then the global one
        local = cache["units"][-1]["k"].to_local().shape
    ref = _reference_decode(arch, seq)
    assert traced["argument_size"] + XLA_PADDING == ref["args"]
    # the cache is each rank's share: rows over data, and KV heads (olmo)
    # or the sequence (gemma3) over model
    if arch == "olmo-1b":
        assert tuple(local) == (cfg.num_units, B // DATA, seq,
                                cfg.num_kv_heads // MODEL,
                                cfg.resolved_head_dim)
    else:
        assert tuple(local) == (cfg.num_units, B // DATA, seq // MODEL,
                                cfg.num_kv_heads, cfg.resolved_head_dim)


def test_dryrun_one_record(monkeypatch, tmp_path):
    small = {"train_4k": dict(kind="train", seq=64, batch=16),
             "decode_32k": dict(kind="decode", seq=64, batch=16)}
    monkeypatch.setattr(dryrun, "SHAPES", small)
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(dryrun.registry, "get_config",
                        lambda arch, **kw: registry.smoke_config(arch)
                        .replace(**kw))
    ref = _reference_dryrun_module()
    rec = dryrun.dryrun_one(ARCH, "train_4k", mode="standard", verbose=False)
    assert "error" not in rec, rec.get("traceback")
    keys = {"arch", "shape", "mesh", "mode", "tag", "chips", "compile_s",
            "flops_per_device", "flops_cost_analysis", "bytes_per_device",
            "dot_bytes_per_device", "collective_bytes_per_device",
            "collective_breakdown", "collective_counts",
            "peak_memory_per_device", "argument_size", "output_size",
            "roofline", "params", "active_params"}
    assert set(rec) == keys
    assert (rec["mesh"], rec["chips"], rec["flops_cost_analysis"]) == \
        ("16x16", 256, None)
    assert rec["flops_per_device"] > 0 and rec["peak_memory_per_device"] > 0
    assert set(rec["collective_breakdown"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert rec["roofline"] == hlo_stats.roofline_terms(
        flops=rec["flops_per_device"], bytes_accessed=rec["bytes_per_device"],
        collective_bytes=rec["collective_bytes_per_device"], chips=1)
    assert os.path.exists(tmp_path / "olmo-1b_train_4k_16-16_baseline.json")
    hubert = dryrun.dryrun_one("hubert-xlarge", "decode_32k", verbose=False)
    assert hubert["skipped"] == ref.shape_applicable(
        jax_registry.get_config("hubert-xlarge"), "decode_32k")


# ----------------------------------------------------------------------------
# the vocabulary on the mesh: the lookup, the batch-1 MLP and the argmax
# ----------------------------------------------------------------------------

DECODE_ARCHS = ("olmo-1b", "gemma3-4b")
# the reference's decode matmul FLOPs a device at (2, 4), batch 1, from its
# compiled step in bfloat16 with remat (``_reference_decode``)
REFERENCE_BATCH1_FLOPS = {"olmo-1b": 122_880, "gemma3-4b": 111_616}


def _smoke_bf16(arch):
    return registry.smoke_config(arch).replace(dtype="bfloat16", remat=True)


def _mesh_pol(fsdp=True):
    return ShardingPolicy(dp_axes=("data",), dp_sizes=(DATA,),
                          model_axis_size=MODEL, fsdp=fsdp)


def _table_bytes(cfg):
    return cfg.vocab_size * cfg.d_model * 2           # bfloat16


@pytest.fixture(scope="module")
def decode_counts():
    """(arch, rows) -> the port's traced decode step at (2, 4) (FLOPs and
    the collectives a device) and the reference's compiled one."""
    out = {}
    with dryrun.fake_world(DATA * MODEL):
        mesh = make_host_mesh(DATA, MODEL, device="cpu")
        for arch in DECODE_ARCHS:
            for rows in (1, B):
                traced = dryrun.trace_step(_smoke_bf16(arch), mesh,
                                           _mesh_pol(), kind="decode",
                                           seq=S, batch=rows)
                rec = traced["record"]
                out[arch, rows] = {"flops": rec.dot_flops,
                                   "collectives": rec.collectives}
    for arch, rows in out:
        out[arch, rows]["reference"] = _reference_decode(arch, S, rows)
    return out


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_batch1_decode_flops_match_reference(decode_counts, arch):
    """The batch-1 MLP keeps D split over data as the reference does: a
    decode of one row does the reference's matmul FLOPs a device."""
    got = decode_counts[arch, 1]
    assert got["reference"]["flops"] == REFERENCE_BATCH1_FLOPS[arch]
    assert got["flops"] == REFERENCE_BATCH1_FLOPS[arch]


@pytest.mark.parametrize("rows", [1, B])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_all_gather_bytes_against_reference(decode_counts, arch, rows):
    """All-gather bytes a device of the decode step: at batch 1 within
    twice the reference's, at batch 8 no more than the reference's; no
    collective of the step (the lookup, the tied head, the argmax) is as
    large as the table."""
    got = decode_counts[arch, rows]
    coll = got["collectives"]
    ref = got["reference"]["all_gather"]
    gathered = coll.bytes_by_kind.get("all-gather", 0)
    assert 0 < gathered <= (2 * ref if rows == 1 else ref), (gathered, ref)
    assert max(coll.largest_by_kind.values()) < _table_bytes(
        _smoke_bf16(arch))


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "nofsdp"])
@pytest.mark.parametrize("rows", [1, B])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_lookup_path_gathers_no_table(arch, rows, fsdp):
    """The lookup's forward and backward (the table's gradient reduced to
    its own placements, as the train step does) on the fake (2, 4) world:
    no collective as large as the table.  Under FSDP with the batch over
    data the table's model block is gathered in D (V / model x D, FSDP's
    gather of a weight) and its gradient reduce-scattered back; a batch of
    one gathers (B, S, D) rows instead."""
    import torch

    from repro_torch.launch.shardings import (
        batch_pspecs,
        distribute,
        param_pspecs,
    )
    from repro_torch.models.transformer import Batch, embed_inputs

    cfg = _smoke_bf16(arch)
    pol = _mesh_pol(fsdp)
    fake = hlo_stats.DeviceOpsMode()
    with dryrun.fake_world(DATA * MODEL):
        mesh = make_host_mesh(DATA, MODEL, device="cpu")
        with fake:
            tree = {"embed": torch.zeros((cfg.vocab_size, cfg.d_model),
                                         dtype=torch.bfloat16)}
            table = distribute(tree, mesh, param_pspecs(cfg, tree,
                                                        pol))["embed"]
            tokens = distribute(
                torch.zeros((rows, S), dtype=torch.int32), mesh,
                batch_pspecs(cfg, pol, batch_sharded=rows > 1).tokens)
        table.requires_grad_(True)
        with fake.recording() as record:
            out = embed_inputs({"embed": table}, cfg, Batch(tokens=tokens))
            (grad,) = torch.autograd.grad(out.float().sum(), table)
            grad = grad.redistribute(mesh, table.placements)
    coll = record.collectives
    assert coll.count_by_kind.get("all-reduce", 0) >= 1     # over model
    assert max(coll.largest_by_kind.values()) < _table_bytes(cfg)
    if fsdp and rows > 1:
        block = cfg.vocab_size // MODEL * cfg.d_model * 2
        assert coll.largest_by_kind["all-gather"] == block
        assert coll.count_by_kind["reduce-scatter"] >= 1
    assert tuple(grad.to_local().shape) == tuple(table.to_local().shape)
