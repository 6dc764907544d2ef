"""Multi-pod dry run: trace every (arch x input-shape x mesh) combination's
sharded step on fake ranks and record its per-device roofline.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step for 512 placeholder host devices and reads XLA's analyses.  The
port runs the same step (``launch/steps.py``: train, prefill, decode; an
encoder's "prefill" is its forward) on the production mesh
(``make_production_mesh``: 16 x 16, or 2 x 16 x 16 with ``--multi-pod``)
over a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once), with bfloat16 configs whose parameters, optimizer
state, batches and caches are ``FakeTensor``s.  Nothing is allocated and
nothing is computed; ``launch.hlo_stats.DeviceOpsMode`` records the
matmuls, collectives and live bytes of rank 0.  It runs on the CPU,
needs no GPU, and takes tens of seconds a pair.

The record keeps the reference's keys.  Where torch has no counterpart
the value differs in kind or is null:

* ``compile_s``: the seconds of the traced step;
* ``flops_cost_analysis``: null (XLA's ``cost_analysis``, which the
  reference notes does not multiply loop bodies; nothing in torch
  computes it);
* ``bytes_per_device`` = ``dot_bytes_per_device``: the matmul traffic
  (the reference takes the larger of that and XLA's bytes accessed);
* ``peak_memory_per_device``: the peak bytes of every tensor live on the
  rank, parameters and optimizer state included (the reference's is
  XLA's temporary buffers); ``argument_size`` / ``output_size``: the
  bytes of the step's inputs / outputs on the rank.

A decode step takes its tokens, positions (M-RoPE's too) and cache as
the reference's ``in_shardings`` lay them out (``decode_pspecs``,
``cache_pspecs``): each rank holds and counts its own block of the
cache, built from local zeros (``init_cache`` with the mesh).  Where a
cache dimension does not split evenly, torch gives the first ranks the
extra rows and XLA pads every block to the largest: rank 0's block is
the same size in both.

Usage (records go to ``build/dryrun/``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import dp_axes as mesh_dp_axes
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_size
from repro_torch.launch.shardings import (
    ShardingPolicy,
    batch_pspecs,
    decode_pspecs,
    distribute,
    param_pspecs,
)
from repro_torch.launch.steps import (
    TrainState,
    make_decode_step,
    make_moe_ctx,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import forward, init_cache, init_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.shardctx import full_dtensor
from repro_torch.models.moe import virtual_factor
from repro_torch.models.transformer import Batch
from repro_torch.optim import adamw, linear_warmup_cosine

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")


def shape_applicable(cfg: ModelConfig, shape: str) -> Optional[str]:
    """None if runnable, else the skip reason."""
    if shape in ("decode_32k", "long_500k") and not cfg.is_decoder():
        return "encoder-only: no decode step"
    if shape == "long_500k" and not cfg.is_subquadratic():
        return "pure full attention: 500k decode cache unbounded"
    return None


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process, as rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a process "
                           "group: it makes a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_inputs(cfg: ModelConfig, kind: str, seq: int, batch: int,
                mesh=None, pol: Optional[ShardingPolicy] = None):
    """Stand-ins for a step's model inputs (call under a fake mode): a
    ``Batch`` for train / prefill, else (tokens, position, cache,
    mrope_position) for decode; on a DeviceMesh (with its policy) those
    are DTensors laid out by ``decode_pspecs`` / ``cache_pspecs`` (batch
    1: the batch unsharded), each rank's block made from local zeros."""
    B, S = batch, seq
    dt = torch_dtype(cfg.dtype)
    i32 = torch.int32
    if kind in ("train", "prefill"):
        return model_batch(cfg, B, S)
    cache = init_cache(cfg, B, S, dt, mesh=mesh, pol=pol,
                       batch_sharded=B > 1)
    if mesh is None or getattr(mesh, "is_local", False):
        def zeros(shape, spec):
            return torch.zeros(shape, dtype=i32)
    else:
        def zeros(shape, spec):
            return full_dtensor(shape, 0, i32, "cpu", mesh, spec)
    specs = (decode_pspecs(cfg, pol, batch_sharded=B > 1) if pol is not None
             else None)
    tokens = zeros((B, 1), specs and specs.tokens)
    position = zeros((B,), specs and specs.position)
    mrope = (zeros((3, B, 1), specs and specs.mrope_position)
             if cfg.rope == "mrope" else None)
    return tokens, position, cache, mrope


def model_batch(cfg: ModelConfig, rows: int, seq: int = 1024) -> Batch:
    """A (rows, seq) batch of the config's frontend (call under a fake
    mode)."""
    dt = torch_dtype(cfg.dtype)
    shape = (rows, seq)
    common = dict(targets=torch.zeros(shape, dtype=torch.int32),
                  loss_mask=torch.ones(shape, dtype=torch.float32))
    if cfg.frontend == "audio":
        return Batch(tokens=None,
                     embeds=torch.zeros(shape + (cfg.d_model,), dtype=dt),
                     embed_mask=torch.zeros(shape, dtype=torch.bool),
                     positions=torch.zeros(shape, dtype=torch.int32),
                     **common)
    if cfg.frontend == "vision":
        return Batch(tokens=torch.zeros(shape, dtype=torch.int32),
                     embeds=torch.zeros(shape + (cfg.d_model,), dtype=dt),
                     embed_mask=torch.zeros(shape, dtype=torch.bool),
                     positions=torch.zeros((3,) + shape, dtype=torch.int32),
                     **common)
    return Batch(tokens=torch.zeros(shape, dtype=torch.int32),
                 positions=torch.zeros(shape, dtype=torch.int32), **common)


def trace_step(cfg: ModelConfig, mesh, pol: ShardingPolicy, *, kind: str,
               seq: int, batch: int, mode: str = "bflc",
               microbatches: int = 1) -> Dict:
    """Runs one ``kind`` step of ``cfg`` on fake tensors over ``mesh`` (a
    DeviceMesh over a fake process group) and returns rank 0's counts:
    ``record`` (a ``hlo_stats.DeviceRecord``), ``seconds``,
    ``peak_memory``, ``argument_size`` and ``output_size``."""
    fake = hlo_stats.DeviceOpsMode()
    dp = mesh_dp_axes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= mesh_axis_size(mesh, a)
    r = virtual_factor(cfg, pol.model_axis_size) if cfg.num_experts else 1
    with fake:
        params = init_model(torch.Generator().manual_seed(0), cfg,
                            virtual_r=r)
        params = distribute(params, mesh, param_pspecs(cfg, params, pol))
        bspec = batch_pspecs(cfg, pol, batch_sharded=True)
        if kind == "train":
            moment_dtype = (torch.bfloat16
                            if registry.param_count(cfg) > 5e10 else None)
            opt = adamw(linear_warmup_cosine(3e-4, 100, 10_000),
                        moment_dtype=moment_dtype, weight_decay=0.1)
            state = TrainState(params, opt.init(params),
                               torch.zeros((), dtype=torch.int32))
            val = (distribute(model_batch(cfg, dp_total), mesh, bspec)
                   if mode == "bflc" else None)
            args = (state, distribute(make_inputs(cfg, kind, seq, batch),
                                      mesh, bspec), val)
            step = make_train_step(cfg, opt, mesh, pol, mode=mode,
                                   num_cohorts=dp_total,
                                   committee_size=dp_total,
                                   num_microbatches=microbatches)
        elif kind == "prefill":
            args = (params, distribute(make_inputs(cfg, kind, seq, batch),
                                       mesh, bspec))
            if cfg.is_decoder():
                step = make_prefill_step(cfg, mesh, pol, max_len=seq)
            else:
                # encoder: "prefill" = full-sequence encode (logits only)
                ctx = make_moe_ctx(cfg, mesh, pol, batch_sharded=True)

                def step(p, b):
                    return forward(p, cfg, b, ctx)[0]
        else:
            step = make_decode_step(cfg, mesh, pol,
                                    batch_sharded=batch > 1)
            args = (params,) + make_inputs(cfg, kind, seq, batch, mesh, pol)
    t0 = time.perf_counter()
    with fake.recording() as record:
        record.hold(args)
        out = step(*args)
    seconds = time.perf_counter() - t0
    return {"record": record, "seconds": seconds,
            "peak_memory": record.peak_bytes,
            "argument_size": _local_bytes(args),
            "output_size": _local_bytes(out)}


def _local_tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out.append(t.to_local() if hasattr(t, "to_local") else t)
    return out


def _local_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _local_tensors(tree))


def dryrun_one(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    mode: str = "bflc",
    policy_overrides: Optional[dict] = None,
    verbose: bool = True,
    save: bool = True,
    tag: str = "baseline",
    remat="unit",
    microbatches: int = 1,
) -> Dict:
    cfg = registry.get_config(
        arch, dtype="bfloat16",
        remat="layer" if remat == "layer" else True,
    )
    reason = shape_applicable(cfg, shape)
    rec = {
        "arch": arch, "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mode": mode, "tag": tag,
    }
    if reason:
        rec["skipped"] = reason
        if verbose:
            print(f"[skip] {arch} x {shape}: {reason}")
        return rec

    info = SHAPES[shape]
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            chips = mesh.size()
            dp = mesh_dp_axes(mesh)
            pol = ShardingPolicy(
                dp_axes=dp,
                dp_sizes=tuple(mesh_axis_size(mesh, a) for a in dp),
                model_axis_size=mesh_axis_size(mesh, "model"),
                **(policy_overrides or {}),
            )
            traced = trace_step(cfg, mesh, pol, kind=info["kind"],
                                seq=info["seq"], batch=info["batch"],
                                mode=mode, microbatches=microbatches)
        record = traced["record"]
        coll = hlo_stats.collective_stats(record)
        comp = hlo_stats.compute_stats(record)
        flops = float(comp["dot_flops"])
        bytes_acc = float(comp["dot_bytes"])
        terms = hlo_stats.roofline_terms(
            flops=flops, bytes_accessed=bytes_acc,
            collective_bytes=float(coll.total_bytes), chips=1,
        )  # all values are rank 0's; chips=1 keeps units right
        rec.update({
            "chips": chips,
            "compile_s": round(traced["seconds"], 1),
            "flops_per_device": flops,
            "flops_cost_analysis": None,
            "bytes_per_device": bytes_acc,
            "dot_bytes_per_device": int(comp["dot_bytes"]),
            "collective_bytes_per_device": int(coll.total_bytes),
            "collective_breakdown": coll.bytes_by_kind,
            "collective_counts": coll.count_by_kind,
            "peak_memory_per_device": traced["peak_memory"],
            "argument_size": traced["argument_size"],
            "output_size": traced["output_size"],
            "roofline": terms,
            "params": registry.param_count(cfg),
            "active_params": registry.active_param_count(cfg),
        })
        if verbose:
            print(
                f"[ok] {arch} x {shape} x {rec['mesh']} ({tag}): "
                f"trace {traced['seconds']:.0f}s, "
                f"{flops/1e12:.2f} TF/dev, {bytes_acc/1e9:.2f} GB/dev, "
                f"coll {coll.total_bytes/1e9:.3f} GB/dev, "
                f"peak {traced['peak_memory']/1e9:.2f} GB/dev, "
                f"dominant={terms['dominant']}"
            )
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} x {shape} x {rec['mesh']}: {rec['error']}")

    if save:
        os.makedirs(OUT_DIR, exist_ok=True)
        fname = f"{arch}_{shape}_{rec['mesh'].replace('x','-')}_{tag}.json"
        with open(os.path.join(OUT_DIR, fname), "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(registry.ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mode", default="bflc", choices=["bflc", "standard"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--moe-2d", action="store_true")
    ap.add_argument("--remat", default="unit", choices=["unit", "layer"])
    ap.add_argument("--act-shard-d", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    args = ap.parse_args(argv)

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        pairs = [(a, s) for a in registry.ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    overrides = {}
    if args.no_fsdp:
        overrides["fsdp"] = False
    if args.seq_parallel:
        overrides["seq_parallel_acts"] = True
    if args.moe_2d:
        overrides["moe_tp_over_dp"] = True
    if args.act_shard_d:
        overrides["act_shard_d"] = True
    overrides = overrides or None
    failures = 0
    for mp in meshes:
        for a, s in pairs:
            rec = dryrun_one(
                a, s, multi_pod=mp, mode=args.mode,
                policy_overrides=overrides, tag=args.tag,
                remat=args.remat, microbatches=args.microbatches,
            )
            failures += 1 if "error" in rec else 0
    print(f"\ndone; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
