#!/usr/bin/env python3
"""Runs the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU
    python3 chip_smoke.py --profile  # also profile one more round a runtime

Phases, one JSON line each:
  card     the GPU's name and power limit (nvidia-smi) and the TF32 switches
           the port sets (both must be off)
  build    nvcc of every CUDA source under src/repro_torch/kernels/csrc,
           in parallel, with the build seconds and ptxas's registers, stack
           and spills for every kernel; the sort networks and every
           instance of the fused aggregation must use no stack and spill
           nothing
  kernel   each kernel against its plain PyTorch version (run on CPU copies
           of the same inputs) at the shapes its path gives it and at edge
           shapes (ragged D, all-zero tiles, exact half steps, K from 1 to
           90 on every side of the sort-network widths 8, 16 and 32, ties
           of +0.0 and -0.0, quantize_out on and off for every method, and
           every 0/1 column for K <= 20 through both sorts), with device
           times (CUDA-graph replay between CUDA events) of the kernel,
           L2-warm (``ms``) and L2-cold (``cold_ms``), of the plain version
           and, where one PyTorch call computes the same function, of that
           call; ``eager_ms`` is the kernel's time per call from Python,
           launch path included.  fused_agg has a row for each form the
           round can ask of it (``form``: fedavg, cwmed, trimmed_mean trim
           1, fedavg quantize_out).  ``variant`` names the design the
           wrapper launched, and ``alternatives`` times the other design
           in the same run through its uncounted launcher (cwmed and
           trimmed_mean in shared memory)
  kernel_floor  dequantize, quantize and fused_agg on one tile: launch,
           ramp-up and one round trip to memory
  kernel_k90  the shared-memory sorts at K = 90 (f32 and fused int8): the
           f32 one no path runs, the fused one runs on tiered_int8_cwmed's
           slices at their own K (``kernel_path``)
           The local trainer's per-client products (client_gemm) have a
           row for each of four forms at the full-width shapes (conv2
           forward, conv2 and conv1 weight gradients read through a
           transposed view, fc1 forward), against one torch.mm a client
           within the f32 dot-product bound K * 2^-23 * sum |a||b|
  trainer_invariance  the flat path's local trainer (P = 54, width 32, 20
           steps of batch 32) whole and in consecutive calls of 27, 8 and
           1 clients: every client's update bit for bit the whole call's;
           ``trainer_cost`` the flat int8 path's train stage with this
           trainer and with the per-client program vmapped, in turns
  paths    full-width rounds through repro_torch.api (FEMNIST CNN width 32,
           900 writers, P = 54, Q = 36, k = 8) on one dataset, each path
           with the launch counts set to 0 just before it and read just
           after:
           int8     3 rounds, int8 chain, f32 committee (the first slice):
                    verify(), test accuracy, a read-back of the last round's
                    update blocks re-aggregated by the plain path against
                    the committed model delta
           int8_committee  3 rounds, int8 chain, committee_int8 validator:
                    verify(), the read-back, the packed blobs equal to the
                    scorer's cached rows, one quantize_stack and one
                    fused_candidates launch per cohort and none by the packer
           int8_<method>  2 rounds each of cwmed and trimmed_mean on the
                    int8 chain (the fused kernel's sorts): verify(), the
                    committed model equal to the old model plus the plain
                    reduction of the round's int8 blocks read back off the
                    chain, one fused_agg launch a round
           f32_<method>  2 rounds each of fedavg, cwmed, trimmed_mean with
                    use_kernels=True and an f32 chain: verify(), the
                    committed model equal to the old model plus the plain
                    reduction of the round's update blocks
           tiered_int8, tiered_int8_cwmed, tiered_f32_trimmed_mean
                    2 rounds each of build_runtime(..., tiers=S): an int8
                    chain with the committee_int8 inner validator (S = 2);
                    an int8 cwmed chain at active_proportion 0.2 (S = 2,
                    slices above 32 rows: the fused kernel's column sort
                    with quantize_out); an f32 trimmed-mean chain (S = 3).
                    verify() and the tiered height, the committee blocks,
                    every slice's sub-aggregate (int8: its blob) bit for
                    bit against the plain version over the slice's rows,
                    the committed model against the old one plus the plain
                    reduction of the S stored blocks, hier_logs' peak below
                    the flat stack, exact launch counts (S quantize_out
                    launches a round and one final aggregation on int8);
                    then the tier-1 kernel timed on the largest slice's
                    rows (``kernel_path``)
           async_int8, async_tiered_int8
                    2 rounds each of build_runtime(..., schedule="async") on
                    the int8 and the tiered_int8 configs, in turns with a
                    sequential twin of the same seed and initial params:
                    RoundLogs, committees and hier_logs equal, both chains
                    verify() and are equal block for block with every
                    payload leaf bit for bit, the final params bit for bit,
                    launch counts equal to the twin's (and exact), no
                    implicit host-device sync in the async runtime's cohort
                    stages (torch.cuda.set_sync_debug_mode), and on the
                    tiered path train_dispatch[1] before validate_finalize[0]
                    (the ``order`` line); ``round_pair`` lines put both
                    schedules' round times side by side
           sharded_int8, sharded_int8_committee  world 1 under NCCL in
                    this process (a FileStore group, destroyed after):
                    build_runtime(..., mesh=make_round_mesh(1)) on the int8
                    config (the committee path with committee_int8_sharded),
                    2 rounds each after a flat twin of the same seed and
                    init: RoundLogs, committees, every chain block and the
                    params bit for bit, verify() and the read-back on both,
                    launch counts equal (``sharded_twin``)
           sharded_world2  world 2 under gloo: two ranks spawned by
                    repro_torch.hostdevices.spawn_world, both on cuda:0
                    (NCCL refuses two ranks on one GPU; an exclusive
                    compute mode stops the script), run
                    sharded_int8_committee, sharded_int8 and
                    sharded_async_int8 for 2 rounds each: every rank's
                    chain equal to rank 0's bit for bit, verify(), the
                    committed model equal to the old one plus the plain
                    fused fedavg of the stored blobs, blobs
                    padded_dim_sharded(d, 2) lanes wide and equal to one
                    quantize of the whole packed stack, every D-slice
                    (quantize_stack, fused_agg) and P-block
                    (quantize_stack) bit for bit its plain version
                    (ShardSpies, whose CPU checks are inside the pack,
                    aggregate and validate timings), async equal to its
                    sequential twin; ``world2_vs_world1`` sets the
                    committee path against world 1's round by round; the
                    ranks' launches are summed into ``kernels``;
                    ``kernel_path`` lines time #2 and #4 on each rank's
                    (8, 215,040) slice; ``train_witness``: each rank's
                    block equals the single-device program on its 27
                    clients and the 54-client program's rows bit for
                    bit; ``world2_vs_world1``: the same logs, uploaders,
                    blobs and committed model as world 1 in every round
           baselines  build_runtime(..., baseline=True): 2 rounds each of
                    Basic FL (fedavg) and CwMed over 90 clients, then 20
                    steps of train_standalone: finite params that moved,
                    test accuracies in [0, 1], no kernel launched (the
                    baselines aggregate with the plain reductions)
           serve_olmo_1b  olmo-1b at full width and depth (1,176,764,416
                    f32 params from a seeded generator): one prompt's
                    prefill logits against the same forward on the CPU with
                    float64 weights (``full_width_reference``); behind
                    repro_torch.serve.ServeEngine, the reference CLI's trace
                    (16 Poisson requests at 20/s, prompts 16-64, generations
                    8-32, 4 slots, max_len 96) served continuous and static
                    on a WallClock after warmup (``serve`` lines: tok/s,
                    TTFT and latency percentiles, occupancy), every request
                    equal to its oracle decoding alone in the same slot row
                    (``serve_syncs``: one more continuous run makes no
                    implicit host-device sync and decodes the same tokens)
                    and to its batch-1 oracle (``batch_invariance``, with
                    the logit bits one row against four changes);
                    ``decode_tick`` one step's host, CUDA-event and
                    profiled busy time at 1 and 4 rows; then on a
                    VirtualClock a hot swap at tick 24 to the model block of
                    one int8 round (K = 2 seeded deltas at 1e-3 of each
                    leaf's scale, top_k_int8 packer + fused_int8 fedavg
                    through ``commit_scored_round``): one swap, nothing
                    dropped, requests before / after equal to their
                    version's oracle, spanning ones keeping their v0 prefix;
                    the commit's host seconds split into pack, aggregate and
                    chain append; each update block decoded (dequantize)
                    within one quantization step of its delta, the model
                    block equal to v0 + the plain fused fedavg of the stored
                    blobs bit for bit, verify(); exactly one quantize_stack,
                    one fused_agg and K dequantize launches; then
                    ``kernel_path`` lines for the three kernels at
                    D = 1,176,764,416 (K x Dpad > 2^31) against their plain
                    versions over chunks of lanes, with CUDA-event times
                    and bytes bounds
           serve_rwkv6_7b, serve_qwen3_moe  rwkv6-7b at full width and
                    depth (7,577,018,368 f32 params) and qwen3-moe-30b-a3b
                    at full width, 16 of its 48 units (128 experts top 8,
                    the dense MoE path: 10,592,258,048 params, 42.4 GB),
                    from a seeded generator: serve_olmo_1b's trace
                    continuous and static, every request equal to its
                    same-row and batch-1 oracles (slots reused, so no
                    recurrent state leaks), no implicit sync, a
                    ``decode_tick`` against the bytes bound of reading
                    every parameter, and one prompt's prefill logits on a
                    2-unit cut of the same weights against a float64 host
                    prefill; no hot swap, no kernel launches
           train_lm_100m  repro_torch.launch.train.run_lm on the card at the
                    CLI's defaults (repro-100m, 116,411,136 params, batch
                    16, seq 256, lr 3e-4, linear_warmup_cosine(lr, 20,
                    steps)): standard for 100 steps, then bflc (4 cohorts,
                    committee 4) for 50; per mode the loss every 10 steps,
                    s/step and tokens/s over the steady steps (host clock,
                    synchronized at the window's edges), CUDA-event ms a
                    step, peak memory, 5 profiled steps (busy share, launches
                    a step, leading kernels) and model flops against the f32
                    peak; every loss finite and the last 10 steps' mean
                    TRAIN_LOSS_DROP below the first; one step's gradients at
                    batch 4 against the same step on the CPU in float64,
                    both modes (``grad_check``); no kernel launches
           serve_checkpoint  a ServeEngine (serve_olmo_1b's trace shape)
                    polling a CheckpointParamSource on a directory into
                    which the trained params arrive as model_round_1.msgpack
                    (f32) at tick 24 and their int8 codec blob (quantize) as
                    model_round_2.msgpack at tick 48: two swaps, nothing
                    dropped, requests under one version equal to its oracle,
                    the loaded f32 tree and the decoded (dequantize) int8
                    model bit for bit their plain versions; save and load
                    seconds; quantize and dequantize at D = 116,411,136
                    (``kernel_path``)
           train_olmo_1b  make_train_step on olmo-1b at full width and depth
                    (1,176,764,416 params), bflc, batch 8, seq 256, AdamW
                    warmup 1: 3 steps, step 1 moves nothing, steps 2-3 move
                    every leaf; s/step, peak memory, busy share, f32 share
           train_fl  run_fl for 2 rounds at the CLI's defaults (a plain f32
                    chain: no kernel launches but the local trainer's
                    client_gemm): verify(), accuracy in [0, 1]
Then the ``kernels`` summary line, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; without CUDA it exits 2.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non tensor core)
# flop/s — the bounds below are the larger of bytes / HBM and ops / f32
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
MAIN_K = 8
# inputs read between two reads of one copy in an L2-cold timing (> 50 MB L2)
COLD_BYTES = 100e6
MAIN_P = 54          # trainers scored per cohort at full width
NETWORK_WIDTHS = (8, 16, 32)   # the register sorts' slot counts
# K of the fused aggregation's edge cases: every side of the network widths
# and of its shared-memory column sort (K > 32)
FUSED_EDGE_KS = (1, 3, 8, 16, 17, 32, 33, 64, 65, 90)
# kernel -> (source under src/repro_torch/kernels/csrc, the reference's
# pallas_call it replaces)
KERNELS = {
    "quantize": ("quantize.cu", "src/repro/kernels/quantize.py:39"),
    "quantize_stack": ("quantize.cu", "src/repro/kernels/quantize.py:74"),
    "dequantize": ("quantize.cu", "src/repro/kernels/quantize.py:97"),
    "fused_agg": ("fused_agg.cu", "src/repro/kernels/fused_agg.py:111"),
    "fused_candidates": ("fused_score.cu", "src/repro/kernels/fused_score.py:55"),
    "fedavg_agg": ("f32_agg.cu", "src/repro/kernels/fedavg_agg.py:39"),
    "cwmed": ("f32_agg.cu", "src/repro/kernels/cwmed.py:67"),
    "trimmed_mean": ("f32_agg.cu", "src/repro/kernels/cwmed.py:91"),
    # the local trainer's per-client products: the reference's vmapped
    # per-client XLA program, which no Pallas kernel carries
    "client_gemm": ("client_gemm.cu", "src/repro/fl/client.py:56"),
}
TRAINER_KERNEL = "client_gemm"


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _events_ms(run, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn, iters: int = 50, reps: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, so the Python launch path
    is not in the number.  Inputs stay in the 50 MB L2, as the round's
    just-written stack does."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return _events_ms(graph.replay, reps) / iters


def cold_ms(fn, args, reps: int = 5) -> float:
    """Device time of one call with its inputs cold in L2: the timed calls
    cycle through enough copies of ``args`` that over COLD_BYTES of other
    inputs are read between two reads of one copy."""
    import torch

    per_call = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
    n = math.ceil(COLD_BYTES / per_call) + 1
    copies = itertools.cycle([tuple(a.clone() if isinstance(a, torch.Tensor)
                                    else a for a in args) for _ in range(n)])
    return time_ms(lambda: fn(*next(copies)), iters=n, reps=reps)


def eager_ms(fn, reps: int = 200) -> float:
    """Time of one call as a Python caller pays it (launch path included)."""
    fn()
    return _events_ms(fn, reps)


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def max_err(got, want) -> float:
    """Max |got - want| over a tensor or a tuple of tensors (int8 as ints)."""
    import torch

    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    g = got.detach().cpu().to(torch.float64)
    w = want.detach().cpu().to(torch.float64)
    check(g.shape == w.shape, f"shape {tuple(g.shape)} vs {tuple(w.shape)}")
    return float((g - w).abs().max()) if g.numel() else 0.0


# ----------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------
def same_bits(a, b) -> bool:
    """Bit-for-bit equality of two float32 tensors (CPU copies)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def signed_zero_stack(K: int, D: int, seed: int):
    """edge_stack with ties of +0.0 and -0.0 (half the rows each) in every
    lane of the first tile, as a sign-flip attack leaves them."""
    x = edge_stack(K, D, seed)
    x[:, :2048] = 0.0
    x[K // 2:, :2048] = -0.0
    return x


def edge_stack(K: int, D: int, seed: int):
    """(K, D) f32 on the card: update-sized normals, a first row of exact
    half steps (every tile's amax is 127, so its scale is exactly 1.0), and
    one all-zero tile in every row where D allows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((K, D), generator=g, device="cuda") * 1e-3
    half = torch.arange(D, device="cuda", dtype=torch.float32) % 251 - 125.5
    half[::2048] = 127.0
    x[0] = half
    if D > 4096:
        x[:, 2048:4096] = 0.0
    return x


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_card():
    import torch

    from repro_torch.device import resolve_device

    resolve_device("cuda")
    tf32 = {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    emit(phase="card", nvidia_smi=nvidia_smi(),
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, tf32=tf32)
    check(not any(tf32.values()), "TF32 must be off on the port's path")


def ptxas_report(log: str) -> dict:
    """kernel -> registers, stack and spill bytes, from ``nvcc -Xptxas -v``
    output; names demangled as far as ``repro::name<int>``."""
    out = {}
    for m in re.finditer(
            r"Function properties for (\S+)\n\s*(\d+) bytes stack frame, "
            r"(\d+) bytes spill stores, (\d+) bytes spill loads\n"
            r"[^\n]*Used (\d+) registers", log):
        name = m.group(1)
        n = re.match(r"_ZN5repro(\d+)", name)
        if n:
            rest = name[n.end():]
            base = rest[:int(n.group(1))]
            t = re.match(r"I((?:L[a-z]\d+E)+)E", rest[len(base):])
            name = (f"{base}<{','.join(re.findall(r'L[a-z](\d+)E', t.group(1)))}>"
                    if t else base)
        out[name] = {"registers": int(m.group(5)), "stack": int(m.group(2)),
                     "spill_stores": int(m.group(3)),
                     "spill_loads": int(m.group(4))}
    return out


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {n: ptxas_report(_build.build_log(n)) for n in paths}
    emit(phase="build", seconds=seconds,
         libraries={k: os.path.relpath(v, ROOT) for k, v in paths.items()},
         flags=list(_build.NVCC_FLAGS), ptxas=ptxas)
    for w in NETWORK_WIDTHS:
        net = ptxas["f32_agg"].get(f"sort_net_kernel<{w}>")
        check(net is not None, f"ptxas reported no sort_net_kernel<{w}>")
        check(net["stack"] == 0 and net["spill_stores"] == 0
              and net["spill_loads"] == 0,
              f"sort_net_kernel<{w}> keeps its column off registers: {net}")
    fused = ptxas["fused_agg"]
    want = {f"fused_agg_kernel<{w},{qout}>" for w in (0,) + NETWORK_WIDTHS
            for qout in (0, 1)} | {"fused_column_kernel"}
    check(want <= set(fused), f"ptxas reported {sorted(fused)}, want {sorted(want)}")
    for name, use in fused.items():
        check(use["stack"] == 0 and use["spill_stores"] == 0
              and use["spill_loads"] == 0, f"{name} uses stack or spills: {use}")


def phase_kernels():
    """Each kernel against its plain version; returns the summary rows."""
    import torch

    from repro_torch.core.aggregation import normalize_weights
    from repro_torch.kernels import ops
    from repro_torch.kernels.client_gemm import client_gemm_kernel, client_gemm_ref
    from repro_torch.kernels.cwmed import (
        _CWMED, _TRIMMED_MEAN, _launch_sort, cwmed_kernel, cwmed_ref,
        median_of_sorted, trimmed_mean_kernel, trimmed_mean_of_sorted,
        trimmed_mean_ref,
    )
    from repro_torch.kernels.fedavg_agg import fedavg_agg_kernel, fedavg_agg_ref
    from repro_torch.kernels.fused_agg import METHODS, fused_agg_kernel, fused_agg_ref
    from repro_torch.kernels.fused_score import (
        fused_candidates_kernel, fused_candidates_ref,
    )
    from repro_torch.kernels.ops import padded_dim
    from repro_torch.kernels.quantize import (
        dequantize_kernel, dequantize_ref, quantize_kernel, quantize_ref, quantize_stack_kernel,
        quantize_stack_ref,
    )
    from repro_torch.kernels.tiling import BLOCK_D

    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.tree import ravel_pytree

    # the main path's flattened dimension: femnist_cnn at width 32
    D = int(ravel_pytree(femnist_adapter(32).init(torch.Generator()))[0].numel())
    Dpad = padded_dim(D)
    nblk = Dpad // BLOCK_D
    K = MAIN_K
    g = torch.Generator(device="cuda").manual_seed(0)
    stack = torch.zeros((K, Dpad), device="cuda")
    stack[:, :D] = torch.randn((K, D), generator=g, device="cuda") * 1e-3
    x = stack[0].contiguous()
    q8, s8 = quantize_stack_ref(stack.cpu())
    q8, s8 = q8.cuda(), s8.cuda()
    w = torch.softmax(torch.randn((K,), generator=g, device="cuda"), 0)
    rows = []

    def row(name, fn, plain, cpu_args, gpu_args, tol, nbytes, flops,
            library=None, edge=None, variant=None, alternatives=None,
            form=None):
        """``alternatives``: {variant: fn} other designs of the kernel,
        checked and timed in the same run beside it; ``form``: which of a
        kernel's forms the row times."""
        want = plain(*cpu_args)
        got = fn(*gpu_args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(err <= tol, f"{name}: max_abs_err {err} > {tol}")
        b_ms, b_by = bound_ms(nbytes, flops)
        source, replaces = KERNELS[name]
        entry = {
            "name": name, "form": form, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/" + source,
            "replaces": replaces, "variant": variant, "launches": None,
            "max_abs_err": err, "tolerance": tol,
            "ms": time_ms(lambda: fn(*gpu_args)),
            "cold_ms": cold_ms(fn, gpu_args),
            "eager_ms": eager_ms(lambda: fn(*gpu_args)),
            "plain_ms": time_ms(lambda: plain(*gpu_args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library) if library else None,
            "shape": [list(a.shape) for a in gpu_args if hasattr(a, "shape")],
        }
        entry["alternatives"] = []
        for alt, alt_fn in (alternatives or {}).items():
            alt_err = max_err(alt_fn(*gpu_args), want)
            check(alt_err <= tol, f"{name} ({alt}): max_abs_err {alt_err}")
            entry["alternatives"].append({
                "variant": alt, "max_abs_err": alt_err,
                "ms": time_ms(lambda: alt_fn(*gpu_args)),
                "cold_ms": cold_ms(alt_fn, gpu_args)})
        if edge is not None:
            entry["edge_cases"], entry["edge_max_abs_err"] = edge()
        emit(phase="kernel", **entry)
        rows.append(entry)

    def sort_variant(K_):
        """The design the sort kernels' C entries pick for K_ rows."""
        w_ = next((v for v in NETWORK_WIDTHS if K_ <= v), None)
        return f"register network W={w_}" if w_ else "shared memory"

    def edge_quantize():
        """Row 0 of exact half steps (each lane's product with the
        reciprocal on a half-integer: the division fallback), row 1 of
        normals with -0.0 in every seventh lane and an all-zero tile."""
        n, worst = 0, 0.0
        for D_ in (1, 2048, 5000, 6145):
            for r in (0, 1):
                xs = edge_stack(2, D_, D_)[r].contiguous()
                if r:
                    xs[::7] = -0.0
                got = ops.quantize(xs)
                want = ops.quantize(xs.cpu())
                worst = max(worst, max_err(got[:2], want[:2]))
                check(same_bits(got[1], want[1]), f"quantize scales D={D_}")
                n += 1
        check(worst == 0.0, f"quantize edge cases differ by {worst}")
        return n, worst

    def edge_quantize_stack():
        n, worst = 0, 0.0
        for K_ in (1, 3, 8, 17):
            for D_ in (2048, 5000, 6145):
                xs = edge_stack(K_, D_, K_ * 7919 + D_)
                worst = max(worst, max_err(ops.quantize_stack(xs)[:2],
                                           ops.quantize_stack(xs.cpu())[:2]))
                n += 1
        check(worst == 0.0, f"quantize_stack edge cases differ by {worst}")
        return n, worst

    def edge_dequantize():
        n, worst = 0, 0.0
        for D_ in (2048, 5000, 6145):
            q, s, d = ops.quantize(edge_stack(1, D_, D_)[0].cpu())
            worst = max(worst, max_err(ops.dequantize(q.cuda(), s.cuda(), d),
                                       ops.dequantize(q, s, d)))
            n += 1
        check(worst == 0.0, f"dequantize edge cases differ by {worst}")
        return n, worst

    def edge_fused():
        n, worst = 0, 0.0
        for K_ in FUSED_EDGE_KS:
            for D_ in (2048, 5000, 6145):
                q, s, d = ops.quantize_stack(edge_stack(K_, D_, K_ + D_).cpu())
                wts = torch.rand((K_,), generator=torch.Generator().manual_seed(K_))
                trim = (K_ - 1) // 2
                for method in METHODS:
                    for qout in (False, True):
                        kw = dict(method=method, trim=trim, quantize_out=qout)
                        got = ops.aggregate_quantized(q.cuda(), s.cuda(), d,
                                                      weights=wts.cuda(), **kw)
                        want = ops.aggregate_quantized(q, s, d, weights=wts, **kw)
                        n += 1
                        if not qout:
                            err = max_err(got, want)
                            scale = float(want.abs().max()) or 1.0
                            tol = 0.0 if method == "cwmed" else 1e-6 * scale
                        else:
                            # q within one step (sum order moves a half
                            # step), scales within rtol 1e-6
                            err = max_err(got[0], want[0])
                            tol = 0.0 if method == "cwmed" else 1.0
                            s_err = float(((got[1].cpu() - want[1]).abs()
                                           / want[1]).max())
                            check(s_err <= (0.0 if method == "cwmed" else 1e-6),
                                  f"fused_agg {method} K={K_} D={D_} qout "
                                  f"scales rel err {s_err}")
                        check(err <= tol, f"fused_agg {method} K={K_} D={D_} "
                                          f"qout={qout}: {err} > {tol}")
                        worst = max(worst, err)
        return n, worst

    def edge_fused_zero_one():
        """Every 0/1 column for K <= 20 through the fused sorts (int8
        columns holding the bits of their index, scales 1.0): by the 0-1
        principle a proof of the network's median and trimmed-mean
        positions at each K."""
        n = 0
        for K_ in range(1, 21):
            cols = 2 ** K_
            D_ = -(-cols // BLOCK_D) * BLOCK_D
            c = torch.arange(D_) % cols
            q = ((c[None, :] >> torch.arange(K_)[:, None]) & 1).to(torch.int8)
            s_, w_ = torch.ones((K_, D_ // BLOCK_D)), torch.full((K_,), 1.0 / K_)
            qg, sg, wg = q.cuda(), s_.cuda(), w_.cuda()
            srt = torch.sort(q.to(torch.float32), dim=0).values
            check(same_bits(fused_agg_kernel(qg, sg, wg, method="cwmed"),
                            median_of_sorted(srt)), f"fused cwmed 0/1 K={K_}")
            n += 1
            for trim in range(1, (K_ - 1) // 2 + 1):
                got = fused_agg_kernel(qg, sg, wg, method="trimmed_mean", trim=trim)
                check(same_bits(got, trimmed_mean_of_sorted(srt, trim)),
                      f"fused trimmed_mean 0/1 K={K_} trim={trim}")
                n += 1
        return n, 0.0

    def edge_candidates():
        n = 0
        for K_ in (1, 3, 17):
            for D_ in (2048, 5000, 6145):
                q, s, d = ops.quantize_stack(edge_stack(K_, D_, 31 * K_ + D_).cpu())
                base = torch.randn((D_,), generator=torch.Generator().manual_seed(D_))
                got = ops.candidates_from_quantized(base.cuda(), q.cuda(), s.cuda(), d)
                want = ops.candidates_from_quantized(base, q, s, d)
                check(same_bits(got, want), f"fused_candidates K={K_} D={D_}")
                n += 1
        return n, 0.0

    def edge_f32():
        """fedavg (same weights) and trimmed mean bit for bit, the median
        by value; with +-0.0 ties fedavg and the median by value."""
        n = 0
        for K_ in (1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 32, 33, 90):
            for D_ in (2048, 5000, 6145):
                for zeros in (False, True):
                    xs = (signed_zero_stack if zeros else edge_stack)(K_, D_, K_ * 3 + D_)
                    wts = normalize_weights(K_, torch.rand((K_,), device="cuda"), "cuda")
                    trim = (K_ - 1) // 2
                    pairs = {
                        "fedavg": (ops.fedavg_agg(xs, wts),
                                   ops.fedavg_agg(xs.cpu(), wts.cpu())),
                        "cwmed": (ops.cwmed(xs), ops.cwmed(xs.cpu())),
                        "trimmed_mean": (ops.trimmed_mean(xs, trim),
                                         ops.trimmed_mean(xs.cpu(), trim)),
                    }
                    for method, (got, want) in pairs.items():
                        if method == "cwmed" or (zeros and method == "fedavg"):
                            ok = torch.equal(got.cpu(), want)
                        else:
                            ok = same_bits(got, want)
                        check(ok, f"{method} K={K_} D={D_} signed_zeros={zeros}")
                        n += 1
        return n, 0.0

    f32, i8 = 4, 1
    row("quantize", quantize_kernel,
        quantize_ref, (x.cpu(),), (x,), 0.0,
        Dpad * f32 + Dpad * i8 + nblk * f32, 6 * Dpad, edge=edge_quantize,
        variant="4 warps a tile")
    row("quantize_stack",
        quantize_stack_kernel, quantize_stack_ref, (stack.cpu(),), (stack,),
        0.0, K * (Dpad * f32 + Dpad * i8 + nblk * f32), 6 * K * Dpad,
        edge=edge_quantize_stack, variant="4 warps a tile")
    q1, s1 = q8[0].contiguous(), s8[0].contiguous()
    row("dequantize", dequantize_kernel,
        dequantize_ref, (q1.cpu(), s1.cpu()), (q1, s1), 0.0,
        Dpad * i8 + nblk * f32 + Dpad * f32, Dpad,
        library=lambda: torch.mul(q1.view(-1, BLOCK_D), s1[:, None]),
        edge=edge_dequantize, variant="4 lanes a thread")
    # the fused aggregation's four forms at the main path's (8, Dpad);
    # operations a lane: K dequantizes (2 each), then fedavg's K
    # multiply-adds (2 each), or K(K-1)/2 sort compares and the reader
    q_in = K * Dpad * i8 + K * nblk * f32
    fused_forms = (
        ("fedavg", dict(), q_in + K * f32 + Dpad * f32, 4 * K * Dpad,
         edge_fused),
        ("cwmed", dict(method="cwmed"), q_in + Dpad * f32,
         (2 * K + K * (K - 1) // 2 + 2) * Dpad, edge_fused_zero_one),
        ("trimmed_mean trim 1", dict(method="trimmed_mean", trim=1),
         q_in + Dpad * f32, (2 * K + K * (K - 1) // 2 + K - 1) * Dpad, None),
        ("fedavg quantize_out", dict(quantize_out=True),
         q_in + K * f32 + Dpad * i8 + nblk * f32, (4 * K + 6) * Dpad, None),
    )
    for form, kw, nbytes, ops_, edge in fused_forms:
        plain = functools.partial(fused_agg_ref, method=kw.get("method", "fedavg"),
                                  trim=kw.get("trim", 1),
                                  quantize_out=kw.get("quantize_out", False))
        layout = ("4 lanes a thread, one block of 512 a tile" if kw.get("quantize_out")
                  else "4 lanes a thread, 4 blocks of 128 a tile")
        # fedavg is one FMA chain on both sides: exact given the same weights
        row("fused_agg", functools.partial(fused_agg_kernel, **kw), plain,
            (q8.cpu(), s8.cpu(), w.cpu()), (q8, s8, w), 0.0, nbytes, ops_,
            edge=edge, form=form,
            variant=(f"{sort_variant(K)}, {layout}" if "method" in kw else layout))

    # one tile: launch, ramp-up and one round trip to memory, which no
    # layout of the bytes removes
    x1 = x[:BLOCK_D].contiguous()
    qt, st = q8[:, :BLOCK_D].contiguous(), s8[:, :1].contiguous()
    for name, fn, shape in (
            ("dequantize", lambda: dequantize_kernel(q1[:BLOCK_D], s1[:1]),
             [[BLOCK_D], [1]]),
            ("quantize", lambda: quantize_kernel(x1), [[BLOCK_D]]),
            ("fused_agg", lambda: fused_agg_kernel(qt, st, w),
             [[K, BLOCK_D], [K, 1], [K]])):
        emit(phase="kernel_floor", name=name, shape=shape, floor_ms=time_ms(fn))

    # the committee_int8 scorer's candidates: P rows of the padded width
    P = MAIN_P
    upd = torch.zeros((P, Dpad), device="cuda")
    upd[:, :D] = torch.randn((P, D), generator=g, device="cuda") * 1e-3
    qp, sp = quantize_stack_ref(upd.cpu())
    qp, sp = qp.cuda(), sp.cuda()
    base = torch.zeros((Dpad,), device="cuda")
    base[:D] = torch.randn((D,), generator=g, device="cuda") * 0.05
    row("fused_candidates", fused_candidates_kernel, fused_candidates_ref,
        (base.cpu(), qp.cpu(), sp.cpu()), (base, qp, sp), 0.0,
        P * Dpad * i8 + Dpad * f32 + P * nblk * f32 + P * Dpad * f32,
        2 * P * Dpad,
        library=lambda: torch.addcmul(base.view(1, nblk, BLOCK_D),
                                      qp.view(P, nblk, BLOCK_D),
                                      sp.view(P, nblk, 1)),
        edge=edge_candidates)

    # the f32 kernel path's stack: K unpadded rows (the kernels mask the edge)
    xs = stack[:, :D].contiguous()
    sort_ops = K * (K - 1) // 2 * D
    half = torch.tensor(0.5, device="cuda")    # a device q: no host check
    row("fedavg_agg", fedavg_agg_kernel, fedavg_agg_ref, (xs.cpu(), w.cpu()),
        (xs, w), 0.0, K * D * f32 + K * f32 + D * f32, 2 * K * D,
        library=lambda: torch.matmul(w, xs), edge=edge_f32)
    row("cwmed", cwmed_kernel, cwmed_ref, (xs.cpu(),), (xs,), 0.0,
        K * D * f32 + D * f32, sort_ops + D,
        library=lambda: torch.quantile(xs, half, dim=0),
        variant=sort_variant(K),
        alternatives={"shared memory": lambda a: _launch_sort(
            a, _CWMED, 0, force_shared=True)})
    row("trimmed_mean", lambda a: trimmed_mean_kernel(a, trim=1),
        lambda a: trimmed_mean_ref(a, 1), (xs.cpu(),), (xs,), 0.0,
        K * D * f32 + D * f32, sort_ops + (K - 1) * D,
        variant=sort_variant(K),
        alternatives={"shared memory": lambda a: _launch_sort(
            a, _TRIMMED_MEAN, 1, force_shared=True)})

    # the local trainer's per-client products at the main path's shapes
    # (P = 54 clients, batch 32, width 32): two forward products and the
    # two weight gradients that read a transposed operand in place.  The
    # plain version sums in another order (one torch.mm a client), so the
    # tolerance is the f32 dot-product bound K * 2^-23 * (sum |a||b| + |bias|)
    bs = 32
    for form, (M_, K_, N_), transposed, with_bias in (
            ("conv2 forward", (bs * 196, 288, 64), False, True),
            ("conv2 weight gradient", (288, bs * 196, 64), True, False),
            ("conv1 weight gradient", (9, bs * 784, 32), True, False),
            ("fc1 forward", (bs, 3136, 128), False, True)):
        a_ = (torch.randn((MAIN_P, K_, M_), generator=g, device="cuda")
              .transpose(1, 2) if transposed else
              torch.randn((MAIN_P, M_, K_), generator=g, device="cuda"))
        b_ = torch.randn((MAIN_P, K_, N_), generator=g, device="cuda")
        bias_ = (torch.randn((MAIN_P, N_), generator=g, device="cuda")
                 if with_bias else None)
        cpu_ = tuple(t.cpu() if t is not None else None for t in (a_, b_, bias_))
        scale = float(client_gemm_ref(cpu_[0].abs(), cpu_[1].abs()).max())
        scale += float(cpu_[2].abs().max()) if with_bias else 0.0
        row("client_gemm", client_gemm_kernel, client_gemm_ref, cpu_,
            (a_, b_, bias_), K_ * 2.0 ** -23 * scale,
            f32 * MAIN_P * (M_ * K_ + K_ * N_ + M_ * N_ + N_ * with_bias),
            2 * MAIN_P * M_ * N_ * K_,
            library=(lambda a=a_, b=b_, c=bias_: torch.baddbmm(c[:, None], a, b)
                     if c is not None else torch.bmm(a, b)),
            form=form)

    # the shared-memory sort at a full Basic-FL cohort's K, which no path
    # runs (the baselines aggregate with the plain reductions)
    K90 = 90
    x90 = torch.randn((K90, D), generator=g, device="cuda") * 1e-3
    srt = torch.sort(x90.cpu(), dim=0).values
    for method, fn, want, extra_ops in (
            ("cwmed", cwmed_kernel, median_of_sorted(srt), D),
            ("trimmed_mean", lambda a: trimmed_mean_kernel(a, trim=1),
             trimmed_mean_of_sorted(srt, 1), (K90 - 1) * D)):
        err = max_err(fn(x90), want)
        check(err == 0.0, f"{method} K={K90}: max_abs_err {err}")
        b_ms, b_by = bound_ms(K90 * D * f32 + D * f32,
                              K90 * (K90 - 1) // 2 * D + extra_ops)
        emit(phase="kernel_k90", name=method, variant=sort_variant(K90),
             shape=[K90, D], max_abs_err=err, ms=time_ms(lambda: fn(x90)),
             cold_ms=cold_ms(fn, (x90,)), bound_ms=b_ms, bound_by=b_by)
    # the fused kernel's column sort at the same K, from int8
    x90p = torch.zeros((K90, Dpad), device="cuda")
    x90p[:, :D] = x90
    q90, s90 = quantize_stack_ref(x90p.cpu())
    w90 = torch.full((K90,), 1.0 / K90)
    want = fused_agg_ref(q90, s90, w90, method="cwmed")
    q90, s90, w90 = q90.cuda(), s90.cuda(), w90.cuda()
    fn = functools.partial(fused_agg_kernel, method="cwmed")
    err = max_err(fn(q90, s90, w90), want)
    check(err == 0.0, f"fused_agg cwmed K={K90}: max_abs_err {err}")
    b_ms, b_by = bound_ms(K90 * Dpad * i8 + K90 * nblk * f32 + Dpad * f32,
                          (2 * K90 + K90 * (K90 - 1) // 2 + 2) * Dpad)
    emit(phase="kernel_k90", name="fused_agg", form="cwmed",
         variant="shared-memory column sort", shape=[K90, Dpad],
         max_abs_err=err, ms=time_ms(lambda: fn(q90, s90, w90), iters=5, reps=4),
         cold_ms=cold_ms(fn, (q90, s90, w90), reps=1), bound_ms=b_ms,
         bound_by=b_by)
    return rows


def run_rounds(path: str, rt, rounds: int) -> None:
    import torch

    for _ in range(rounds):
        t0 = time.perf_counter()
        log = rt.run_round()
        torch.cuda.synchronize()
        emit(phase="round", path=path, seconds=time.perf_counter() - t0,
             timings=rt.stage_timings[-1], log=log.__dict__)


def readback(path: str, rt, rounds: int) -> None:
    """Decode the last round's update blocks (dequantize kernel), re-
    aggregate them with the plain fedavg and the packed scores, and hold
    that against the committed model delta, within one quantization step;
    then publish the delta through the chain codec (quantize kernel)."""
    import torch

    from repro_torch.core.aggregation import fedavg, flatten_updates
    from repro_torch.tree import ravel_pytree

    t = rounds - 1
    decoded = rt.chain.update_payloads_at_round(t)
    blobs = rt.chain.update_payloads_at_round(t, decode=False)
    scores = [b.score for b in rt.chain.updates_at_round(t)]
    stack, unravel = flatten_updates(decoded)
    replay = fedavg(stack, scores)
    old = ravel_pytree(rt.chain.model_at_round(t))[0]
    new = ravel_pytree(rt.chain.model_at_round(t + 1))[0]
    check(bool(torch.isfinite(new).all()), "committed params are finite")
    delta = new - old
    step = max(float(b["scales"].max()) for b in blobs)
    replay_err = float((replay - delta).abs().max())
    blob = rt.chain.codec.encode(unravel(delta))
    codec_err = float((ravel_pytree(rt.chain.codec.decode(blob))[0]
                       - delta).abs().max())
    codec_step = float(blob["scales"].max())
    emit(phase="readback", path=path, round=t, blocks=len(blobs),
         replay_max_abs_err=replay_err, quantization_step=step,
         codec_max_abs_err=codec_err, codec_half_step=0.5 * codec_step)
    check(replay_err <= step, f"{path}: replayed aggregate off by "
                              f"{replay_err} > {step}")
    check(codec_err <= 0.5 * codec_step * (1 + 1e-5) + 1e-12,
          f"{path}: codec round trip off by {codec_err}")


def verify(path: str, rt, rounds: int) -> None:
    verified = rt.chain.verify()
    emit(phase="verify", path=path, ok=verified, height=rt.chain.height)
    check(verified, f"{path}: chain.verify()")
    check(rt.chain.height == 1 + rounds * (rt.cfg.k_updates + 1),
          f"{path}: chain height")


def counted(path: str, drive, need: dict):
    """Drive one path with every launch count set to 0 just before it,
    read the counts just after, and require ``need``'s minimums.  Returns
    the counts and the runtime ``drive`` returned."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    rt = drive()
    counts = launch_counts()
    emit(phase="launches", path=path, launches=counts)
    for name, least in need.items():
        check(counts[name] >= least, f"{path}: {name} launched "
                                     f"{counts[name]} times, want >= {least}")
    return counts, rt


def build(ds, cfg: dict, stages=None, tiers=None, **kw):
    from repro_torch.api import build_runtime
    from repro_torch.fl.adapter import femnist_adapter

    return build_runtime(femnist_adapter(width=32), ds, {**cfg, "seed": 0},
                         stages=stages, tiers=tiers, device="cuda", **kw)


def path_int8(ds):
    """The first slice's path: int8 chain, f32 committee scoring."""
    rounds = 3

    def drive():
        t0 = time.perf_counter()
        rt = build(ds, {"quantize_chain": True, "use_kernels": True})
        emit(phase="round_setup", path="int8",
             seconds=time.perf_counter() - t0, dim=rt.chain.codec.dim,
             p_trainers=rt.p_trainers, q_committee=rt.q_committee,
             k=rt.cfg.k_updates)
        run_rounds("int8", rt, rounds)
        t0 = time.perf_counter()
        acc = rt.evaluate()
        emit(phase="evaluate", path="int8", seconds=time.perf_counter() - t0,
             test_accuracy=acc)
        check(0.0 <= acc <= 1.0, f"test accuracy {acc}")
        verify("int8", rt, rounds)
        readback("int8", rt, rounds)
        return rt

    return counted("int8", drive, {"quantize_stack": rounds,
                                   "fused_agg": rounds,
                                   "dequantize": MAIN_K + 1, "quantize": 1})


TRAINER_CALLS = (27, 8, 1)     # clients a call, against one call of MAIN_P
TRAINER_TURNS = ("client_gemm", "vmap", "client_gemm", "vmap")
TRAINER_TURN_ROUNDS = 2


def phase_trainer_invariance(ds) -> None:
    """The flat path's local trainer on the card (FEMNIST CNN width 32, the
    round's 20 steps of batch 32, lr 0.02, momentum 0.9) on MAIN_P
    clients' batches, whole and in consecutive calls of 27, 8 and 1
    clients: every row must equal the whole call's bit for bit.  Then the
    flat int8 path's train stage with this trainer against the per-client
    program ``vmap``ped (the form whose rows moved with P), runtimes of
    TRAINER_TURN_ROUNDS rounds in turns, each turn's first round a warmup:
    ``trainer_cost`` lines."""
    import numpy as np
    import torch

    from repro_torch.api import build_runtime
    from repro_torch.device import to_device
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.client import flatten_stacked_updates, sample_client_batches

    rt = build(ds, {"quantize_chain": True, "use_kernels": True})
    cfg = rt.cfg
    rng = np.random.default_rng(0)
    batches = [sample_client_batches(rng, ds.client_images[c],
                                     ds.client_labels[c], cfg.local_steps,
                                     cfg.local_batch) for c in range(MAIN_P)]
    xs = to_device(np.stack([b[0] for b in batches]), "cuda")
    ys = to_device(np.stack([b[1] for b in batches]), "cuda")

    params = rt.global_params()

    def train(lo, hi):
        return flatten_stacked_updates(rt._local_train(params, xs[lo:hi],
                                                       ys[lo:hi]))

    whole = train(0, MAIN_P)
    for n in TRAINER_CALLS:
        parts = torch.cat([train(i, i + n) for i in range(0, MAIN_P, n)])
        rows = (parts != whole).any(dim=1)
        out = {"clients": MAIN_P, "call": n, "equal": same_bits(parts, whole),
               "rows_differing": int(rows.sum()),
               "max_abs_diff": float((parts - whole).abs().max())}
        emit(phase="trainer_invariance", **out)
        check(out["equal"], f"calls of {n} clients differ from one call of "
                            f"{MAIN_P}: {out}")
    del rt
    train_s = {form: [] for form in TRAINER_TURNS}
    for form in TRAINER_TURNS:
        adapter = femnist_adapter(width=32)
        if form == "vmap":
            adapter = adapter._replace(stacked_loss=None)
        rt = build_runtime(adapter, ds, {"quantize_chain": True,
                                         "use_kernels": True, "seed": 0},
                           device="cuda")
        for _ in range(TRAINER_TURN_ROUNDS):
            rt.run_round()
        train_s[form] += [t["train"] for t in
                          rt.stage_timings[1:]]
        del rt
    emit(phase="trainer_cost", path="int8", steady_rounds=train_s,
         steady_min_max={f: [min(v), max(v)] for f, v in train_s.items()},
         card=nvidia_smi())


def path_int8_committee(ds):
    """committee_int8: the committee scores the int8 view of each update
    (quantize_stack + fused_candidates), and the packer stores those rows."""
    import torch

    from repro_torch.fl.pipeline import cached_row_stack, resolve
    from repro_torch.kernels import launch_counts

    rounds = 3
    scorer = resolve("validator", "committee_int8")
    packer = resolve("packer", "top_k_int8")
    cohorts, packed, requantized = [], [], []

    class CountingValidator:
        def prepare(self, ctx):
            scorer.prepare(ctx)

        def __call__(self, ctx):
            cohorts.append(ctx.cohort)
            scorer(ctx)

    def spy_packer(ctx):
        """A round decided in its first cohort packs the scorer's cached
        rows and quantizes nothing; only one that took more cohorts may
        pack an uploader scored before the last cohort's cache clear, and
        then the packer quantizes the packed stack once, as the reference
        does."""
        before = launch_counts()["quantize_stack"]
        packer(ctx)
        launched = launch_counts()["quantize_stack"] - before
        cached = cached_row_stack(ctx)
        requantized.append(cached is None)
        check(cached is not None or ctx.cohort > 0,
              f"round {ctx.round} was decided in its first cohort but its "
              f"packed rows are not the scorer's cached rows")
        check(launched == (1 if cached is None else 0),
              f"the packer launched quantize_stack {launched} times")
        q, s, _, _ = ctx.packed_quantized
        if cached is not None:
            check(torch.equal(q, cached[0]) and torch.equal(s, cached[1]),
                  "packed blobs differ from the scorer's cached rows")
        blocks = ctx.chain.updates_at_round(ctx.round)
        check(all(torch.equal(b.payload["q"], q[i]) and
                  torch.equal(b.payload["scales"], s[i])
                  for i, b in enumerate(blocks)),
              "chain blobs differ from the packed rows")
        packed.append(len(blocks))

    def drive():
        rt = build(ds, {"quantize_chain": True, "use_kernels": True},
                   stages={"validator": CountingValidator(),
                           "packer": spy_packer})
        run_rounds("int8_committee", rt, rounds)
        verify("int8_committee", rt, rounds)
        readback("int8_committee", rt, rounds)
        return rt

    counts, rt = counted("int8_committee", drive,
                     {"quantize_stack": rounds, "fused_candidates": rounds,
                      "fused_agg": rounds})
    emit(phase="row_cache", path="int8_committee", cohorts=len(cohorts),
         packed_blocks=packed, rounds_requantized=sum(requantized))
    check(not all(requantized), "no round packed the scorer's cached rows")
    check(counts["quantize_stack"] == len(cohorts) + sum(requantized),
          f"quantize_stack launched {counts['quantize_stack']} times for "
          f"{len(cohorts)} cohorts and {sum(requantized)} re-quantizing "
          f"packers")
    check(counts["fused_candidates"] == len(cohorts),
          "fused_candidates not launched once per cohort")
    check(packed == [MAIN_K] * rounds, f"packed blocks {packed}")
    return counts, rt


def path_f32(ds, method: str):
    """use_kernels=True without quantize_chain: the f32 chain, aggregated by
    the f32 kernel of ``method``; the committed model must equal the old
    one plus the plain reduction of the round's update blocks (bit for bit
    for fedavg and trimmed_mean, by value for the median)."""
    import torch

    from repro_torch.core.aggregation import (
        apply_update, flatten_updates, normalize_weights,
    )
    from repro_torch.kernels.cwmed import cwmed_ref, trimmed_mean_ref
    from repro_torch.kernels.fedavg_agg import fedavg_agg_ref
    from repro_torch.tree import ravel_pytree

    path = f"f32_{method}"
    rounds = 2

    def drive():
        rt = build(ds, {"use_kernels": True, "aggregation": method})
        run_rounds(path, rt, rounds)
        verify(path, rt, rounds)
        t = rounds - 1
        stack, unravel = flatten_updates(rt.chain.update_payloads_at_round(t))
        if method == "fedavg":
            scores = [b.score for b in rt.chain.updates_at_round(t)]
            plain = fedavg_agg_ref(stack, normalize_weights(
                len(scores), scores, stack.device))
        elif method == "cwmed":
            plain = cwmed_ref(stack)
        else:
            plain = trimmed_mean_ref(stack, rt.cfg.trim)
        replay = ravel_pytree(apply_update(rt.chain.model_at_round(t),
                                           unravel(plain)))[0]
        new = ravel_pytree(rt.chain.model_at_round(t + 1))[0]
        exact = (torch.equal(replay, new) if method == "cwmed"
                 else same_bits(replay, new))
        emit(phase="replay", path=path, round=t, rows=stack.shape[0],
             exact=exact, max_abs_err=float((replay - new).abs().max()))
        check(exact, f"{path}: committed model differs from the plain replay")
        return rt

    kernel = "fedavg_agg" if method == "fedavg" else method
    return counted(path, drive, {kernel: rounds})


def path_int8_sort(ds, method: str):
    """The int8 chain aggregated by the fused kernel's cwmed or trimmed mean:
    verify(), and the committed model equal to the old one plus the plain
    reduction of the round's int8 blocks as stored on the chain (by value
    for the median, bit for bit for the trimmed mean)."""
    import torch

    from repro_torch.core.aggregation import apply_update
    from repro_torch.kernels.fused_agg import fused_agg_ref
    from repro_torch.tree import ravel_pytree

    path = f"int8_{method}"
    rounds = 2

    def drive():
        rt = build(ds, {"quantize_chain": True, "use_kernels": True,
                        "aggregation": method})
        run_rounds(path, rt, rounds)
        verify(path, rt, rounds)
        t = rounds - 1
        blobs = rt.chain.update_payloads_at_round(t, decode=False)
        q = torch.stack([b["q"] for b in blobs]).cpu()
        s = torch.stack([b["scales"] for b in blobs]).cpu()
        plain = fused_agg_ref(q, s, torch.ones(len(blobs)), method, rt.cfg.trim)
        old = rt.chain.model_at_round(t)
        flat_old, unravel = ravel_pytree(old)
        agg = plain[:blobs[0]["d"]].to(flat_old.device)
        replay = ravel_pytree(apply_update(old, unravel(agg)))[0]
        new = ravel_pytree(rt.chain.model_at_round(t + 1))[0]
        exact = (torch.equal(replay, new) if method == "cwmed"
                 else same_bits(replay, new))
        emit(phase="replay", path=path, round=t, rows=q.shape[0],
             exact=exact, max_abs_err=float((replay - new).abs().max()))
        check(exact, f"{path}: committed model differs from the plain replay")
        return rt

    counts, rt = counted(path, drive, {"quantize_stack": rounds, "fused_agg": rounds})
    check(counts["fused_agg"] == rounds,
          f"{path}: fused_agg launched {counts['fused_agg']} times in {rounds} rounds")
    return counts, rt


# the tiered paths: path -> (config, tiers S, inner validator)
TIERED_PATHS = {
    "tiered_int8": ({"quantize_chain": True, "use_kernels": True}, 2,
                    "committee_int8"),
    "tiered_int8_cwmed": ({"quantize_chain": True, "use_kernels": True,
                           "aggregation": "cwmed", "active_proportion": 0.2},
                          2, "committee"),
    "tiered_f32_trimmed_mean": ({"use_kernels": True,
                                 "aggregation": "trimmed_mean"}, 3,
                                "committee"),
}


def plain_quantized_rows(stack):
    """(K, D) f32 -> the chain codec's (q, scales) of every row on the CPU,
    by the plain version (padded to the 2048-lane tile first)."""
    import torch.nn.functional as F

    from repro_torch.kernels.quantize import quantize_stack_ref

    return quantize_stack_ref(F.pad(stack.cpu(), (0, (-stack.shape[1]) % 2048)))


def _slice_ids(records):
    """The rows a slice aggregates, by the rule of the tiered round: its
    accepted updates best first (or its best one when none qualified)."""
    accepted = sorted((r for r in records if r[2]), key=lambda r: -r[1])
    chosen = accepted or sorted(records, key=lambda r: -r[1])[:1]
    return [r[0] for r in chosen], [r[1] for r in chosen]


def path_tiered(ds, path: str):
    """A tiered (two-tier) round through build_runtime(..., tiers=S): S
    slices, each scored by its own sub-committee and reduced to one
    sub-aggregate, then a tier-2 committee round over the S of them.  A
    spy around the inner validator keeps each slice's updates and
    consensus records, and a spy around the ``hier`` packer keeps the S
    sub-aggregates (and blobs) before they are packed.  Checked:
    verify() and the tiered height; the committee block's members and S
    uploaders; every slice's sub-aggregate (int8: its stored blob) equal,
    bit for bit, to the plain version over the slice's own rows, weights
    and clamped trim; every update block one of those; the committed
    model equal to the old one plus the plain reduction of the S stored
    blocks (exact on f32, within one quantization step on int8);
    hier_logs' peak below the flat stack's bytes; and the launches: on
    int8 chains exactly S fused_agg launches a round before the packer
    (the quantize_out form) and one after it."""
    import torch

    from repro_torch.core.aggregation import (
        apply_update, flatten_updates, normalize_weights,
    )
    from repro_torch.fl.pipeline import resolve
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.fused_agg import fused_agg_ref, reduce_rows
    from repro_torch.tree import ravel_pytree

    cfg, S, inner_name = TIERED_PATHS[path]
    quantized = cfg.get("quantize_chain", False)
    method = cfg.get("aggregation", "fedavg")
    rounds = 2
    inner = resolve("validator", inner_name)
    packer = resolve("packer", "hier")
    slices, tier1, committees = [], [], []

    class SpyInner:
        def prepare(self, ctx):
            inner.prepare(ctx)

        def __call__(self, ctx):
            inner(ctx)
            slices.append({
                "round": ctx.round, "updates": dict(ctx.updates),
                "records": [(r.uploader, r.median_score, r.accepted)
                            for r in ctx.consensus.records]})

    def spy_packer(ctx):
        st = ctx.hier
        tier1.append({"round": ctx.round, "fused_agg": launch_counts()["fused_agg"],
                      "subs": list(st.sub_aggregates), "blobs": list(st.sub_blobs),
                      "contributors": [list(c) for c in st.sub_contributors],
                      "uploaders": list(st.sub_uploaders)})
        packer(ctx)

    def replay_slices(rt):
        ks, worst = [], 0.0
        for t, tr in enumerate(tier1):
            mine = [s for s in slices if s["round"] == t]
            check(len(mine) == S == len(tr["subs"]),
                  f"{path}: round {t} ran {len(mine)} slices, packed "
                  f"{len(tr['subs'])}, want {S}")
            for i, sl in enumerate(mine):
                ids, medians = _slice_ids(sl["records"])
                check(ids == tr["contributors"][i],
                      f"{path}: round {t} slice {i} aggregated "
                      f"{tr['contributors'][i]}, want {ids}")
                K = len(ids)
                ks.append(K)
                trim = min(rt.cfg.trim, (K - 1) // 2)
                w = normalize_weights(K, medians if rt.cfg.weight_by_score
                                      else None, "cuda").cpu()
                stack, _ = flatten_updates([sl["updates"][u] for u in ids])
                stack = stack.cpu()
                if quantized:
                    q, s = plain_quantized_rows(stack)
                    pq, ps = fused_agg_ref(q, s, w, method, trim, quantize_out=True)
                    blob = tr["blobs"][i]
                    exact = (torch.equal(blob["q"].cpu(), pq)
                             and same_bits(blob["scales"], ps))
                    err = max_err((blob["q"], blob["scales"]), (pq, ps))
                else:
                    plain = reduce_rows(stack, w, method, trim)
                    got = ravel_pytree(tr["subs"][i])[0]
                    exact = same_bits(got, plain)
                    err = max_err(got, plain)
                worst = max(worst, err)
                check(exact, f"{path}: round {t} slice {i} (K={K}, trim "
                             f"{trim}) differs from the plain version by {err}")
        return ks, worst

    def readback_tiered(rt, t):
        """The chain's update blocks of round t are slice blobs, and the
        committed model is the old one plus their plain reduction."""
        tr = tier1[t]
        blocks = rt.chain.updates_at_round(t)
        for b in blocks:
            i = tr["uploaders"].index(b.uploader)
            stored = rt.chain.raw_payload(b)
            check((torch.equal(stored["q"], tr["blobs"][i]["q"])
                   and torch.equal(stored["scales"], tr["blobs"][i]["scales"]))
                  if quantized else
                  torch.equal(ravel_pytree(stored)[0],
                              ravel_pytree(tr["subs"][i])[0]),
                  f"{path}: round {t} block {b.index} is not slice {i}'s")
        scores = [b.score for b in blocks]
        w = normalize_weights(S, scores if rt.cfg.weight_by_score else None,
                              "cuda").cpu()
        old = rt.chain.model_at_round(t)
        flat_old, unravel = ravel_pytree(old)
        if quantized:
            blobs = [rt.chain.raw_payload(b) for b in blocks]
            q = torch.stack([b["q"] for b in blobs]).cpu()
            s = torch.stack([b["scales"] for b in blobs]).cpu()
            d = blobs[0]["d"]
            agg = fused_agg_ref(q, s, w, method, rt.cfg.trim)[:d]
            # one quantization step a lane: the largest scale of its tile
            # over the blocks that hold a nonzero q there
            live = q.view(S, s.shape[1], -1).ne(0).any(dim=2)
            step = torch.where(live, s, torch.zeros_like(s)).amax(dim=0)
            step = step.repeat_interleave(q.shape[1] // s.shape[1])[:d]
        else:
            stack, _ = flatten_updates(rt.chain.update_payloads_at_round(t))
            agg = reduce_rows(stack.cpu(), w, method, rt.cfg.trim)
            step = torch.zeros_like(agg)
        replay = ravel_pytree(apply_update(old, unravel(agg.to(flat_old.device))))[0]
        new = ravel_pytree(rt.chain.model_at_round(t + 1))[0]
        check(bool(torch.isfinite(new).all()), f"{path}: committed params finite")
        diff = (replay - new).abs().cpu()
        exact = same_bits(replay, new)
        emit(phase="replay", path=path, round=t, rows=len(blocks), exact=exact,
             max_abs_err=float(diff.max()), quantization_step=float(step.max()))
        check(exact if not quantized else bool((diff <= step).all()),
              f"{path}: committed model off the plain replay by "
              f"{float(diff.max())}")

    def drive():
        t0 = time.perf_counter()
        rt = build(ds, cfg, stages={"validator": SpyInner(),
                                    "packer": spy_packer}, tiers=S)
        emit(phase="round_setup", path=path, seconds=time.perf_counter() - t0,
             tiers=S, q_committee=rt.q_committee, dim=rt._dim)
        for _ in range(rounds):
            committees.append([i for i in rt.committee if i in rt.manager.nodes])
            run_rounds(path, rt, 1)
        verified = rt.chain.verify()
        emit(phase="verify", path=path, ok=verified, height=rt.chain.height)
        check(verified, f"{path}: chain.verify()")
        check(rt.chain.height == 1 + rounds * (S + 2), f"{path}: chain height")
        for t in range(rounds):
            rec = rt.chain.committee_at_round(t)
            check(rec["members"].tolist() == committees[t],
                  f"{path}: round {t} committee block members")
            check(len(rec["uploaders"]) == S, f"{path}: round {t} uploaders")
        ks, worst = replay_slices(rt)
        emit(phase="slices", path=path, k=ks, max_abs_err=worst,
             slice_sizes=[len(s["records"]) for s in slices])
        for t in range(rounds):
            readback_tiered(rt, t)
        for log in rt.hier_logs:
            emit(phase="hier_log", path=path, **log)
            check(log["peak_stack_bytes"] < log["flat_stack_bytes"],
                  f"{path}: peak stack bytes {log['peak_stack_bytes']} not "
                  f"below flat {log['flat_stack_bytes']}")
        if method == "cwmed" and quantized:
            check(max(ks) > 32, f"{path}: no slice above 32 rows ({ks}); the "
                                f"column sort did not run")
        return rt

    n = rounds * S
    need = {"trimmed_mean": rounds * (S + 1)} if not quantized else {
        "quantize_stack": n, "fused_agg": rounds * (S + 1), "dequantize": n}
    if inner_name == "committee_int8":
        need["fused_candidates"] = n
    counts, rt = counted(path, drive, need)
    for name, want in need.items():
        check(counts[name] == want, f"{path}: {name} launched {counts[name]} "
                                    f"times, want exactly {want}")
    if quantized:
        at_pack = [tr["fused_agg"] for tr in tier1]
        check(at_pack == [t * (S + 1) + S for t in range(rounds)],
              f"{path}: fused_agg launches at each packer {at_pack}: want S "
              f"quantize_out launches a round and one final aggregation")
    time_slice_kernel(path, quantized, method, rt.cfg.trim, slices, tier1)
    return counts, rt


def time_slice_kernel(path, quantized, method, trim, slices, tier1):
    """Time the tier-1 kernel of a tiered path on the rows of its largest
    slice (after the counted run: these launches count nowhere), beside
    its bound; ``launches`` is how many slices of the path ran it in the
    same form (for the fused sorts: the K > 32 column form or a network)."""
    from repro_torch.core.aggregation import flatten_updates, normalize_weights
    from repro_torch.kernels.cwmed import trimmed_mean_kernel
    from repro_torch.kernels.fused_agg import fused_agg_kernel

    contributors = [c for tr in tier1 for c in tr["contributors"]]
    ks = [len(c) for c in contributors]
    i = max(range(len(ks)), key=ks.__getitem__)
    K = ks[i]
    stack, _ = flatten_updates([slices[i]["updates"][u] for u in contributors[i]])
    trim_k = min(trim, (K - 1) // 2)
    f32, i8 = 4, 1
    launches = len(ks)
    if quantized:
        q, s = (t.cuda() for t in plain_quantized_rows(stack))
        w = normalize_weights(K, None, "cuda")
        Dpad, nblk = q.shape[1], s.shape[1]
        column = method != "fedavg" and K > 32
        form = f"{method} quantize_out" + (" column sort" if column else "")
        if method != "fedavg":      # slices that ran the same sort design
            launches = sum((k > 32) == column for k in ks)
        fn = functools.partial(fused_agg_kernel, q, s, w, method=method,
                               trim=trim_k, quantize_out=True)
        sort_ops = {"fedavg": 4 * K, "cwmed": 2 * K + K * (K - 1) // 2 + 2,
                    "trimmed_mean": 2 * K + K * (K - 1) // 2 + K - 1}[method]
        b_ms, b_by = bound_ms(K * Dpad * i8 + K * nblk * f32 + K * f32
                              + Dpad * i8 + nblk * f32, (sort_ops + 6) * Dpad)
        name, shape = "fused_agg", [K, Dpad]
    else:
        x = stack.contiguous()
        D = x.shape[1]
        fn = functools.partial(trimmed_mean_kernel, x, trim=trim_k)
        form = f"trimmed_mean trim {trim_k}"
        b_ms, b_by = bound_ms(K * D * f32 + D * f32,
                              K * (K - 1) // 2 * D + (K - 1) * D)
        name, shape = "trimmed_mean", [K, D]
    ms = time_ms(fn, iters=5, reps=4)
    emit(phase="kernel_path", path=path, name=name, form=form, shape=shape,
         slice_ks=ks, launches=launches, ms=ms, bound_ms=b_ms, bound_by=b_by,
         launches_x_gap_ms=launches * (ms - b_ms))


# the async paths: path -> (config, tiers, inner / flat validator, launches
# each schedule must make in ROUNDS_ASYNC rounds, exactly)
ROUNDS_ASYNC = 2
ASYNC_PATHS = {
    "async_int8": ({"quantize_chain": True, "use_kernels": True}, None, None,
                   {"quantize_stack": ROUNDS_ASYNC, "fused_agg": ROUNDS_ASYNC}),
    "async_tiered_int8": (TIERED_PATHS["tiered_int8"][0], 2, "committee_int8",
                          {"quantize_stack": 2 * ROUNDS_ASYNC,
                           "fused_candidates": 2 * ROUNDS_ASYNC,
                           "fused_agg": 3 * ROUNDS_ASYNC,
                           "dequantize": 2 * ROUNDS_ASYNC}),
}


class SyncWatch:
    """Forwards a round stage (and its ``prepare`` / ``dispatch`` /
    ``finalize`` halves), counting the implicit host-device syncs each call
    makes under ``torch.cuda.set_sync_debug_mode("warn")``: blocking copies
    and reads of device values.  An event's wait is explicit and not
    counted."""

    def __init__(self, stage, name: str, log: list):
        self._stage, self._name, self._log = stage, name, log

    def __getattr__(self, attr):
        value = getattr(self._stage, attr)
        if attr in ("prepare", "dispatch", "finalize"):
            return functools.partial(self._watched, value, f"{self._name}.{attr}")
        return value

    def __call__(self, ctx):
        self._watched(self._stage, self._name, ctx)

    def _watched(self, fn, key, ctx):
        import warnings

        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn(ctx)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        self._log.append((f"{key}[{ctx.cohort}]", len(sites), sites))


def chains_equal(a, b) -> dict:
    """Where two runtimes' chains differ: block headers and hashes, and the
    payload leaves bit for bit (committee blocks by their arrays)."""
    import torch

    from repro_torch.tree import tree_leaves

    diff = {"blocks": 0, "leaves": 0, "max_abs_err": 0.0}
    if a.chain.height != b.chain.height:
        diff["blocks"] = abs(a.chain.height - b.chain.height)
    for ba, bb in zip(a.chain.blocks, b.chain.blocks):
        head = ((ba.kind, ba.round, ba.uploader, ba.score, ba.hash)
                == (bb.kind, bb.round, bb.uploader, bb.score, bb.hash))
        diff["blocks"] += not head
        la = tree_leaves(a.chain.raw_payload(ba))
        lb = tree_leaves(b.chain.raw_payload(bb))
        for x, y in zip(la, lb):
            x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
            if (x.dtype, x.shape) != (y.dtype, y.shape):
                diff["leaves"] += 1
            elif x.numpy().tobytes() != y.numpy().tobytes():
                diff["leaves"] += 1
                diff["max_abs_err"] = max(diff["max_abs_err"], float(
                    (x.double() - y.double()).abs().max()))
    return diff


def path_async(ds, path: str):
    """The async schedule (``schedule="async"``) at full width against its
    sequential twin: the same config, seed and initial params, round t of
    each run in turns (the twin first in even rounds, the async runtime
    first in odd ones), each round timed on the host clock to a device
    synchronize.  Both twins' samplers, trainers and validators run under
    SyncWatch, so the timed rounds carry the same instrumentation.  Checked:
    RoundLogs, committees and hier_logs equal; both chains pass verify() and
    are equal block for block, every payload leaf bit for bit; the final
    params bit for bit; each schedule's launch counts equal to the twin's
    and to the path's exact counts; no implicit sync in any cohort stage of
    the async runtime; on the tiered path, train_dispatch[1] before
    validate_finalize[0] in every round (the ``order`` line).  Returns both
    runtimes, the twin first."""
    import torch

    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.pipeline import RoundContext
    from repro_torch.kernels import launch_counts
    from repro_torch.tree import tree_leaves

    cfg, tiers, validator, exact = ASYNC_PATHS[path]
    stages = {"validator": validator} if validator else None
    init = femnist_adapter(width=32).init(torch.Generator().manual_seed(0))
    syncs, orders = {"sequential": [], "async": []}, []

    def drive():
        # the watch must see a known sync: a blocking copy to the host
        probe = []
        SyncWatch(lambda ctx: torch.ones(1, device="cuda").cpu(), "probe",
                  probe)(RoundContext(cfg=None, rng=None, adapter=None,
                                      data=None, params=None, round=0))
        check(probe[0][1] == 1, f"SyncWatch counted {probe[0][1]} syncs in "
                                f"one blocking copy")
        rts, launches, committees = {}, {}, {}
        for schedule in ("sequential", "async"):
            rts[schedule] = build(ds, cfg, stages=stages, tiers=tiers,
                                  schedule=schedule, initial_params=init)
            launches[schedule] = dict.fromkeys(launch_counts(), 0)
            committees[schedule] = []
        # both twins run watched, so the timed rounds compare like with like
        for schedule, rt in rts.items():
            for kind in ("sampler", "local_trainer", "validator"):
                stage = getattr(rt.pipeline, kind)
                setattr(rt.pipeline, kind,
                        SyncWatch(stage, kind, syncs[schedule]))
        pipe = rts["async"].pipeline
        for t in range(ROUNDS_ASYNC):
            turn = ("sequential", "async") if t % 2 == 0 else ("async", "sequential")
            seconds = {}
            for schedule in turn:
                rt = rts[schedule]
                before = launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                log = rt.run_round()
                torch.cuda.synchronize()
                seconds[schedule] = time.perf_counter() - t0
                after = launch_counts()
                for k in after:
                    launches[schedule][k] += after[k] - before[k]
                committees[schedule].append(list(rt.committee))
                emit(phase="round", path=path, schedule=schedule, round=t,
                     seconds=seconds[schedule], timings=rt.stage_timings[-1],
                     log=log.__dict__)
            orders.append(list(pipe.last_order))
            emit(phase="round_pair", path=path, round=t, first=turn[0],
                 sequential_s=seconds["sequential"], async_s=seconds["async"],
                 async_over_sequential=seconds["async"] / seconds["sequential"])
        seq, asy = rts["sequential"], rts["async"]
        emit(phase="order", path=path, rounds=orders)
        diff = chains_equal(seq, asy)
        params_equal = all(same_bits(x, y) for x, y in zip(
            tree_leaves(seq.global_params()), tree_leaves(asy.global_params())))
        verified = (seq.chain.verify(), asy.chain.verify())
        per_stage = {schedule: {} for schedule in syncs}
        for schedule, log in syncs.items():
            for key, n, _ in log:
                stage = key.split("[")[0]
                per_stage[schedule][stage] = per_stage[schedule].get(stage, 0) + n
        emit(phase="async_twin", path=path, logs_equal=seq.logs == asy.logs,
             committees_equal=committees["sequential"] == committees["async"],
             hier_logs_equal=seq.hier_logs == asy.hier_logs, verify=verified,
             chain_diff=diff, params_equal=params_equal,
             launches={s: {k: v for k, v in launches[s].items() if v}
                       for s in launches},
             implicit_syncs=per_stage)
        check(seq.logs == asy.logs, f"{path}: RoundLogs differ from the twin's")
        check(committees["sequential"] == committees["async"],
              f"{path}: committees differ from the twin's")
        check(seq.hier_logs == asy.hier_logs, f"{path}: hier_logs differ")
        check(all(verified), f"{path}: chain.verify()")
        check(diff == {"blocks": 0, "leaves": 0, "max_abs_err": 0.0},
              f"{path}: chains differ from the twin's: {diff}")
        check(params_equal, f"{path}: final params differ from the twin's")
        check(launches["sequential"] == launches["async"],
              f"{path}: launches {launches['async']} differ from the twin's "
              f"{launches['sequential']}")
        for name, want in exact.items():
            check(launches["async"][name] == want,
                  f"{path}: {name} launched {launches['async'][name]} times, "
                  f"want exactly {want}")
        check(not any(n for _, n, _ in syncs["async"]),
              f"{path}: implicit syncs in the async cohort stages: "
              f"{[kn for kn in syncs['async'] if kn[1]]}")
        if tiers:
            for t, order in enumerate(orders):
                check(order.index("train_dispatch[1]")
                      < order.index("validate_finalize[0]"),
                      f"{path}: round {t} finalized slice 0 before "
                      f"dispatching slice 1's training: {order}")
        return seq, asy

    return counted(path, drive, {k: 2 * v for k, v in exact.items()})


# the sharded paths (build_runtime(..., mesh=make_round_mesh(n))) on the
# int8 config: world 1 under NCCL in this process, each against its flat
# twin; world 2 under gloo in two spawned ranks that share the card (NCCL
# refuses two ranks on one GPU)
ROUNDS_SHARDED = 2
INT8_CFG = {"quantize_chain": True, "use_kernels": True}
SHARDED_W1 = {"sharded_int8": None,
              "sharded_int8_committee": "committee_int8_sharded"}
# world-2 path -> (validator, schedule); sharded_int8 is the async one's
# sequential twin
SHARDED_W2 = {"sharded_int8_committee": ("committee_int8_sharded",
                                         "sequential"),
              "sharded_int8": (None, "sequential"),
              "sharded_async_int8": (None, "async")}


def chain_digests(chain) -> list:
    """SHA-256 a block of its hash and its raw payload's leaves (dtype,
    shape, bytes): equal lists, chains equal bit for bit."""
    import hashlib

    import torch

    from repro_torch.tree import tree_paths

    out = []
    for b in chain.blocks:
        h = hashlib.sha256(b.hash.encode())
        for path, leaf in tree_paths(chain.raw_payload(b)):
            a = torch.as_tensor(leaf).cpu()
            h.update(f"{path}|{a.dtype}|{tuple(a.shape)}".encode())
            h.update(a.contiguous().reshape(-1).view(torch.uint8).numpy()
                     .tobytes())
        out.append(h.hexdigest())
    return out


def int8_replay(rt, t: int):
    """Round t's committed model against the old model plus the plain
    fused fedavg of the round's blobs as stored on the chain: (bit for
    bit, the blobs' width)."""
    import torch

    from repro_torch.core.aggregation import apply_update, normalize_weights
    from repro_torch.kernels.fused_agg import fused_agg_ref
    from repro_torch.tree import ravel_pytree

    blocks = rt.chain.updates_at_round(t)
    blobs = rt.chain.update_payloads_at_round(t, decode=False)
    q = torch.stack([b["q"] for b in blobs]).cpu()
    s = torch.stack([b["scales"] for b in blobs]).cpu()
    w = normalize_weights(len(blocks), [b.score for b in blocks], rt.device)
    plain = fused_agg_ref(q, s, w.cpu(), "fedavg")
    old = rt.chain.model_at_round(t)
    flat_old, unravel = ravel_pytree(old)
    agg = plain[:blobs[0]["d"]].to(flat_old.device)
    replay = ravel_pytree(apply_update(old, unravel(agg)))[0]
    new = ravel_pytree(rt.chain.model_at_round(t + 1))[0]
    return same_bits(replay, new), int(q.shape[1])


def round_products(rt) -> dict:
    """Each round's packed uploader ids, stored blobs' q and committed
    model (on the host), to compare runtimes across processes."""
    import torch

    from repro_torch.tree import ravel_pytree

    rounds = range(len(rt.logs))
    return {"packed": [[b.uploader for b in rt.chain.updates_at_round(t)]
                       for t in rounds],
            "q": [torch.stack([b["q"] for b in rt.chain.update_payloads_at_round(
                t, decode=False)]).cpu() for t in rounds],
            "models": [ravel_pytree(rt.chain.model_at_round(t + 1))[0].cpu()
                       for t in rounds]}


def sharded_init():
    """The sharded paths' initial params (numpy, so a spawned rank gets
    them by value): the port's init from seed 0."""
    import torch

    from repro_torch.convert import to_numpy_tree
    from repro_torch.fl.adapter import femnist_adapter

    return to_numpy_tree(femnist_adapter(width=32).init(
        torch.Generator().manual_seed(0)))


def path_sharded_world1(ds, init) -> dict:
    """(a) World 1 under NCCL, in this process (the group from a FileStore):
    sharded_int8 and sharded_int8_committee, 2 rounds each, each after its
    flat twin (no mesh; committee_int8 for committee_int8_sharded) from the
    same seed and init.  Checked: RoundLogs, committees, every chain block
    (headers, hashes, payload leaves bit for bit: the packed ids and
    blobs), the params bit for bit, verify() and the int8 read-back on
    both, launch counts equal to the twin's.  The group is destroyed after.
    Returns path -> counts (twins under ``<path>_twin``) and the world-1
    committee path's logs and params for (b)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_round_mesh
    from repro_torch.tree import tree_leaves

    out, rts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_round_mesh(1, device="cuda:0")
            emit(phase="mesh", path="sharded_world1", mesh=repr(mesh))
            for path, validator in SHARDED_W1.items():
                committees = {}
                for name, m, v in ((f"{path}_twin", None,
                                    validator and validator.replace(
                                        "_sharded", "")),
                                   (path, mesh, validator)):
                    def drive(name=name, m=m, v=v):
                        rt = build(ds, INT8_CFG,
                                   stages={"validator": v} if v else None,
                                   mesh=m, initial_params=init)
                        committees[name] = []
                        for _ in range(ROUNDS_SHARDED):
                            run_rounds(name, rt, 1)
                            committees[name].append(list(rt.committee))
                        verify(name, rt, ROUNDS_SHARDED)
                        readback(name, rt, ROUNDS_SHARDED)
                        return rt

                    out[name], rts[name] = counted(
                        name, drive, {"quantize_stack": ROUNDS_SHARDED,
                                      "fused_agg": ROUNDS_SHARDED})
                twin, sh = rts[f"{path}_twin"], rts[path]
                diff = chains_equal(twin, sh)
                params_equal = all(same_bits(x, y) for x, y in zip(
                    tree_leaves(twin.global_params()),
                    tree_leaves(sh.global_params())))
                emit(phase="sharded_twin", path=path, world=1, backend="nccl",
                     logs_equal=twin.logs == sh.logs,
                     committees_equal=(committees[f"{path}_twin"]
                                       == committees[path]),
                     chain_diff=diff, params_equal=params_equal,
                     launches={n: {k: v for k, v in out[n].items() if v}
                               for n in (f"{path}_twin", path)})
                check(twin.logs == sh.logs, f"{path}: RoundLogs differ")
                check(committees[f"{path}_twin"] == committees[path],
                      f"{path}: committees differ")
                check(diff == {"blocks": 0, "leaves": 0, "max_abs_err": 0.0},
                      f"{path}: chain differs from the flat twin's: {diff}")
                check(params_equal, f"{path}: params differ from the twin's")
                check(out[f"{path}_twin"] == out[path],
                      f"{path}: launches {out[path]} differ from the twin's "
                      f"{out[f'{path}_twin']}")
        finally:
            dist.destroy_process_group()
    w1 = rts["sharded_int8_committee"]
    return out, {"logs": w1.logs, **round_products(w1)}


class ShardSpies:
    """Wraps a runtime's sharded programs, its packer and the int8
    scorer's candidate builder, and keeps each call's rank-local inputs
    and outputs; ``settle()``, run after a timed round, holds them against
    the plain versions on CPU copies of the same inputs, bit for bit:
    quantize_stack (#2) on the packer's D-slice and on the int8 scorer's
    P-block, fused_candidates (#5) on that P-block, fused_agg (#4) on the
    aggregator's D-slice; and the packer's gathered blobs (the sharded
    width) against one quantize of the whole packed stack.  Inside a
    round the spies only keep references, so the round's time is the
    engine's.  ``train_in`` keeps the first training call's inputs and
    block for ``train_witness``.  ``remove()`` restores the candidate
    builder."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.calls = dict.fromkeys(("quantize_dslice", "quantize_pblock",
                                    "candidates_pblock", "fused_agg_dslice",
                                    "packed_stack"), 0)
        self.last = {}
        self.pending = []
        self.train_in = None
        self._candidates_orig = None

    def install(self, rt) -> None:
        from repro_torch.fl import client

        if rt._sharded_quantize is not None:
            rt._sharded_quantize = self._quantize(rt._sharded_quantize)
            rt._sharded_agg = self._aggregate(rt._sharded_agg)
            rt._sharded_int8_score = self._int8_score(rt._sharded_int8_score)
        rt._sharded_train = self._train(rt._sharded_train)
        rt.pipeline.packer = self._packer(rt.pipeline.packer)
        # the int8 scorer looks its candidate builder up in its module
        self._candidates_orig = client.candidates_from_quantized
        client.candidates_from_quantized = self._candidates(
            self._candidates_orig)

    def remove(self) -> None:
        from repro_torch.fl import client

        if self._candidates_orig is not None:
            client.candidates_from_quantized = self._candidates_orig

    def settle(self) -> None:
        for name, held in self.pending:
            held()
            self.calls[name] += 1
        self.pending.clear()

    def _train(self, fn):
        def run(params, xs, ys):
            block = fn(params, xs, ys)
            if self.train_in is None:
                self.train_in = (params, xs, ys, block)
            return block

        return run

    def _quantize(self, fn):
        import torch.nn.functional as F

        from repro_torch.kernels.ops import padded_dim_sharded
        from repro_torch.kernels.quantize import quantize_stack_ref

        def run(stack):
            q, s = fn(stack)

            def held():
                d = stack.shape[1]
                padded = F.pad(stack, (0, padded_dim_sharded(
                    d, self.mesh.size) - d))
                pq, ps = quantize_stack_ref(self.mesh.shard(padded, 1).cpu())
                check(q.cpu().equal(pq) and same_bits(s, ps),
                      "quantize_stack on a D-slice differs from the plain "
                      "version")

            self.pending.append(("quantize_dslice", held))
            self.last["stack"] = stack
            return q, s

        return run

    def _aggregate(self, fn):
        from repro_torch.kernels.fused_agg import fused_agg_ref

        def run(q, s, w):
            out = fn(q, s, w)

            def held():
                plain = fused_agg_ref(self.mesh.shard(q, 1).cpu(),
                                      self.mesh.shard(s, 1).cpu(), w.cpu())
                check(same_bits(out, plain),
                      "fused_agg on a D-slice differs from the plain version")

            self.pending.append(("fused_agg_dslice", held))
            self.last.update(q=q, s=s, w=w)
            return out

        return run

    def _int8_score(self, fn):
        from repro_torch.fl.client import flatten_stacked_updates
        from repro_torch.kernels.ops import _pad_to_block
        from repro_torch.kernels.quantize import quantize_stack_ref

        def run(params, block, vx, vy):
            scores, q, s = fn(params, block, vx, vy)

            def held():
                pq, ps = quantize_stack_ref(
                    _pad_to_block(flatten_stacked_updates(block))[0].cpu())
                check(q.cpu().equal(pq) and same_bits(s, ps),
                      "quantize_stack on a P-block differs from the plain "
                      "version")

            self.pending.append(("quantize_pblock", held))
            return scores, q, s

        return run

    def _candidates(self, fn):
        import torch

        from repro_torch.kernels.fused_score import fused_candidates_ref
        from repro_torch.kernels.ops import _pad_to_block

        def run(base, q, s, D=None):
            out = fn(base, q, s, D)

            def held():
                padded = _pad_to_block(base.to(torch.float32))[0].cpu()
                plain = fused_candidates_ref(padded, q.cpu(), s.cpu())
                check(same_bits(out, plain[:, :out.shape[1]]),
                      f"fused_candidates on a P-block {tuple(q.shape)} "
                      f"differs from the plain version")

            self.pending.append(("candidates_pblock", held))
            return out

        return run

    def _packer(self, packer):
        import torch.nn.functional as F

        from repro_torch.core.aggregation import flatten_updates
        from repro_torch.kernels.ops import padded_dim_sharded
        from repro_torch.kernels.quantize import quantize_stack_ref

        def run(ctx):
            packer(ctx)
            q, s, d, _ = ctx.packed_quantized
            packed = ctx.packed_updates

            def held():
                width = padded_dim_sharded(d, self.mesh.size)
                stack, _ = flatten_updates(packed)
                pq, ps = quantize_stack_ref(F.pad(stack, (0, width - d)).cpu())
                check(q.shape[1] == width, f"blobs {q.shape[1]} lanes wide, "
                                           f"want {width}")
                check(q.cpu().equal(pq) and same_bits(s, ps),
                      "packed blobs differ from one quantize of the whole "
                      "stack")

            self.pending.append(("packed_stack", held))

        return run


def train_witness(rt, mesh, train_in) -> dict:
    """Round 0's local training on the card three ways, from the inputs
    the sharded trainer got: its block (the rank's 27 clients), the
    single-device program on those 27 clients' batches, and the same
    program on all 54 clients (world 1's and the flat round's program),
    cut to the rank's rows.  All three must be equal bit for bit: the
    sharded program is the 27-client program, and a client's update does
    not depend on how many clients share the trainer's call, which world
    2 against world 1 turns on."""
    from repro_torch.device import to_device
    from repro_torch.fl.client import flatten_stacked_updates
    from repro_torch.launch.shardings import round_engine_pspecs

    params, xs, ys, block = train_in
    split = round_engine_pspecs()["clients"]

    def train(x, y):
        return flatten_stacked_updates(rt._local_train(
            params, to_device(x, mesh.device), to_device(y, mesh.device)))

    sharded = flatten_stacked_updates(block)
    half = train(mesh.shard(xs, split), mesh.shard(ys, split))
    full = mesh.shard(train(xs, ys), split)
    rows = (full != half).any(dim=1)
    out = {"clients": int(xs.shape[0]), "rank_clients": int(half.shape[0]),
           "sharded_equals_rank_program": same_bits(sharded, half),
           "rank_program_equals_full_rows": same_bits(full, half),
           "rows_differing": int(rows.sum()),
           "max_abs_diff": float((full - half).abs().max())}
    check(out["sharded_equals_rank_program"],
          f"rank {mesh.rank}: the sharded trainer's block differs from the "
          f"single-device program on the rank's clients")
    check(out["rank_program_equals_full_rows"],
          f"rank {mesh.rank}: {out['rows_differing']} rows of the "
          f"{out['rank_clients']}-client call differ from the "
          f"{out['clients']}-client call's, by up to {out['max_abs_diff']}")
    return out


def time_shard_kernels(mesh, last, launches: dict) -> list:
    """#2 and #4 on this rank's slice of the last round's packed stack, by
    CUDA events; the ranks take turns (a barrier between), so the other
    rank's process shares the card but waits.  ``launches``: this rank's
    D-slice launches of each over the world-2 paths."""
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch.kernels.fused_agg import fused_agg_kernel
    from repro_torch.kernels.ops import padded_dim_sharded
    from repro_torch.kernels.quantize import quantize_stack_kernel
    from repro_torch.kernels.tiling import BLOCK_D

    stack = last["stack"]
    d = stack.shape[1]
    padded = F.pad(stack, (0, padded_dim_sharded(d, mesh.size) - d))
    x = mesh.shard(padded, 1).contiguous()
    q = mesh.shard(last["q"], 1).contiguous()
    s = mesh.shard(last["s"], 1).contiguous()
    w = last["w"]
    K, Dpad = q.shape
    nblk = Dpad // BLOCK_D
    f32, i8 = 4, 1
    lines = []
    for turn in range(mesh.size):
        if turn == mesh.rank:
            for name, fn, nbytes, ops_ in (
                    ("quantize_stack", lambda: quantize_stack_kernel(x),
                     K * (Dpad * f32 + Dpad * i8 + nblk * f32), 6 * K * Dpad),
                    ("fused_agg", lambda: fused_agg_kernel(q, s, w),
                     K * Dpad * i8 + K * nblk * f32 + K * f32 + Dpad * f32,
                     4 * K * Dpad)):
                b_ms, b_by = bound_ms(nbytes, ops_)
                lines.append(dict(name=name, rank=mesh.rank, shape=[K, Dpad],
                                  launches=launches[name], ms=time_ms(fn),
                                  bound_ms=b_ms, bound_by=b_by))
        dist.barrier()
    return lines


def sharded_rank(init) -> dict:
    """(b) One rank of world 2 on the one card (gloo, cuda:0), spawned by
    ``spawn_world``: the SHARDED_W2 paths, 2 rounds each, with the launch
    counts set to 0 before each and read after, ShardSpies on every
    sharded program (their checks run after each timed round), verify(),
    the committed model against the plain replay of the stored blobs;
    then the training witness on the committee path's round 0 and the
    shard-shape kernel times.  Returns host data only."""

    import torch

    from repro_torch.data.synthetic import make_femnist_like
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import padded_dim_sharded
    from repro_torch.launch.mesh import make_round_mesh
    from repro_torch.tree import ravel_pytree

    mesh = make_round_mesh(device="cuda:0")
    ds = make_femnist_like(seed=1)
    out = {"rank": mesh.rank, "mesh": repr(mesh), "paths": {}}
    last, dslices = None, {"quantize_stack": 0, "fused_agg": 0}
    for path, (validator, schedule) in SHARDED_W2.items():
        spies = ShardSpies(mesh)
        reset_launch_counts()
        rt = build(ds, INT8_CFG,
                   stages={"validator": validator} if validator else None,
                   mesh=mesh, schedule=schedule, initial_params=init)
        spies.install(rt)
        rounds, committees = [], []
        try:
            for _ in range(ROUNDS_SHARDED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                log = rt.run_round()
                torch.cuda.synchronize()
                rounds.append({"seconds": time.perf_counter() - t0,
                               "timings": rt.stage_timings[-1],
                               "log": dataclasses.asdict(log)})
                committees.append(list(rt.committee))
                spies.settle()
        finally:
            spies.remove()
        counts = launch_counts()
        exact, width = int8_replay(rt, ROUNDS_SHARDED - 1)
        d = rt.chain.codec.dim
        check(rt.chain.verify(), f"{path}: chain.verify() on rank {mesh.rank}")
        check(exact, f"{path}: committed model differs from the plain replay")
        check(width == padded_dim_sharded(d, mesh.size),
              f"{path}: blobs {width} lanes wide")
        held = spies.calls
        # one P-block a scored cohort: at least one a round on the int8
        # committee path, none elsewhere
        pblocks = held["candidates_pblock"]
        check(held["packed_stack"] == ROUNDS_SHARDED
              and held["fused_agg_dslice"] == ROUNDS_SHARDED
              and held["quantize_pblock"] == pblocks
              and (pblocks >= ROUNDS_SHARDED
                   if validator == "committee_int8_sharded" else pblocks == 0),
              f"{path}: spies saw {held}")
        # every launch of #2, #4 and #5 on the path was held
        check(counts["quantize_stack"] == (held["quantize_dslice"]
                                           + held["quantize_pblock"])
              and counts["fused_agg"] == held["fused_agg_dslice"]
              and counts["fused_candidates"] == pblocks,
              f"{path}: launches {counts} against the spies' {held}")
        if spies.last.get("stack") is not None:
            last = spies.last
        out["paths"][path] = {
            "launches": counts, "rounds": rounds, "committees": committees,
            "logs": [r["log"] for r in rounds], "digests": chain_digests(rt.chain),
            "params": ravel_pytree(rt.global_params())[0].cpu(),
            "spies": spies.calls, "replay_exact": exact, "width": width,
            "dim": d, **round_products(rt)}
        if path == "sharded_int8_committee":
            out["train_witness"] = train_witness(rt, mesh, spies.train_in)
        dslices["quantize_stack"] += spies.calls["quantize_dslice"]
        dslices["fused_agg"] += spies.calls["fused_agg_dslice"]
        del rt, spies
    check(last is not None, "no path quantized a D-slice")
    out["kernel_paths"] = time_shard_kernels(mesh, last, dslices)
    return out


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def path_sharded_world2(init, world1) -> dict:
    """(b) World 2 on the one card under gloo: two ranks spawned through
    ``repro_torch.hostdevices.spawn_world``, each on cuda:0 (NCCL refuses
    two ranks on one GPU).  Checked here, over the ranks' returns: every
    rank's chain equal to rank 0's bit for bit (with its logs and
    committees), the async path equal to its sequential twin bit for bit
    (chain, logs, committees, params); each rank checked its own slices,
    replay and widths (``sharded_rank``).  Prints the world-2 committee
    path against world 1's (``world1``).  An exclusive compute mode stops
    the script: two ranks cannot share the card then.  Returns path ->
    launch counts summed over the ranks."""

    import torch

    from repro_torch.hostdevices import spawn_world

    mode = compute_mode()
    emit(phase="compute_mode", mode=mode)
    check(mode == "Default", f"the card is in compute mode {mode!r}: two "
                             f"ranks cannot share it, so world 2 cannot run")
    ranks = spawn_world(2, sharded_rank, init, backend="gloo", timeout=900.0)
    out = {}
    for path in SHARDED_W2:
        res = [r["paths"][path] for r in ranks]
        for r in ranks:
            for t, rd in enumerate(r["paths"][path]["rounds"]):
                emit(phase="round", path=path, rank=r["rank"], round=t,
                     seconds=rd["seconds"], timings=rd["timings"],
                     log=rd["log"])
        counts = {k: sum(x["launches"][k] for x in res)
                  for k in res[0]["launches"]}
        emit(phase="launches", path=path, launches=counts,
             per_rank=[{k: v for k, v in x["launches"].items() if v}
                       for x in res], spies=[x["spies"] for x in res],
             width=res[0]["width"], dim=res[0]["dim"])
        for x in res[1:]:
            check(x["digests"] == res[0]["digests"],
                  f"{path}: rank chains differ")
            check(x["logs"] == res[0]["logs"]
                  and x["committees"] == res[0]["committees"],
                  f"{path}: rank logs or committees differ")
        check(counts["quantize_stack"] >= ROUNDS_SHARDED
              and counts["fused_agg"] >= ROUNDS_SHARDED,
              f"{path}: launches {counts}")
        out[path] = counts
    seq, asy = (ranks[0]["paths"][p] for p in ("sharded_int8",
                                               "sharded_async_int8"))
    twin = {"chain_equal": seq["digests"] == asy["digests"],
            "logs_equal": seq["logs"] == asy["logs"],
            "committees_equal": seq["committees"] == asy["committees"],
            "params_equal": same_bits(seq["params"], asy["params"])}
    emit(phase="async_twin", path="sharded_async_int8", world=2, **twin)
    check(all(twin.values()), f"sharded_async_int8 differs from its "
                              f"sequential twin: {twin}")
    w2 = ranks[0]["paths"]["sharded_int8_committee"]
    logs1 = [dataclasses.asdict(l) for l in world1["logs"]]
    for r in ranks:
        emit(phase="train_witness", path="sharded_int8_committee",
             rank=r["rank"], **r["train_witness"])
    rounds = [{"round": t, "log_equal": logs1[t] == w2["logs"][t],
               "packed_equal": world1["packed"][t] == w2["packed"][t],
               "blobs_equal": world1["packed"][t] == w2["packed"][t]
               and torch.equal(world1["q"][t], w2["q"][t]),
               "model_max_abs_diff": float(
                   (world1["models"][t] - w2["models"][t]).abs().max()),
               "model_equal": same_bits(world1["models"][t],
                                        w2["models"][t])}
              for t in range(ROUNDS_SHARDED)]
    emit(phase="world2_vs_world1", path="sharded_int8_committee",
         logs_equal=logs1 == w2["logs"], rounds=rounds)
    for rd in rounds:
        check(rd["log_equal"] and rd["packed_equal"] and rd["blobs_equal"]
              and rd["model_equal"], f"world 2 departs from world 1: {rd}")
    for r in ranks:
        for line in r["kernel_paths"]:
            emit(phase="kernel_path", path="sharded_world2", **line,
                 note="the other rank's process shares the card, waiting "
                      "at a barrier")
    return out


def path_baselines(ds) -> None:
    """The committee-free baselines at full width through
    build_runtime(..., baseline=True): Basic FL (fedavg) and CwMed, 2
    rounds each of 90 clients, then 20 steps of train_standalone.  Like the
    reference's, the baselines aggregate with the plain reductions, so no
    kernel but the local trainer's may launch.  Checked: finite params that
    moved from the init, test accuracies in [0, 1]."""
    import torch

    from repro_torch.api import build_runtime
    from repro_torch.fl import train_standalone
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tree import ravel_pytree

    def moved_and_finite(path, before, params):
        after = ravel_pytree(params)[0]
        check(bool(torch.isfinite(after).all()), f"{path}: params are finite")
        check(not torch.equal(before, after), f"{path}: params did not move")

    rounds = 2
    reset_launch_counts()
    for method in ("fedavg", "cwmed"):
        path = f"baseline_{method}"
        t0 = time.perf_counter()
        rt = build_runtime(femnist_adapter(width=32), ds,
                           {"aggregation": method, "seed": 0},
                           baseline=True, device="cuda")
        before = ravel_pytree(rt.params)[0].clone()
        emit(phase="round_setup", path=path, seconds=time.perf_counter() - t0)
        for _ in range(rounds):
            t0 = time.perf_counter()
            rt.run_round()
            torch.cuda.synchronize()
            emit(phase="round", path=path, seconds=time.perf_counter() - t0,
                 timings=rt.stage_timings[-1])
        moved_and_finite(path, before, rt.params)
        acc = rt.evaluate()
        emit(phase="evaluate", path=path, test_accuracy=acc)
        check(0.0 <= acc <= 1.0, f"{path}: test accuracy {acc}")
    adapter = femnist_adapter(width=32)
    before = ravel_pytree(adapter.init(torch.Generator().manual_seed(0)))[0]
    t0 = time.perf_counter()
    params, accs = train_standalone(adapter, ds, steps=20, eval_every=10,
                                    device="cuda")
    torch.cuda.synchronize()
    emit(phase="standalone", steps=20, seconds=time.perf_counter() - t0,
         test_accuracies=accs)
    moved_and_finite("standalone", before.cuda(), params)
    check(len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs),
          f"standalone: test accuracies {accs}")
    counts = launch_counts()
    emit(phase="launches", path="baselines", launches=counts)
    check(counts[TRAINER_KERNEL] > 0 and not any(
        n for k, n in counts.items() if k != TRAINER_KERNEL),
        "a baseline launched a kernel other than the trainer's")


# the serving path: olmo-1b at full width and depth, f32, served with the
# reference CLI's defaults (launch/serve.py), then hot-swapped mid-trace to
# the model block of one int8 round of K = 2 update deltas
SERVE_ARCH = "olmo-1b"
SERVE_SLOTS, SERVE_MAX_LEN = 4, 96
SERVE_TRACE = dict(num_requests=16, rate=20.0, prompt_lens=(16, 32, 48, 64),
                   gen_lens=(8, 16, 32), seed=0)
SERVE_K = 2
SERVE_SWAP_TICK = 24
SERVE_SCORES = (0.9, 0.7)          # the two uploaders' committee medians
# the card's f32 prefill logits against the CPU's float64 forward, relative
# to the largest logit: f32 rounding over sums of up to 8,192 products and
# 16 layers stays near 1e-6 of it; a fault in the GEMMs moves it by O(1)
SERVE_F64_RTOL = 1e-4
LANE_CHUNK = 1 << 25               # lanes a plain-version chunk at LM width


def timed_appends(chain, device) -> dict:
    """Wrap the chain's append methods with host timers (waiting for the
    device first): seconds spent in update-block and model-block appends,
    the payload's host copy and SHA-256 included."""
    from repro_torch.device import synchronize

    spent = {"append_update": 0.0, "append_model": 0.0}
    for name in spent:
        orig = getattr(chain, name)

        def timed(*args, _orig=orig, _name=name, **kw):
            synchronize(device)
            t0 = time.perf_counter()
            out = _orig(*args, **kw)
            spent[_name] += time.perf_counter() - t0
            return out

        setattr(chain, name, timed)
    return spent


def oracle_row(cfg, params, res, req, cache: dict):
    """The request's tokens alone in its own slot row of the engine's batch
    (the same-shape oracle; memoized per params version, prompt and row)."""
    from repro_torch.serve.engine import greedy_oracle

    key = (id(params), req.rid, res.slot, req.max_new)
    if key not in cache:
        cache[key] = greedy_oracle(cfg, params, req.prompt, req.max_new,
                                   max_len=SERVE_MAX_LEN, rows=SERVE_SLOTS,
                                   row=max(res.slot, 0))
    return cache[key]


def batch_invariance(cfg, params, trace, reports,
                     path: str = "serve_olmo_1b") -> None:
    """The reference's pin as it states it: every served request equals its
    batch-1 oracle token for token, under both policies.  Reported beside
    it: the logits request 0 decodes from at 1 row and at SERVE_SLOTS rows
    (row 0), which round differently (PERF.md §6), and their smallest
    top-2 margin."""
    import torch

    from repro_torch.serve.engine import greedy_oracle

    t0 = time.perf_counter()
    batch1 = {req.rid: greedy_oracle(cfg, params, req.prompt, req.max_new,
                                     max_len=SERVE_MAX_LEN) for req in trace}
    equal = {policy: sum(res.tokens == batch1[res.rid] for res in rep.results)
             for policy, rep in reports.items()}
    req = trace[0]
    logits = [greedy_oracle(cfg, params, req.prompt, req.max_new,
                            max_len=SERVE_MAX_LEN, rows=rows,
                            return_logits=True)[1]
              for rows in (1, SERVE_SLOTS)]
    diff = (logits[0] - logits[1]).abs()
    top2 = torch.topk(logits[0], 2, dim=-1).values
    emit(phase="batch_invariance", path=path,
         seconds=time.perf_counter() - t0, requests=len(trace),
         equal_batch1_oracle=equal, steps=len(diff),
         logits_max_abs_diff=float(diff.max()),
         logits_differing=int((diff > 0).sum()), logits=int(diff.numel()),
         min_top2_margin=float((top2[:, 0] - top2[:, 1]).min()))
    check(all(n == len(trace) for n in equal.values()),
          f"{path}: requests equal to the batch-1 oracle {equal}")


def full_width_reference(cfg, params, prompt,
                         path: str = "serve_olmo_1b") -> None:
    """An independent check of the card's full-width arithmetic: the prefill
    logits of one prompt (its last position, which the first token is the
    argmax of) against the same prefill on the CPU with float64 weights
    (its norms, RoPE and attention compute in float32, as the model does),
    within SERVE_F64_RTOL of the largest logit, with the same argmax."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import Batch
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    prefill = make_prefill_step(cfg, SERVE_MAX_LEN)
    S = len(prompt)
    outs = []
    for dev, tree in ((params["embed"].device, params),
                      ("cpu", tree_map(lambda t: t.to("cpu", torch.float64),
                                       params))):
        with torch.no_grad():
            outs.append(prefill(tree, Batch(
                tokens=torch.tensor(prompt[None], dtype=torch.int32,
                                    device=dev),
                positions=torch.arange(S, dtype=torch.int32,
                                       device=dev)[None]))[0][0, -1].cpu())
        del tree
    got, want = outs[0].double(), outs[1]
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    top1 = (int(got.argmax()), int(want.argmax()))
    top2 = torch.topk(want, 2).values
    emit(phase="full_width_reference", path=path, prompt_len=S,
         units=cfg.num_units,
         max_abs_err=err, max_abs_logit=scale, rtol=SERVE_F64_RTOL,
         top1=top1, top2_margin=float(top2[0] - top2[1]),
         seconds=time.perf_counter() - t0)
    check(err <= SERVE_F64_RTOL * scale and top1[0] == top1[1],
          f"{path}: prefill logits off the float64 CPU prefill by "
          f"{err} (max |logit| {scale}), argmax {top1}")


def commit_scored_round(chain, params, updates: dict, scores: dict, *,
                        round_t: int, device):
    """Commit one round of K already-scored updates ({uploader: update
    tree}, {uploader: committee median}) through the registered
    ``top_k_int8`` packer (one quantize_stack launch, K int8 update blocks)
    and ``fused_int8`` aggregator (the fused fedavg, then round
    ``round_t + 1``'s model block over ``params``), on a RoundContext built
    for them with a one-member committee.  Each stage is timed, waiting for
    the device, in ``ctx.timings["pack"]`` and ``["aggregate"]``."""
    import numpy as np
    import torch

    from repro_torch.core.consensus import CommitteeConsensus
    from repro_torch.core.node import Node, NodeManager
    from repro_torch.device import synchronize
    from repro_torch.fl.pipeline import RoundContext, resolve
    from repro_torch.fl.runtime import BFLCConfig

    manager = NodeManager(permission_fee=0.0)
    consensus = CommitteeConsensus([0])
    consensus.bind_score_table({u: {0: float(s)} for u, s in scores.items()})
    for u in updates:
        manager.join(Node(node_id=u, data_indices=np.zeros((0,), np.int64)))
        consensus.validate(u, u)
    ctx = RoundContext(
        cfg=BFLCConfig(k_updates=len(updates), quantize_chain=True,
                       use_kernels=True),
        rng=np.random.default_rng(round_t), adapter=None, data=None,
        params=params, round=round_t, device=torch.device(device),
        manager=manager, chain=chain, consensus=consensus,
        updates=dict(updates))
    for key, kind, name in (("pack", "packer", "top_k_int8"),
                            ("aggregate", "aggregator", "fused_int8")):
        t0 = time.perf_counter()
        resolve(kind, name)(ctx)
        synchronize(ctx.device)
        ctx.timings[key] = time.perf_counter() - t0
    return ctx


def served_without_syncs(engine, trace, timed,
                         path: str = "serve_olmo_1b") -> None:
    """One more (untimed) continuous run, on a VirtualClock, under
    ``torch.cuda.set_sync_debug_mode("warn")``: the engine's loop makes no
    implicit host-device sync (the token vectors come back through pinned
    copies whose events it waits on, which is explicit), and each request
    decodes the same tokens as in the timed run."""
    import warnings

    import torch

    from repro_torch.serve import VirtualClock

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rep = engine.run(trace, policy="continuous", clock=VirtualClock())
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    same = sum(a.tokens == b.tokens for a, b in zip(rep.results, timed.results))
    emit(phase="serve_syncs", path=path, implicit_syncs=len(sites),
         sites=sorted(set(sites)), ticks=rep.ticks,
         requests_equal_to_timed_run=same)
    check(not sites, f"{path}: implicit syncs in the engine at {sites}")
    check(same == len(trace), f"{path}: a request decoded other tokens on a "
                              f"VirtualClock than on the WallClock")


def decode_tick(cfg, params, path: str = "serve_olmo_1b") -> None:
    """One decode step at 1 row and at SERVE_SLOTS rows: the host's time to
    issue it, its CUDA-event time, and under torch.profiler the device's
    busy time in it (the union of its kernels' intervals) and its kernels
    by time.  Busy well under the event time means the host paces it.
    ``bytes_bound_ms``: every parameter read once (a dense MoE runs every
    expert on every row) at the card's memory rate."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models import init_cache
    from repro_torch.tree import tree_leaves

    step = make_decode_step(cfg, return_logits=False)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    reps = 10
    for rows in (1, SERVE_SLOTS):
        cache = init_cache(cfg, rows, SERVE_MAX_LEN, torch.float32, "cuda")
        tok = torch.zeros((rows, 1), dtype=torch.int32, device="cuda")
        pos = torch.full((rows,), 40, dtype=torch.int32, device="cuda")
        with torch.no_grad():
            step(params, tok, pos, cache)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                step(params, tok, pos, cache)
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3 / reps
            end.synchronize()
            event_ms = start.elapsed_time(end) / reps
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step(params, tok, pos, cache)
                torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation]
        busy_ms = sum(hi - lo for lo, hi in merged(
            (e.time_range.start, e.time_range.end) for e in device)) / 3e3
        by_name = {}
        for e in device:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        emit(phase="decode_tick", path=path, rows=rows,
             host_ms=host_ms, event_ms=event_ms, device_busy_ms=busy_ms,
             bytes_bound_ms=1e3 * param_bytes / HBM_BYTES_PER_S,
             busy_share=busy_ms / event_ms, kernels=len(device) / 3,
             top=[{"kernel": k[:100], "us": us / 3, "count": n / 3}
                  for k, (us, n) in top])


def plain_chunks(fn, *arrays, nblk_args=(), lanes: int = LANE_CHUNK):
    """Run a plain version over chunks of whole tiles of the lane axis (the
    last axis of each array; ``nblk_args`` indexes the arrays whose last
    axis counts tiles), yielding (lo, hi, result)."""
    from repro_torch.kernels.tiling import BLOCK_D

    n = arrays[0].shape[-1]
    for lo in range(0, n, lanes):
        hi = min(n, lo + lanes)
        args = [a[..., lo // BLOCK_D: -(-hi // BLOCK_D)] if i in nblk_args
                else a[..., lo:hi] for i, a in enumerate(arrays)]
        yield lo, hi, fn(*args)


def lm_kernel_lines(stack, q, s, w, counts) -> None:
    """quantize_stack, fused_agg fedavg and dequantize at the LM's width:
    each kernel against its plain version over chunks of lanes, its
    CUDA-event time (after the counted run: these launches count nowhere),
    the plain version's time over its chunks, and its bytes bound."""
    import torch

    from repro_torch.kernels.fused_agg import fused_agg_kernel, fused_agg_ref
    from repro_torch.kernels.quantize import (
        dequantize_kernel, dequantize_ref, quantize_stack_kernel,
        quantize_stack_ref,
    )
    from repro_torch.kernels.tiling import BLOCK_D

    K, Dpad = q.shape
    nblk = Dpad // BLOCK_D
    f32, i8 = 4, 1
    q0, s0 = q[0].contiguous(), s[0].contiguous()

    def worst(got, plain, *arrays, nblk_args=()):
        """max |got - plain| over lanes, chunk by chunk (q as ints); for a
        tuple result the scales are compared over their tiles."""
        err = 0.0
        for lo, hi, want in plain_chunks(plain, *arrays, nblk_args=nblk_args):
            pairs = ((got[0][..., lo:hi], want[0]),
                     (got[1][..., lo // BLOCK_D:-(-hi // BLOCK_D)], want[1])) \
                if isinstance(want, tuple) else ((got[..., lo:hi], want),)
            for g, w_ in pairs:
                err = max(err, float((g.double() - w_.double()).abs().max()))
        return err

    def plain_ms(plain, *arrays, nblk_args=()):
        def run():
            for _ in plain_chunks(plain, *arrays, nblk_args=nblk_args):
                pass
        run()
        return _events_ms(run, 1)

    cases = (
        ("quantize_stack", "K = 2",
         lambda: quantize_stack_kernel(stack), quantize_stack_ref, (stack,), (),
         K * (Dpad * f32 + Dpad * i8 + nblk * f32), 6 * K * Dpad, None),
        ("fused_agg", "fedavg, K = 2",
         lambda: fused_agg_kernel(q, s, w),
         lambda q_, s_: fused_agg_ref(q_, s_, w), (q, s), (1,),
         K * Dpad * i8 + K * nblk * f32 + K * f32 + Dpad * f32, 4 * K * Dpad,
         None),
        ("dequantize", "one update block",
         lambda: dequantize_kernel(q0, s0), dequantize_ref, (q0, s0), (1,),
         Dpad * i8 + nblk * f32 + Dpad * f32, Dpad,
         lambda: torch.mul(q0.view(-1, BLOCK_D), s0[:, None])),
    )
    for name, form, fn, plain, arrays, nblk_args, nbytes, ops_, library in cases:
        got = fn()
        err = worst(got, plain, *arrays, nblk_args=nblk_args)
        del got
        check(err == 0.0, f"{name} at D = {Dpad}: max_abs_err {err}")
        fn()
        ms = _events_ms(fn, 3)
        b_ms, b_by = bound_ms(nbytes, ops_)
        emit(phase="kernel_path", path="serve_olmo_1b", name=name, form=form,
             shape=[list(a.shape) for a in arrays],
             k_x_dpad=K * Dpad if name != "dequantize" else Dpad,
             over_2_31=(K * Dpad if name != "dequantize" else Dpad) > 2 ** 31,
             launches=counts[name], max_abs_err=err, ms=ms,
             plain_ms=plain_ms(plain, *arrays, nblk_args=nblk_args),
             library_ms=_events_ms(library, 3) if library else None,
             bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
             launches_x_gap_ms=counts[name] * (ms - b_ms))
        torch.cuda.empty_cache()


def path_serve_olmo_1b() -> dict:
    """olmo-1b at full width and depth (f32, random init from a seed) behind
    the continuous-batching engine: its prefill logits against a float64
    CPU forward, the reference CLI's 16-request Poisson trace served
    continuous and static on a WallClock, every request held to its
    same-row and its batch-1 oracle, then a deterministic hot swap on a
    VirtualClock to the model block of one int8 round committed through
    the top_k_int8 packer and the fused_int8 aggregator, with its
    read-back and the chain's verify().  Launches counted: one
    quantize_stack and one fused_agg (the round), K dequantize (the
    read-back), nothing else."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.aggregation import flatten_updates, normalize_weights
    from repro_torch.configs import registry
    from repro_torch.core.blockchain import Chain
    from repro_torch.device import synchronize
    from repro_torch.kernels.fused_agg import fused_agg_ref
    from repro_torch.kernels.ops import Int8UpdateCodec
    from repro_torch.models import init_model
    from repro_torch.serve import (
        ChainParamSource, ServeEngine, VirtualClock, WallClock,
        make_poisson_trace,
    )
    from repro_torch.tree import ravel_pytree, tree_leaves, tree_map

    path = "serve_olmo_1b"
    cfg = registry.get_config(SERVE_ARCH)
    dev = torch.device("cuda")
    out = {}

    def drive():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        synchronize(dev)
        n = sum(t.numel() for t in tree_leaves(params))
        emit(phase="serve_setup", path=path, arch=cfg.name,
             layers=cfg.num_layers, d_model=cfg.d_model,
             vocab=cfg.vocab_size, params=n, param_bytes=4 * n,
             init_s=time.perf_counter() - t0)
        trace = make_poisson_trace(vocab_size=cfg.vocab_size, **SERVE_TRACE)
        full_width_reference(cfg, params, trace[0].prompt)
        engine = ServeEngine(cfg, params, num_slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN, device=dev)
        t0 = time.perf_counter()
        engine.warmup(SERVE_TRACE["prompt_lens"])
        emit(phase="serve_warmup", path=path, seconds=time.perf_counter() - t0)
        reports, oracle = {}, {}
        for policy in ("continuous", "static"):
            rep = engine.run(trace, policy=policy, clock=WallClock())
            reports[policy] = rep
            emit(phase="serve", path=path, policy=policy, clock="wall",
                 slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, **rep.metrics())
            for res, req in zip(rep.results, trace):
                check(len(res.tokens) == req.max_new,
                      f"{path} {policy}: request {req.rid} truncated")
                check(res.tokens == oracle_row(cfg, params, res, req, oracle),
                      f"{path} {policy}: request {req.rid} differs from its "
                      f"oracle")
        served_without_syncs(engine, trace, reports["continuous"])
        batch_invariance(cfg, params, trace, reports)
        decode_tick(cfg, params)

        # ---- the hot swap, on a VirtualClock ---------------------------
        t0 = time.perf_counter()
        chain = Chain(k_updates_per_round=SERVE_K,
                      update_codec=Int8UpdateCodec(params))
        chain.append_model(params, 0)
        genesis_s = time.perf_counter() - t0
        appends = timed_appends(chain, dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        deltas = {u: tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                                    device=dev)
                              * (1e-3 * t.std()), params)
                  for u in range(1, SERVE_K + 1)}
        scores = dict(zip(deltas, SERVE_SCORES))
        committed = []

        def commit(tick):
            if tick == SERVE_SWAP_TICK and not committed:
                t1 = time.perf_counter()
                committed.append(commit_scored_round(
                    chain, params, deltas, scores, round_t=0, device=dev))
                committed.append(time.perf_counter() - t1)

        swap_engine = ServeEngine(cfg, params, num_slots=SERVE_SLOTS,
                                  max_len=SERVE_MAX_LEN,
                                  param_source=ChainParamSource(chain),
                                  device=dev)
        rep = swap_engine.run(trace, policy="continuous", clock=VirtualClock(),
                              on_tick=commit)
        check(len(committed) == 2, f"{path}: the round was not committed")
        ctx, commit_s = committed
        v1 = ctx.new_params
        m = rep.metrics()
        emit(phase="serve", path=path, policy="continuous", clock="virtual",
             swaps=rep.swaps, requests=m["requests"], ticks=m["ticks"],
             generated_tokens=m["generated_tokens"], occupancy=m["occupancy"],
             wall_s=m["wall_s"])
        emit(phase="commit", path=path, k=SERVE_K, seconds=commit_s,
             pack_s=ctx.timings["pack"], aggregate_s=ctx.timings["aggregate"],
             append_update_s=appends["append_update"],
             append_model_s=appends["append_model"],
             pack_minus_append_s=ctx.timings["pack"] - appends["append_update"],
             aggregate_minus_append_s=(ctx.timings["aggregate"]
                                       - appends["append_model"]),
             genesis_append_s=genesis_s, packed=ctx.packed_ids,
             weights=ctx.weights)
        check(len(rep.swaps) == 1 and rep.swaps[0]["round"] == 1
              and rep.swaps[0]["tick"] == SERVE_SWAP_TICK,
              f"{path}: swaps {rep.swaps}")
        swap_t = rep.swaps[0]["t"]
        kinds = {"before": 0, "after": 0, "spanning": 0}
        for res, req in zip(rep.results, trace):
            check(len(res.tokens) == req.max_new,
                  f"{path} swap: request {req.rid} dropped or truncated")
            if not res.spans_swap:
                version = res.version_admitted
                kinds["before" if version == 0 else "after"] += 1
                check(res.tokens == oracle_row(cfg, params if version == 0
                                               else v1, res, req, oracle),
                      f"{path} swap: request {req.rid} (v{version}) differs "
                      f"from its oracle")
            else:
                kinds["spanning"] += 1
                pre = 1 + round(swap_t - res.admitted)
                want = oracle_row(cfg, params, res, req, oracle)
                check(res.tokens[:pre] == want[:pre],
                      f"{path} swap: request {req.rid} lost its v0 prefix")
        emit(phase="swap_check", path=path, **kinds)
        check(all(kinds.values()), f"{path}: swap trace kinds {kinds}")

        # ---- read-back --------------------------------------------------
        t0 = time.perf_counter()
        blocks = chain.updates_at_round(0)
        blobs = chain.update_payloads_at_round(0, decode=False)
        steps = []
        for blk, blob, decoded in zip(blocks, blobs,
                                      chain.update_payloads_at_round(0)):
            err = (ravel_pytree(decoded)[0]
                   - ravel_pytree(deltas[blk.uploader])[0]).abs()
            tile_err = F.pad(err, (0, (-err.numel()) % 2048)).view(-1, 2048)
            ratio = float((tile_err.amax(dim=1) / blob["scales"]).max())
            steps.append(ratio)
            del decoded, err, tile_err
        check(max(steps) <= 1.0, f"{path}: a decoded block is off its delta by "
                                 f"{max(steps)} quantization steps")
        q = torch.stack([b["q"] for b in blobs])
        s = torch.stack([b["scales"] for b in blobs])
        w = normalize_weights(SERVE_K, ctx.weights, dev)
        flat0, flat1 = ravel_pytree(params)[0], ravel_pytree(v1)[0]
        D = flat0.numel()
        differ = 0
        for lo, hi, agg in plain_chunks(lambda q_, s_: fused_agg_ref(q_, s_, w),
                                        q, s, nblk_args=(1,)):
            hi = min(hi, D)
            if lo >= D:
                break
            want = flat0[lo:hi] + agg[:hi - lo]
            differ += int((want.view(torch.int32)
                           != flat1[lo:hi].view(torch.int32)).sum())
        del flat0, flat1
        verified = chain.verify()
        emit(phase="readback", path=path, blocks=len(blobs),
             max_err_in_steps=steps, model_lanes_differing=differ,
             verify=verified, height=chain.height,
             seconds=time.perf_counter() - t0,
             peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        check(differ == 0, f"{path}: {differ} lanes of the model block differ "
                           f"from v0 + the plain fused fedavg")
        check(verified and chain.height == SERVE_K + 2, f"{path}: chain.verify()")
        out.update(stack=flatten_updates([deltas[u] for u in ctx.packed_ids])[0],
                   q=q, s=s, w=w)

    want = {"quantize_stack": 1, "fused_agg": 1, "dequantize": SERVE_K}
    counts, _ = counted(path, drive, want)
    check({k: v for k, v in counts.items() if v} == want,
          f"{path}: launches {counts}, want exactly {want}")
    lm_kernel_lines(out["stack"], out["q"], out["s"], out["w"], counts)
    out.clear()
    torch.cuda.empty_cache()
    return counts


# the non-dense archs behind the engine, on serve_olmo_1b's trace: path ->
# (arch, units or None for the config's depth).  qwen3-moe-30b-a3b keeps 16
# of its 48 units: all 48 are 122.1 GB of f32 params, 16 are 42.4 GB
SERVE_ARCHS = {"serve_rwkv6_7b": ("rwkv6-7b", None),
               "serve_qwen3_moe": ("qwen3-moe-30b-a3b", 16)}
SERVE_F64_UNITS = 2      # units of the float64 host prefill's cut


def path_serve_arch(path: str) -> dict:
    """A recurrent (RWKV-6) or dense-path MoE model at full width behind the
    continuous-batching engine, random f32 weights from a seed on the card:
    the reference CLI's 16-request trace served continuous and static on a
    WallClock, every request held to its same-row and its batch-1 oracle
    (slots are reused, so a finished request's recurrent state must not
    reach the next one), no implicit sync in the engine's loop, one
    decode tick's times against the bytes bound of reading every
    parameter, and the prefill logits of one prompt against a float64
    host prefill of the first SERVE_F64_UNITS units of the same weights
    (the host cannot hold the whole tree in float64).  No hot swap: a
    K = 2 update stack of a 30-42 GB model does not fit beside it.  No
    kernel launches."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.device import synchronize
    from repro_torch.models import init_model
    from repro_torch.serve import ServeEngine, WallClock, make_poisson_trace
    from repro_torch.tree import tree_leaves, tree_map

    arch, units = SERVE_ARCHS[path]
    cfg = registry.get_config(arch, **({"num_units": units} if units else {}))
    dev = torch.device("cuda")

    def drive():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        synchronize(dev)
        n = sum(t.numel() for t in tree_leaves(params))
        emit(phase="serve_setup", path=path, arch=cfg.name,
             units=cfg.num_units, full_units=registry.get_config(arch).num_units,
             layers=cfg.num_layers, d_model=cfg.d_model,
             vocab=cfg.vocab_size, experts=cfg.num_experts,
             experts_per_token=cfg.num_experts_per_tok, params=n,
             param_bytes=4 * n, init_s=time.perf_counter() - t0)
        trace = make_poisson_trace(vocab_size=cfg.vocab_size, **SERVE_TRACE)
        cut = dataclasses.replace(cfg, num_units=SERVE_F64_UNITS)
        full_width_reference(cut, {**params, "units": tree_map(
            lambda t: t[:SERVE_F64_UNITS], params["units"])},
            trace[0].prompt, path=path)
        engine = ServeEngine(cfg, params, num_slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN, device=dev)
        t0 = time.perf_counter()
        engine.warmup(SERVE_TRACE["prompt_lens"])
        emit(phase="serve_warmup", path=path, seconds=time.perf_counter() - t0)
        reports, oracle = {}, {}
        for policy in ("continuous", "static"):
            rep = engine.run(trace, policy=policy, clock=WallClock())
            reports[policy] = rep
            slots = [res.slot for res in rep.results]
            emit(phase="serve", path=path, policy=policy, clock="wall",
                 slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                 most_requests_a_slot=max(slots.count(x) for x in set(slots)),
                 **rep.metrics())
            for res, req in zip(rep.results, trace):
                check(len(res.tokens) == req.max_new,
                      f"{path} {policy}: request {req.rid} truncated")
                check(res.tokens == oracle_row(cfg, params, res, req, oracle),
                      f"{path} {policy}: request {req.rid} differs from its "
                      f"oracle")
        served_without_syncs(engine, trace, reports["continuous"], path=path)
        batch_invariance(cfg, params, trace, reports, path=path)
        decode_tick(cfg, params, path=path)
        emit(phase="serve_memory", path=path,
             peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)

    counts, _ = counted(path, drive, {})
    check(not any(counts.values()), f"{path}: launches {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------------
# training: the LM trainer, olmo-1b, a serving node on a checkpoint
# directory, the FL rounds of launch/train.py
# ----------------------------------------------------------------------
TRAIN_LM_STEPS = {"standard": 100, "bflc": 50}
TRAIN_WARM = 10          # steps before the timed window
TRAIN_PROFILED = 5       # steady steps under torch.profiler, after the window
# nats the last 10 steps' mean must sit below step 1's.  At the default lr
# the loss falls from about 9.16 to the chain's unigram entropy (8.77 nats,
# the best loss without context; ``unigram_entropy``) within 100 steps and
# stays there for 400 (H100, PERF.md), as the reference's does at a small
# width: a drop of 0.37 (standard) and 0.33 (bflc, 50 steps) is what the
# data allows before the model learns the transitions
TRAIN_LOSS_DROP = 0.25
# the reference's own learning test (tests/test_system.py::
# test_lm_driver_learns): the small model at vocab 512 and lr 5e-3 ends
# below CONTEXT_LOSS after 100 steps, under its chain's unigram entropy, so
# it predicts from context and not from the token marginal alone
CONTEXT_FLAGS = ("--small", "--vocab", "512", "--lr", "5e-3", "--seq", "64",
                 "--steps", "100", "--log-every", "100")
CONTEXT_LOSS = 5.0
# the card's gradients against the same step on the CPU in float64 (its
# norms, RoPE and attention compute in float32, as the model does): each
# leaf within GRAD_RTOL of its largest |g|, the loss within F64_LOSS_RTOL.
# float32 rounding over 12 units and sums of up to 4,096 products reads
# 3.3e-6 (standard) and 2.8e-5 (bflc, whose committee weights magnify a
# cohort loss's last bits) of a leaf's largest gradient (H100, PERF.md).
# The same step with TF32 on is the control: it must land above the limit
GRAD_CHECK_ROWS = 4
GRAD_RTOL = {"standard": 1e-4, "bflc": 3e-4}
F64_LOSS_RTOL = 1e-5
OLMO_TRAIN = dict(arch="olmo-1b", batch=8, seq=256, steps=3, lr=3e-4,
                  cohorts=4, committee=4)
# the weight leaves a token's forward multiplies (per token, 2 flops each)
MATMUL_KEYS = {"wq", "wk", "wv", "wo", "up", "gate", "down", "lm_head"}
CKPT_SWAP_TICKS = (24, 48)       # round 1 (f32), round 2 (int8 blob) appear
TRAIN_FL_ROUNDS = 2


def train_args(*flags: str):
    """launch/train.py's CLI at its defaults (on the card), with ``flags``."""
    from repro_torch.launch.train import build_parser

    return build_parser().parse_args(list(flags))


def matmul_params(cfg, params) -> int:
    """Parameters a token's forward multiplies: every attention and MLP
    weight, and the head (the embedding table when the head is tied)."""
    from repro_torch.tree import tree_paths

    head = {"embed"} if cfg.tie_embeddings else set()
    return sum(t.numel() for path, t in tree_paths(params)
               if path[-1] in MATMUL_KEYS | head)


def step_flops(cfg, n_mm: int, rows: int, seq: int, val_rows: int = 0) -> float:
    """Model flops of one train step: 6 N per token for the forward and
    backward matmuls, plus dense attention's QK^T and PV (4 S^2 hd per head
    and row, times 3 for the backward), plus the bflc committee's
    validation forward (2 N per token and 4 S^2 hd per head and row)."""
    attn = 4.0 * seq * seq * cfg.resolved_head_dim * cfg.num_heads \
        * cfg.num_layers
    return (rows * (6.0 * n_mm * seq + 3 * attn)
            + val_rows * (2.0 * n_mm * seq + attn))


def unigram_entropy(lm) -> float:
    """Entropy (nats) of the Markov chain's stationary token distribution
    (power iteration): the loss of the best prediction that ignores the
    context."""
    import numpy as np

    pi = np.full(lm.vocab, 1.0 / lm.vocab)
    for _ in range(200):
        nxt = np.zeros(lm.vocab)
        for j in range(lm.branching):
            np.add.at(nxt, lm.succ[:, j], pi * lm.probs[j])
        pi = nxt
    pi = pi[pi > 0]
    return float(-(pi * np.log(pi)).sum())


def fresh_peak() -> float:
    """Collect what earlier paths left to the garbage collector, set the
    card's peak-memory counter to 0 and return the GB still allocated, from
    which a path's peak is counted."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def device_busy(prof, wall_s: float, n: int) -> dict:
    """The device's busy time in a profiled window (the union of its
    kernels' intervals) against the window's host time, the launches a
    step and the leading kernels by device time."""
    from torch.autograd import DeviceType

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_s = sum(hi - lo for lo, hi in merged(
        (e.time_range.start, e.time_range.end) for e in device)) / 1e6
    by_name = {}
    for e in device:
        us, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_s": wall_s, "device_busy_s": busy_s,
            "busy_share": busy_s / wall_s, "kernels_per_step": len(device) / n,
            "top": [{"kernel": name[:100], "us_per_step": us / n,
                     "count_per_step": c / n} for name, (us, c) in top]}


class TrainMeter:
    """``run_lm``'s ``on_step``: the losses (device tensors, read at the
    end), a timed window of steady steps (host clock with the device
    synchronized at both edges, and CUDA events), then TRAIN_PROFILED steps
    under torch.profiler, and the last state."""

    def __init__(self, steps: int):
        import torch

        self.steps, self.losses, self.state = steps, [], None
        self.lo, self.hi = TRAIN_WARM, steps - TRAIN_PROFILED
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        self.host = [0.0, 0.0]
        self.prof, self.prof_wall = None, 0.0

    def __call__(self, step, state, metrics):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.losses.append(metrics["loss"])
        if step + 1 in (self.lo, self.hi):
            edge = 0 if step + 1 == self.lo else 1
            self.events[edge].record()
            torch.cuda.synchronize()
            self.host[edge] = time.perf_counter()
        if step + 1 == self.hi:
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.prof_wall = time.perf_counter()
        if step + 1 == self.steps:
            torch.cuda.synchronize()
            self.prof_wall = time.perf_counter() - self.prof_wall
            self.prof.stop()
            self.state = state

    def report(self) -> dict:
        """Profiling adds host time, so the profiled window's busy share is
        a lower bound; ``busy_over_unprofiled`` holds the same device time
        against as many unprofiled steady steps."""
        n = self.hi - self.lo
        s_per_step = (self.host[1] - self.host[0]) / n
        prof = device_busy(self.prof, self.prof_wall, TRAIN_PROFILED)
        prof["busy_over_unprofiled"] = (prof["device_busy_s"]
                                        / (TRAIN_PROFILED * s_per_step))
        return {"timed_steps": n, "s_per_step": s_per_step,
                "event_ms_per_step": self.events[0].elapsed_time(
                    self.events[1]) / n,
                "profile": prof}


def grad_check(cfg, mode: str) -> None:
    """One step's gradients at GRAD_CHECK_ROWS rows on the card against the
    same port step on the CPU in float64, from the seeded init and the same
    Markov-chain batch; the card's step again with TF32 on, which must
    miss the limit the float32 step meets."""
    import numpy as np
    import torch

    from repro_torch.data.lm_synthetic import MarkovLM
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import init_model
    from repro_torch.tree import tree_map, tree_paths

    t0 = time.perf_counter()
    args = train_args()
    grad_fn = make_grad_fn(cfg, mode=mode, num_cohorts=GRAD_CHECK_ROWS,
                           committee_size=args.committee)
    lm = MarkovLM(cfg.vocab_size, seed=1)
    rng = np.random.default_rng(7)
    batch = lm_batch(lm, rng, GRAD_CHECK_ROWS, args.seq, "cuda")
    val = lm_batch(lm, rng, args.committee, args.seq, "cuda")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    g_card, _, ce_card = grad_fn(params, batch, val)
    g_card = tree_map(lambda t: t.cpu(), g_card)
    ce_card = float(ce_card)
    card_s = time.perf_counter() - t0
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        g_tf32 = tree_map(lambda t: t.cpu(), grad_fn(params, batch, val)[0])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    on_cpu = lambda tree: tree_map(
        lambda t: None if t is None else (
            t.to("cpu", torch.float64) if t.is_floating_point() else t.cpu()),
        tree)
    p64 = on_cpu(params)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g64, _, ce64 = grad_fn(p64, type(batch)(*on_cpu(tuple(batch))),
                           type(val)(*on_cpu(tuple(val))))
    cpu_s = time.perf_counter() - t0

    def worst_leaf(grads):
        worst, worst_path = 0.0, None
        for (path, a), (_, b) in zip(tree_paths(grads), tree_paths(g64)):
            rel = float((a.double() - b).abs().max()) / max(
                float(b.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_path = rel, path
        return worst, worst_path

    worst, worst_path = worst_leaf(g_card)
    tf32_worst, _ = worst_leaf(g_tf32)
    rtol = GRAD_RTOL[mode]
    loss_rel = abs(ce_card - float(ce64)) / abs(float(ce64))
    emit(phase="grad_check", path="train_lm_100m", mode=mode,
         rows=GRAD_CHECK_ROWS, seq=args.seq, loss_card=ce_card,
         loss_cpu_f64=float(ce64), loss_rel_err=loss_rel,
         worst_leaf_rel_err=worst, worst_leaf=list(map(str, worst_path)),
         rtol=rtol, tf32_worst_leaf_rel_err=tf32_worst, card_s=card_s,
         cpu_f64_s=cpu_s)
    check(worst <= rtol, f"train_lm_100m {mode}: gradient leaf "
                              f"{worst_path} off the float64 CPU step by "
                              f"{worst} of its largest |g|")
    check(loss_rel <= F64_LOSS_RTOL, f"train_lm_100m {mode}: loss off the "
                                     f"float64 CPU step by {loss_rel}")
    check(tf32_worst > rtol, f"train_lm_100m {mode}: the TF32 control is "
                             f"within {tf32_worst} <= {rtol} of the float64 "
                             f"step, so the limit cannot tell TF32 from f32")


def context_check() -> None:
    """run_lm at the reference's learning-test settings (CONTEXT_FLAGS) on
    the card: every loss finite, the last below CONTEXT_LOSS and below the
    chain's unigram entropy."""
    import torch

    from repro_torch.data.lm_synthetic import MarkovLM
    from repro_torch.launch.train import run_lm

    args = train_args(*CONTEXT_FLAGS)
    losses = []
    t0 = time.perf_counter()
    final = run_lm(args, on_step=lambda step, state, m: losses.append(
        m["loss"]))
    seconds = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    lm = MarkovLM(args.vocab, seed=1)
    floor = unigram_entropy(lm)
    emit(phase="context_check", path="train_lm_100m", flags=CONTEXT_FLAGS,
         loss_every_10=[losses[0]] + losses[9::10], final=final,
         unigram_entropy=floor, chain_entropy=float(lm.entropy()),
         limit=CONTEXT_LOSS, seconds=seconds)
    check(all(math.isfinite(x) for x in losses),
          "context_check: a loss is not finite")
    check(final < min(CONTEXT_LOSS, floor),
          f"context_check: final loss {final}, unigram entropy {floor}")
    torch.cuda.empty_cache()


def path_train_lm_100m() -> dict:
    """repro_torch.launch.train.run_lm on the card at the CLI's defaults
    (repro-100m, 116,411,136 params): ``standard`` for 100 steps, then
    ``bflc`` (4 cohorts, committee 4) for 50, each from the seeded init.
    Per mode: the loss every 10 steps, s/step and tokens/s over the steady
    steps, CUDA-event ms a step, peak memory, the device's busy share of 5
    profiled steps, their launches and leading kernels, and model flops over
    step time as a share of the f32 peak.  Every loss finite, the last 10
    steps' mean at least TRAIN_LOSS_DROP below the first step's (beside
    the chain's unigram entropy), the small model learning context
    (``context_check``), and one step's gradients against the float64 CPU
    step in both modes.  Returns
    the launch counts and the standard run's trained params."""
    import torch

    from repro_torch.data.lm_synthetic import MarkovLM
    from repro_torch.launch.train import lm_100m_config, run_lm
    from repro_torch.tree import tree_leaves

    path = "train_lm_100m"
    cfg = lm_100m_config(train_args().vocab)
    floor = unigram_entropy(MarkovLM(cfg.vocab_size, seed=1))
    out = {}

    def drive():
        for mode, steps in TRAIN_LM_STEPS.items():
            args = train_args("--steps", str(steps), "--mode", mode)
            meter = TrainMeter(steps)
            held = fresh_peak()
            t0 = time.perf_counter()
            run_lm(args, on_step=meter)
            seconds = time.perf_counter() - t0
            losses = [float(x) for x in meter.losses]
            params = meter.state.params
            n = sum(t.numel() for t in tree_leaves(params))
            n_mm = matmul_params(cfg, params)
            val_rows = args.committee if mode == "bflc" else 0
            flops = step_flops(cfg, n_mm, args.batch, args.seq, val_rows)
            rep = meter.report()
            tokens = args.batch * args.seq
            last = sum(losses[-10:]) / 10
            emit(phase="train", path=path, mode=mode, steps=steps,
                 params=n, matmul_params=n_mm, batch=args.batch,
                 seq=args.seq, val_rows=val_rows, seconds=seconds,
                 loss_every_10=[losses[0]] + losses[9::10],
                 last_10_mean=last, unigram_entropy=floor,
                 tokens_per_s=tokens / rep["s_per_step"],
                 model_flops_per_step=flops,
                 f32_peak_share=flops / (rep["event_ms_per_step"] * 1e-3)
                 / F32_OPS_PER_S,
                 peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                 allocated_before_gb=held, **rep)
            check(n == 116_411_136, f"{path}: {n} params")
            check(all(math.isfinite(x) for x in losses),
                  f"{path} {mode}: a loss is not finite")
            check(last <= losses[0] - TRAIN_LOSS_DROP,
                  f"{path} {mode}: the last 10 losses average {last}, the "
                  f"first was {losses[0]}")
            if mode == "standard":
                out["params"] = params
            del meter, params
            torch.cuda.empty_cache()
        context_check()
        for mode in TRAIN_LM_STEPS:
            grad_check(cfg, mode)

    counts, _ = counted(path, drive, {})
    check(not any(counts.values()), f"{path}: launches {counts}")
    out["counts"] = counts
    return out


def path_train_olmo_1b() -> dict:
    """make_train_step on olmo-1b at full width and depth (1,176,764,416
    params), bflc mode, AdamW under linear_warmup_cosine(lr, 1, 3): step 1
    (lr 0) leaves the params bit for bit, steps 2 and 3 move them; every
    loss finite.  Each step timed on the host clock between device
    synchronizations (s/step and the f32 peak share from step 2, the first
    after warm-up), peak memory, and step 3 under torch.profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.lm_synthetic import MarkovLM
    from repro_torch.launch.steps import TrainState, make_train_step
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import init_model
    from repro_torch.optim import adamw, linear_warmup_cosine
    from repro_torch.tree import tree_leaves

    path, o = "train_olmo_1b", OLMO_TRAIN
    cfg = registry.get_config(o["arch"])
    dev = torch.device("cuda")

    def drive():
        held = fresh_peak()
        opt = adamw(linear_warmup_cosine(o["lr"], 1, o["steps"]))
        step_fn = make_train_step(cfg, opt, mode="bflc",
                                  num_cohorts=o["cohorts"],
                                  committee_size=o["committee"])
        p0 = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        state = TrainState(p0, opt.init(p0),
                           torch.zeros((), dtype=torch.int32, device=dev))
        lm = MarkovLM(cfg.vocab_size, seed=1)
        rng = np.random.default_rng(0)
        seconds, losses, prof_rep, moved = [], [], None, []
        for i in range(o["steps"]):
            batch = lm_batch(lm, rng, o["batch"], o["seq"], dev)
            val = lm_batch(lm, rng, o["committee"], o["seq"], dev)
            torch.cuda.synchronize()
            prof = None
            if i == o["steps"] - 1:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch, val)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if prof is not None:
                prof.stop()
                prof_rep = device_busy(prof, seconds[-1], 1)
            losses.append(float(m["loss"]))
            moved.append(sum(not torch.equal(a, b) for a, b in zip(
                tree_leaves(state.params), tree_leaves(p0))))
        n = sum(t.numel() for t in tree_leaves(p0))
        n_mm = matmul_params(cfg, p0)
        flops = step_flops(cfg, n_mm, o["batch"], o["seq"], o["committee"])
        emit(phase="train", path=path, mode="bflc", arch=cfg.name, params=n,
             matmul_params=n_mm, batch=o["batch"], seq=o["seq"],
             val_rows=o["committee"], losses=losses, step_s=seconds,
             leaves_moved=moved, leaves=len(tree_leaves(p0)),
             s_per_step=seconds[1],
             tokens_per_s=o["batch"] * o["seq"] / seconds[1],
             model_flops_per_step=flops,
             f32_peak_share=flops / seconds[1] / F32_OPS_PER_S,
             peak_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
             allocated_before_gb=held, profile=prof_rep)
        check(n == 1_176_764_416, f"{path}: {n} params")
        check(all(math.isfinite(x) for x in losses), f"{path}: losses {losses}")
        check(moved[0] == 0, f"{path}: step 1 (lr 0) moved {moved[0]} leaves")
        leaves = len(tree_leaves(p0))
        check(moved[1] == moved[2] == leaves, f"{path}: steps 2-3 moved "
                                              f"{moved[1:]} of {leaves} leaves")

    counts, _ = counted(path, drive, {})
    check(not any(counts.values()), f"{path}: launches {counts}")
    torch.cuda.empty_cache()
    return counts


def path_serve_checkpoint(trained) -> dict:
    """A serving node that follows a checkpoint directory: the trained
    repro-100m params written through repro_torch.checkpoint as
    model_round_1.msgpack (f32) at tick 24, their Int8UpdateCodec blob
    (quantize kernel) as model_round_2.msgpack at tick 48, into the
    directory a CheckpointParamSource on the card polls (its decode: the
    dequantize kernel), behind a ServeEngine serving serve_olmo_1b's trace
    shape from the untrained init.  Two swaps, nothing dropped, requests
    wholly under one version equal to that version's oracle, spanning ones
    keeping their prefix; the loaded f32 tree bit for bit the trained one,
    the served int8 model bit for bit the plain dequantize of the plain
    quantize.  Exactly one quantize and one dequantize launch; then both
    kernels timed at D = 116,411,136."""
    import shutil

    import torch
    import torch.nn.functional as F

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.device import synchronize
    from repro_torch.kernels.ops import Int8UpdateCodec
    from repro_torch.kernels.quantize import dequantize_ref, quantize_ref
    from repro_torch.kernels.tiling import BLOCK_D
    from repro_torch.launch.train import lm_100m_config
    from repro_torch.models import init_model
    from repro_torch.serve import (
        CheckpointParamSource, ServeEngine, VirtualClock, checkpoint_name,
        make_poisson_trace,
    )
    from repro_torch.tree import ravel_pytree, tree_leaves

    path = "serve_checkpoint"
    cfg = lm_100m_config(train_args().vocab)
    dev = torch.device("cuda")
    directory = os.path.join(ROOT, "build", "serve_checkpoint")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    timings, state = {"save_s": {}, "load_s": []}, {}

    def drive():
        v0 = init_model(torch.Generator(device=dev).manual_seed(0), cfg)
        codec = Int8UpdateCodec(trained)
        src = CheckpointParamSource(directory, codec=codec, start_round=0,
                                    device=dev)
        poll = src.poll

        def timed_poll():
            t0 = time.perf_counter()
            got = poll()
            if got is not None:
                synchronize(dev)
                timings["load_s"].append(time.perf_counter() - t0)
            return got

        src.poll = timed_poll

        def write(tick):
            if tick not in CKPT_SWAP_TICKS:
                return
            round_t = 1 + CKPT_SWAP_TICKS.index(tick)
            t0 = time.perf_counter()
            if round_t == 1:
                tree = trained
            else:
                state["blob"] = tree = codec.encode(trained)
            save_pytree(os.path.join(directory, checkpoint_name(round_t)), tree)
            timings["save_s"][round_t] = time.perf_counter() - t0

        engine = ServeEngine(cfg, v0, num_slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN, param_source=src,
                             device=dev)
        trace = make_poisson_trace(vocab_size=cfg.vocab_size, **SERVE_TRACE)
        rep = engine.run(trace, policy="continuous", clock=VirtualClock(),
                         on_tick=write)
        state.update(v0=v0, served=engine.params, rep=rep, trace=trace)

    counts, _ = counted(path, drive, {"quantize": 1, "dequantize": 1})
    check({k: v for k, v in counts.items() if v} == {"quantize": 1,
                                                     "dequantize": 1},
          f"{path}: launches {counts}")
    rep, trace = state["rep"], state["trace"]
    m = rep.metrics()
    emit(phase="serve", path=path, policy="continuous", clock="virtual",
         swaps=rep.swaps, requests=m["requests"], ticks=m["ticks"],
         generated_tokens=m["generated_tokens"], occupancy=m["occupancy"],
         wall_s=m["wall_s"])
    check([(s["round"], s["tick"]) for s in rep.swaps]
          == [(1, CKPT_SWAP_TICKS[0]), (2, CKPT_SWAP_TICKS[1])],
          f"{path}: swaps {rep.swaps}")

    # the f32 round loads bit for bit; the served int8 round is the plain
    # dequantize of the plain quantize, and the blob the plain quantize
    loaded = load_pytree(os.path.join(directory, checkpoint_name(1)),
                         device=dev)
    f32_same = all(same_bits(a, b) for a, b in zip(tree_leaves(loaded),
                                                   tree_leaves(trained)))
    flat = ravel_pytree(trained)[0]
    D = flat.numel()
    padded = F.pad(flat, (0, (-D) % BLOCK_D))
    q_plain, s_plain = quantize_ref(padded)
    blob = state["blob"]
    blob_same = (torch.equal(blob["q"], q_plain)
                 and same_bits(blob["scales"], s_plain) and blob["d"] == D)
    decoded_same = same_bits(ravel_pytree(state["served"])[0],
                             dequantize_ref(q_plain, s_plain)[:D])
    emit(phase="checkpoint_check", path=path, d=D, dpad=padded.numel(),
         f32_bit_identical=f32_same, blob_equal_to_plain_quantize=blob_same,
         served_int8_equal_to_plain=decoded_same,
         save_s=timings["save_s"], load_s=timings["load_s"],
         file_bytes={r: os.path.getsize(os.path.join(directory,
                                                     checkpoint_name(r)))
                     for r in (1, 2)})
    check(f32_same, f"{path}: the loaded f32 round differs from the trained "
                    f"params")
    check(blob_same, f"{path}: the round-2 blob differs from the plain "
                     f"quantize")
    check(decoded_same, f"{path}: the served int8 model differs from the "
                        f"plain dequantize of the plain quantize")
    del loaded

    versions = {0: state["v0"], 1: trained, 2: state["served"]}
    kinds, oracle = {"v0": 0, "v1": 0, "v2": 0, "spanning": 0}, {}
    swap_ts = [s["t"] for s in rep.swaps]
    for res, req in zip(rep.results, trace):
        check(len(res.tokens) == req.max_new,
              f"{path}: request {req.rid} dropped or truncated")
        want = oracle_row(cfg, versions[res.version_admitted], res, req,
                          oracle)
        if not res.spans_swap:
            kinds[f"v{res.version_admitted}"] += 1
            check(res.tokens == want, f"{path}: request {req.rid} "
                                      f"(v{res.version_admitted}) differs "
                                      f"from its oracle")
        else:
            kinds["spanning"] += 1
            swap_t = min(t for t in swap_ts if t > res.admitted)
            pre = 1 + round(swap_t - res.admitted)
            check(res.tokens[:pre] == want[:pre],
                  f"{path}: request {req.rid} lost its "
                  f"v{res.version_admitted} prefix")
    emit(phase="swap_check", path=path, **kinds)
    check(all(kinds.values()), f"{path}: swap trace kinds {kinds}")
    ckpt_kernel_lines(padded, blob["q"], blob["scales"], counts)
    state.clear()
    shutil.rmtree(directory, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


def ckpt_kernel_lines(padded, q, s, counts) -> None:
    """quantize (#1) and dequantize (#3) at the LM's width, after the
    counted run (these launches count nowhere): each against its plain
    version on the card, bit for bit, with CUDA-event times of the kernel,
    the plain version and (dequantize) one torch.mul, and the bytes bound."""
    import torch

    from repro_torch.kernels.quantize import (
        dequantize_kernel, dequantize_ref, quantize_kernel, quantize_ref,
    )
    from repro_torch.kernels.tiling import BLOCK_D

    Dpad = padded.numel()
    nblk = Dpad // BLOCK_D
    cases = (
        ("quantize", lambda: quantize_kernel(padded),
         lambda: quantize_ref(padded), Dpad * 4 + Dpad + nblk * 4, 6 * Dpad,
         None),
        ("dequantize", lambda: dequantize_kernel(q, s),
         lambda: dequantize_ref(q, s), Dpad + nblk * 4 + Dpad * 4, Dpad,
         lambda: torch.mul(q.view(-1, BLOCK_D), s[:, None])),
    )
    for name, fn, plain, nbytes, ops_, library in cases:
        got, want = fn(), plain()
        err = max_err(got, want)
        same = all(same_bits(g.float(), w.float()) for g, w in
                   zip(got if isinstance(got, tuple) else (got,),
                       want if isinstance(want, tuple) else (want,)))
        del got, want
        check(err == 0.0 and same, f"{name} at D = {Dpad}: max_abs_err {err}")
        b_ms, b_by = bound_ms(nbytes, ops_)
        ms = _events_ms(fn, 5)
        emit(phase="kernel_path", path="serve_checkpoint", name=name,
             shape=[Dpad], launches=counts[name], max_abs_err=err, ms=ms,
             us=ms * 1e3, plain_ms=_events_ms(plain, 3),
             library_ms=_events_ms(library, 5) if library else None,
             bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
             bound_share=b_ms / ms)
        torch.cuda.empty_cache()


def path_train_fl() -> dict:
    """repro_torch.launch.train.run_fl for 2 rounds at the CLI's defaults
    (100 clients, 20 % active, k = 8, 20 local steps, FEMNIST CNN width 16):
    run_fl checks chain.verify(); the accuracy in [0, 1].  The defaults are
    the reference's plain f32 chain, so no kernel but the local trainer's
    launches."""
    from repro_torch.launch.train import run_fl

    path = "train_fl"
    acc = {}

    def drive():
        t0 = time.perf_counter()
        acc["value"] = run_fl(train_args("--driver", "fl", "--rounds",
                                         str(TRAIN_FL_ROUNDS)))
        acc["seconds"] = time.perf_counter() - t0

    counts, _ = counted(path, drive, {})
    emit(phase="train_fl", path=path, rounds=TRAIN_FL_ROUNDS,
         test_accuracy=acc["value"], seconds=acc["seconds"])
    check(0.0 <= acc["value"] <= 1.0, f"{path}: accuracy {acc['value']}")
    check(counts[TRAINER_KERNEL] > 0 and not any(
        n for k, n in counts.items() if k != TRAINER_KERNEL),
        f"{path}: launches {counts}")
    return counts


def merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


class StageRange:
    """Forwards a sequential runtime's round stage (and its ``prepare``)
    inside a profiler range ``stage.<timing key>`` that ends after a device
    synchronize, so every kernel the stage launched runs inside its range.
    The sequential engine synchronizes after every stage anyway."""

    def __init__(self, stage, key: str):
        self._stage, self._key = stage, key

    def __getattr__(self, attr):
        value = getattr(self._stage, attr)
        if attr == "prepare":
            return functools.partial(self._ranged, value)
        return value

    def __call__(self, ctx):
        self._ranged(self._stage, ctx)

    def _ranged(self, fn, ctx):
        import torch

        with torch.profiler.record_function(f"stage.{self._key}"):
            fn(ctx)
            torch.cuda.synchronize()


# the cohort stages a sequential profile splits out, by timing key
PROFILED_STAGES = {"sampler": "sample", "local_trainer": "train",
                   "validator": "validate"}


def phase_profile(path: str, rt) -> None:
    """One more round under torch.profiler (``--profile`` only): device
    time by kernel, and the device's busy time against the round's wall
    time (the union of the kernels' intervals; ``kernel_sum_s`` sums
    them).  Profiling adds host time, so ``idle_share`` (against the
    profiled round) is an upper bound; ``busy_over_unprofiled`` holds the
    same device time against the runtime's last round without the
    profiler.  A sequential runtime's sample / train / validate stages
    also report the device time inside their ranges against their
    unprofiled seconds: near 1, the card paces the stage; well under 1,
    the host does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    unprofiled = dict(rt.stage_timings[-1])
    wrapped = {}
    if rt.schedule == "sequential":
        for kind, key in PROFILED_STAGES.items():
            wrapped[kind] = getattr(rt.pipeline, kind)
            setattr(rt.pipeline, kind, StageRange(wrapped[kind], key))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt.run_round()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for kind, stage in wrapped.items():
            setattr(rt.pipeline, kind, stage)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    # kernels of one stream overlap where a launch starts before the one
    # ahead of it ends, so busy time is the union of their intervals
    busy = merged((e.time_range.start, e.time_range.end) for e in device)
    busy_s = sum(hi - lo for lo, hi in busy) / 1e6
    by_name = {}
    for e in device:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]
    stages = {}
    for key in (PROFILED_STAGES.values() if wrapped else ()):
        windows = merged((e.time_range.start, e.time_range.end) for e in events
                         if e.device_type == DeviceType.CPU
                         and e.name == f"stage.{key}")
        inside = sum(max(0, min(b, hi) - max(a, lo))
                     for a, b in busy for lo, hi in windows)
        stages[key] = {"ranges": len(windows),
                       "profiled_s": sum(hi - lo for lo, hi in windows) / 1e6,
                       "device_busy_s": inside / 1e6,
                       "unprofiled_s": unprofiled.get(key, 0.0),
                       "busy_over_unprofiled": inside / 1e6
                       / max(unprofiled.get(key, 0.0), 1e-9)}
    round_s = sum(unprofiled.values())
    emit(phase="profile", path=path, schedule=rt.schedule, wall_s=wall,
         device_busy_s=busy_s, idle_share=1.0 - busy_s / wall,
         kernel_sum_s=sum(us for us, _ in by_name.values()) / 1e6,
         unprofiled_round_s=round_s, busy_over_unprofiled=busy_s / round_s,
         stages=stages, timings=rt.stage_timings[-1],
         top=[{"kernel": k[:120], "us": us, "count": n}
              for k, (us, n) in top])


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    t_script = time.perf_counter()
    phase_card()
    phase_build()
    rows = phase_kernels()
    from repro_torch.data.synthetic import make_femnist_like

    t0 = time.perf_counter()
    ds = make_femnist_like(seed=1)
    emit(phase="data", seconds=time.perf_counter() - t0,
         clients=ds.num_clients, test=len(ds.test_labels))
    phase_trainer_invariance(ds)
    paths = {"int8": path_int8(ds), "int8_committee": path_int8_committee(ds)}
    for m in ("cwmed", "trimmed_mean"):
        paths[f"int8_{m}"] = path_int8_sort(ds, m)
    for m in ("fedavg", "cwmed", "trimmed_mean"):
        paths[f"f32_{m}"] = path_f32(ds, m)
    for name in TIERED_PATHS:
        paths[name] = path_tiered(ds, name)
    for name in ASYNC_PATHS:
        paths[name] = path_async(ds, name)
    later = {}
    init = sharded_init()
    t0 = time.perf_counter()
    world1_counts, world1 = path_sharded_world1(ds, init)
    later.update(world1_counts)
    emit(phase="path_seconds", path="sharded_world1",
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    # world 2 runs paths of world 1's names: keep both counts
    later.update({f"{path}_world2": counts for path, counts
                  in path_sharded_world2(init, world1).items()})
    emit(phase="path_seconds", path="sharded_world2",
         seconds=time.perf_counter() - t0)
    path_baselines(ds)
    t0 = time.perf_counter()
    later["serve_olmo_1b"] = path_serve_olmo_1b()
    emit(phase="path_seconds", path="serve_olmo_1b",
         seconds=time.perf_counter() - t0)
    for name in SERVE_ARCHS:
        t0 = time.perf_counter()
        later[name] = path_serve_arch(name)
        emit(phase="path_seconds", path=name, seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    trained = path_train_lm_100m()
    later["train_lm_100m"] = trained.pop("counts")
    emit(phase="path_seconds", path="train_lm_100m",
         seconds=time.perf_counter() - t0)
    for name, run in (("serve_checkpoint",
                       lambda: path_serve_checkpoint(trained.pop("params"))),
                      ("train_olmo_1b", path_train_olmo_1b),
                      ("train_fl", path_train_fl)):
        t0 = time.perf_counter()
        later[name] = run()
        emit(phase="path_seconds", path=name, seconds=time.perf_counter() - t0)
    for r in rows:
        r["launches"] = (sum(c[r["name"]] for c, _ in paths.values())
                         + sum(c[r["name"]] for c in later.values()))
        check(r["launches"] > 0, f"{r['name']} was launched on no path")
    if "--profile" in argv:
        for name, (_, rt) in paths.items():
            for each in rt if isinstance(rt, tuple) else (rt,):
                phase_profile(name, each)
    emit(phase="script", seconds=time.perf_counter() - t_script)
    keys = ("name", "form", "route", "source", "replaces", "variant", "launches",
            "max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit(kernels=[{k: r[k] for k in keys} for r in rows])
    print(nvidia_smi(), flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
