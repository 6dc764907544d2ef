#!/usr/bin/env python3
"""Runs the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU
    python3 chip_smoke.py --profile  # also profile one more round

Phases, one JSON line each:
  card     the GPU's name and power limit (nvidia-smi) and the TF32 switches
           the port sets (both must be off)
  build    nvcc of every CUDA source under src/repro_torch/kernels/csrc,
           in parallel, with the build seconds
  kernel   each kernel against its plain PyTorch version (run on CPU copies
           of the same inputs) at the main path's shapes and at edge shapes
           (ragged D, all-zero tiles, exact half steps, K in {1, 3, 8, 17},
           quantize_out on and off for every method), with device times
           (CUDA-graph replay between CUDA events) of the kernel, the plain
           version and, where one PyTorch call computes the same function,
           that call; ``eager_ms`` is the kernel's time per call from
           Python, launch path included
  round    three full-width BFLC rounds through repro_torch.api
           (FEMNIST CNN width 32, 900 writers, quantize_chain=True), the
           chain's verify(), test accuracy, a read-back of the last
           round's update blocks re-aggregated by the plain path against
           the committed model delta, and the kernels' launch counts
Then the ``kernels`` summary line, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; without CUDA it exits 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non tensor core)
# flop/s — the bounds below are the larger of bytes / HBM and ops / f32
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
MAIN_K = 8


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


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in paths.items()},
         flags=list(_build.NVCC_FLAGS))


def phase_kernels():
    """Each kernel against its plain version; returns the summary rows."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_agg import METHODS, fused_agg_kernel, fused_agg_ref
    from repro_torch.kernels.ops import padded_dim
    from repro_torch.kernels.quantize import (
        dequantize_kernel, dequantize_ref, quantize_kernel, quantize_ref,
        quantize_stack_kernel, quantize_stack_ref,
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

    def row(name, replaces, fn, plain, cpu_args, gpu_args, tol, nbytes, flops,
            library=None, edge=None):
        got = fn(*gpu_args)
        torch.cuda.synchronize()
        err = max_err(got, plain(*cpu_args))
        check(err <= tol, f"{name}: max_abs_err {err} > {tol}")
        b_ms, b_by = bound_ms(nbytes, flops)
        entry = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      + ("fused_agg.cu" if name == "fused_agg" else "quantize.cu"),
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "tolerance": tol,
            "ms": time_ms(lambda: fn(*gpu_args)),
            "eager_ms": eager_ms(lambda: fn(*gpu_args)),
            "plain_ms": time_ms(lambda: plain(*gpu_args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library) if library else None,
            "shape": [list(a.shape) for a in gpu_args if hasattr(a, "shape")],
        }
        if edge is not None:
            entry["edge_cases"], entry["edge_max_abs_err"] = edge()
        emit(phase="kernel", **entry)
        rows.append(entry)

    def edge_quantize():
        n, worst = 0, 0.0
        for D_ in (1, 2048, 5000, 6145):
            xs = edge_stack(1, D_, D_)[0]
            got = ops.quantize(xs)
            want = ops.quantize(xs.cpu())
            worst = max(worst, max_err(got[:2], want[:2]))
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
        for K_ in (1, 3, 8, 17):
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

    f32, i8 = 4, 1
    row("quantize", "src/repro/kernels/quantize.py:39", quantize_kernel,
        quantize_ref, (x.cpu(),), (x,), 0.0,
        Dpad * f32 + Dpad * i8 + nblk * f32, 6 * Dpad, edge=edge_quantize)
    row("quantize_stack", "src/repro/kernels/quantize.py:74",
        quantize_stack_kernel, quantize_stack_ref, (stack.cpu(),), (stack,),
        0.0, K * (Dpad * f32 + Dpad * i8 + nblk * f32), 6 * K * Dpad,
        edge=edge_quantize_stack)
    q1, s1 = q8[0].contiguous(), s8[0].contiguous()
    row("dequantize", "src/repro/kernels/quantize.py:97", dequantize_kernel,
        dequantize_ref, (q1.cpu(), s1.cpu()), (q1, s1), 0.0,
        Dpad * i8 + nblk * f32 + Dpad * f32, Dpad,
        library=lambda: torch.mul(q1.view(-1, BLOCK_D), s1[:, None]),
        edge=edge_dequantize)
    fedavg_tol = 1e-6 * float(fused_agg_ref(q8.cpu(), s8.cpu(), w.cpu()).abs().max())
    row("fused_agg", "src/repro/kernels/fused_agg.py:111",
        lambda q, s, w_: fused_agg_kernel(q, s, w_),
        lambda q, s, w_: fused_agg_ref(q, s, w_),
        (q8.cpu(), s8.cpu(), w.cpu()), (q8, s8, w), fedavg_tol,
        K * Dpad * i8 + K * nblk * f32 + K * f32 + Dpad * f32, 4 * K * Dpad,
        edge=edge_fused)
    return rows


def phase_round(rows):
    import torch

    from repro_torch.api import build_runtime
    from repro_torch.core.aggregation import fedavg, flatten_updates
    from repro_torch.data.synthetic import make_femnist_like
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.tree import ravel_pytree

    t0 = time.perf_counter()
    ds = make_femnist_like(seed=1)
    emit(phase="data", seconds=time.perf_counter() - t0,
         clients=ds.num_clients, test=len(ds.test_labels))

    reset_launch_counts()
    t0 = time.perf_counter()
    rt = build_runtime(femnist_adapter(width=32), ds,
                       {"quantize_chain": True, "use_kernels": True, "seed": 0},
                       device="cuda")
    emit(phase="round_setup", seconds=time.perf_counter() - t0,
         dim=rt.chain.codec.dim, p_trainers=rt.p_trainers, q_committee=rt.q_committee,
         k=rt.cfg.k_updates)
    rounds = 3
    for _ in range(rounds):
        t0 = time.perf_counter()
        log = rt.run_round()
        torch.cuda.synchronize()
        emit(phase="round", seconds=time.perf_counter() - t0,
             timings=rt.stage_timings[-1], log=log.__dict__)
    t0 = time.perf_counter()
    acc = rt.evaluate()
    emit(phase="evaluate", seconds=time.perf_counter() - t0, test_accuracy=acc)
    check(0.0 <= acc <= 1.0, f"test accuracy {acc}")
    verified = rt.chain.verify()
    emit(phase="verify", ok=verified, height=rt.chain.height)
    check(verified, "chain.verify()")
    check(rt.chain.height == 1 + rounds * (rt.cfg.k_updates + 1), "chain height")

    # read back the last round's update blocks (dequantize kernel), then
    # re-aggregate them with the plain fedavg and the packed scores
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
    # a node publishing the committed delta through the chain codec
    blob = rt.chain.codec.encode(unravel(delta))
    codec_err = float((ravel_pytree(rt.chain.codec.decode(blob))[0]
                       - delta).abs().max())
    codec_step = float(blob["scales"].max())
    counts = launch_counts()
    emit(phase="readback", round=t, blocks=len(blobs),
         replay_max_abs_err=replay_err, quantization_step=step,
         codec_max_abs_err=codec_err, codec_half_step=0.5 * codec_step,
         launches=counts)
    check(replay_err <= step, f"replayed aggregate off by {replay_err} > {step}")
    check(codec_err <= 0.5 * codec_step * (1 + 1e-5) + 1e-12,
          f"codec round trip off by {codec_err}")
    need = {"quantize_stack": rounds, "fused_agg": rounds,
            "dequantize": len(blobs) + 1, "quantize": 1}
    for name, least in need.items():
        check(counts[name] >= least,
              f"{name} launched {counts[name]} times on the main path, "
              f"want >= {least}")
    for r in rows:
        r["launches"] = counts[r["name"]]
    return rt


def phase_profile(rt) -> None:
    """One more round under torch.profiler (``--profile`` only): device
    time by kernel, and the share of the round's wall time in which no
    kernel ran.  Profiling adds host time, so that share is an upper
    bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.run_round()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.self_device_time_total, e.key, e.count)
               for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(reverse=True)
    busy_s = sum(k[0] for k in kernels) / 1e6
    emit(phase="profile", wall_s=wall, device_busy_s=busy_s,
         idle_share=1.0 - busy_s / wall, timings=rt.stage_timings[-1],
         top=[{"kernel": k[:120], "us": us, "count": n}
              for us, k, n in kernels[:20]])


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    phase_card()
    phase_build()
    rows = phase_kernels()
    rt = phase_round(rows)
    if "--profile" in argv:
        phase_profile(rt)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit(kernels=[{k: r[k] for k in keys} for r in rows])
    print(nvidia_smi(), flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
