#!/usr/bin/env python3
"""Runs the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU
    python3 chip_smoke.py --profile  # also profile one more round

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
  kernel_k90  the shared-memory sorts at K = 90 (f32 and fused int8), which
           no path runs
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
           baselines  build_runtime(..., baseline=True): 2 rounds each of
                    Basic FL (fedavg) and CwMed over 90 clients, then 20
                    steps of train_standalone: finite params that moved,
                    test accuracies in [0, 1], no kernel launched (the
                    baselines aggregate with the plain reductions)
Then the ``kernels`` summary line, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; without CUDA it exits 2.
"""
from __future__ import annotations

import functools
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
}


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


def build(ds, cfg: dict, stages=None):
    from repro_torch.api import build_runtime
    from repro_torch.fl.adapter import femnist_adapter

    return build_runtime(femnist_adapter(width=32), ds, {**cfg, "seed": 0},
                         stages=stages, device="cuda")


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


def path_baselines(ds) -> None:
    """The committee-free baselines at full width through
    build_runtime(..., baseline=True): Basic FL (fedavg) and CwMed, 2
    rounds each of 90 clients, then 20 steps of train_standalone.  Like the
    reference's, the baselines aggregate with the plain reductions, so no
    kernel may launch.  Checked: finite params that moved from the init,
    test accuracies in [0, 1]."""
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
    check(not any(counts.values()), "a baseline launched a kernel")


def phase_profile(path: str, rt) -> None:
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
    emit(phase="profile", path=path, wall_s=wall, device_busy_s=busy_s,
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
    from repro_torch.data.synthetic import make_femnist_like

    t0 = time.perf_counter()
    ds = make_femnist_like(seed=1)
    emit(phase="data", seconds=time.perf_counter() - t0,
         clients=ds.num_clients, test=len(ds.test_labels))
    paths = {"int8": path_int8(ds), "int8_committee": path_int8_committee(ds)}
    for m in ("cwmed", "trimmed_mean"):
        paths[f"int8_{m}"] = path_int8_sort(ds, m)
    for m in ("fedavg", "cwmed", "trimmed_mean"):
        paths[f"f32_{m}"] = path_f32(ds, m)
    path_baselines(ds)
    for r in rows:
        r["launches"] = sum(c[r["name"]] for c, _ in paths.values())
        check(r["launches"] > 0, f"{r['name']} was launched on no path")
    if "--profile" in argv:
        for name, (_, rt) in paths.items():
            phase_profile(name, rt)
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
