#!/usr/bin/env python3
"""This tree's local-trainer products and train stage beside another
checkout's, on one GPU.

    python3 chip_compare.py --against DIR [--turns 2] [--ticks ARCH,...]

Runs the checkouts in turns (DIR, this tree, this tree, DIR for --turns 2),
one process each, with the checkout's ``src`` on PYTHONPATH and its own
``chip_smoke.py`` loaded.  Each turn (1) times the checkout's
``client_gemm_kernel`` at this tree's ``chip_smoke.GEMM_FORMS`` (P = 54),
called as that checkout's trainer calls it: a wrapper without ``ones_row``
makes each bias gradient a product of its own with an expanded ones row;
(2) runs the flat int8 path (the checkout's ``path_int8``, 4 more rounds
and one profiled round) and reports its train-stage seconds and the
device's busy time in the profiled one.  Every turn's products must be the
same bits (by value) as the first's.  With ``--ticks`` each turn instead
builds each named registry arch at full width (f32, seed 0, on the card)
and runs the checkout's ``decode_tick`` on it: a decode step's host ms,
event ms, device busy ms and kernels at 1 and 4 rows.  Every line is one
JSON object; the last two are nvidia-smi's name and power limit and
{"ok": true}.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))


def gemm_rows(client_gemm_kernel) -> list:
    """The checkout's products at GEMM_FORMS: ms a call and a digest of the
    output by value (+0.0 turns a -0.0 into +0.0)."""
    import torch

    folded = "ones_row" in inspect.signature(client_gemm_kernel).parameters
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for entry in cs.GEMM_FORMS:
        form, (_, K, _), _, _, _, ones = entry
        a, b, bias = cs.gemm_operands(entry, g)
        if not ones:
            calls = [lambda: client_gemm_kernel(a, b, bias)]
        elif folded:
            calls = [lambda: client_gemm_kernel(a, b, ones_row=True)]
        else:
            ones_a = b.new_ones(()).expand(cs.MAIN_P, 1, K)
            calls = [lambda: client_gemm_kernel(a, b),
                     lambda: client_gemm_kernel(ones_a, b)]
        out = torch.cat([c() for c in calls], 1) + 0.0
        rows.append({"form": form, "calls_ms": [cs.time_ms(c) for c in calls],
                     "digest": hashlib.sha256(out.cpu().numpy().tobytes())
                     .hexdigest()})
        del a, b, bias, out, calls
    return rows


def turn(root: str, ticks: str) -> None:
    """One turn on the checkout at ``root``, in this process."""
    spec = importlib.util.spec_from_file_location(
        "checkout_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if ticks:
        tick_turn(smoke, ticks.split(","))
        return
    from repro_torch.data.synthetic import make_femnist_like
    from repro_torch.kernels.client_gemm import client_gemm_kernel

    for row in gemm_rows(client_gemm_kernel):
        cs.emit(phase="gemm", **row)
    _, rt = smoke.path_int8(make_femnist_like(seed=1))
    smoke.run_rounds("int8_more", rt, 4)
    smoke.phase_profile("int8", rt)


def tick_turn(smoke, archs) -> None:
    """The checkout's ``decode_tick`` on each arch at full width."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import init_model

    for arch in archs:
        cfg = registry.get_config(arch)
        params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
        smoke.decode_tick(cfg, params, path=arch)
        del params
        torch.cuda.empty_cache()


def compare(against: str, turns: int, ticks: str) -> None:
    trees = [os.path.abspath(against), ROOT]
    order = [trees[(i + i // 2) % 2] for i in range(2 * turns)]
    first = None
    for n, root in enumerate(order):
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root, "--ticks", ticks],
                              capture_output=True, text=True, env=env,
                              timeout=1200)
        cs.check(proc.returncode == 0, f"turn {n} ({root}) failed:\n"
                                       f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        lines = [json.loads(x) for x in proc.stdout.splitlines()
                 if x.startswith("{")]
        tree = os.path.relpath(root, ROOT)
        if ticks:
            for x in lines:
                if x.get("phase") == "decode_tick":
                    x.pop("top", None)
                    cs.emit(**dict(x, turn=n, tree=tree))
            continue
        gemm = [x for x in lines if x.get("phase") == "gemm"]
        digests = [x["digest"] for x in gemm]
        first = first or digests
        cs.check(digests == first, f"turn {n} ({root}): products differ")
        train = [x["timings"]["train"] for x in lines if x.get("phase") == "round"]
        profile = next(x for x in lines if x.get("phase") == "profile")
        stage = profile["stages"]["train"]
        for x in gemm:
            cs.emit(phase="gemm", turn=n, tree=tree, form=x["form"],
                    calls_ms=x["calls_ms"], ms=sum(x["calls_ms"]))
        cs.emit(phase="gemm_step", turn=n, tree=tree, calls=sum(
            len(x["calls_ms"]) for x in gemm), ms=sum(
            sum(x["calls_ms"]) for x in gemm), equal_to_first_turn=True)
        cs.emit(phase="train_turn", turn=n, tree=tree, train_s=train,
                steady_train_s=train[1:], profiled_train_s=stage["profiled_s"],
                train_device_busy_s=stage["device_busy_s"],
                busy_share_profiled=stage["device_busy_s"] / stage["profiled_s"],
                round_device_busy_s=profile["device_busy_s"],
                round_idle_share=profile["idle_share"])


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--ticks", default="",
                    help="comma-separated registry archs: compare decode ticks")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        turn(args.turn, args.ticks)
        return 0
    if not args.against:
        ap.error("--against DIR is required")
    compare(args.against, args.turns, args.ticks)
    print(cs.nvidia_smi(), flush=True)
    cs.emit(ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
