#!/usr/bin/env python3
"""The benchmark of the PyTorch / CUDA port: whole BFLC rounds on one GPU.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process runs one cell once (a cell of
BENCHMARK.json: a configuration under a traffic mix, see bench/README.md)
and prints one JSON line last on standard output: ``correct``,
``attempted`` and ``failed`` rounds, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number that
decides ``correct`` beside its limit, which also end standard error.  It
exits with another code than 0, printing no result, without enough CUDA
devices or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv) -> int:
    args = parse(argv)
    import torch

    from bench import harness

    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"run.py: {args.workload} needs {spec.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    result = harness.result_line(spec, out, bool(args.trace),
                                 torch.cuda.get_device_name(0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: loaded {', '.join(bad)}; the benchmark may not",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
