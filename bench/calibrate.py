#!/usr/bin/env python3
"""Readings that the limits of a cell's ``correct`` are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--out FILE]

For each seed, in one process: the cell's set-up and checked rounds (no
window), then one JSON line with the cell's driver's readings
(``readings`` of ``bench/drivers/<driver>.py``): the port's, the
control's (the reference in TF32 in the port's place) and those of
planted faults.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from bench import harness

    spec = harness.cell_spec(args.workload)
    fam, driver = harness.family(spec.config), spec.driver
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        setup = driver.set_up(spec, fam, seed, args.device)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           **driver.readings(setup, seed, args.device)})
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
