"""The benchmark's machinery, driven by the data files under bench/.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the model family, its sizes and the community) and a traffic mix
(``traffic/<name>.json``: the round protocol the port runs, the driver
that sets it up and judges it, and how many rounds are checked, sampled
and profiled); ``limits/<cell>.json`` holds the limits of the numbers
that decide ``correct``, ``families/<family>.py`` makes a configuration's
data and weights, ``drivers/<driver>.py`` builds the port's runtime, runs
and records the checked rounds and judges them after the window, and
``metrics/<metric>.py`` reads each per-layer metric.  Nothing here names a
cell, a family or a driver.

One run: the driver's set-up; the same runtime then runs whole rounds back
to back for the window; with ``trace`` the window is followed by profiled
rounds; the device's peak is read; the driver's check judges the checked
rounds.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bench import profiler

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def note(what: str, t0: float) -> float:
    """One progress line on standard error; returns the clock."""
    now = time.perf_counter()
    print(f"bench: {what} {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now


# ----------------------------------------------------------------------
# finding the pieces by name
# ----------------------------------------------------------------------
def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def entry(items: List[dict], name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r}")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class CellSpec:
    root: Path
    workload: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int

    @property
    def driver(self):
        return load_piece("drivers", self.traffic["driver"], self.root)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_spec(workload: str, root: Path = ROOT) -> CellSpec:
    bm = load_benchmark(root)
    cell = entry(bm["workloads"], workload, "workload")
    conf = entry(bm["configs"], cell["config"], "configuration")
    bench = root / "bench"
    return CellSpec(
        root=root, workload=workload,
        config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bm["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bm["per_layer"] if applies(m, workload)],
        chips=cell["chips"])


def load_piece(kind: str, name: str, root: Path = ROOT):
    """``bench/<kind>/<name>.py`` of the checkout at ``root``, loaded from
    its file (once), so that a piece a later PR adds is found by its name
    alone."""
    path = root / "bench" / kind / f"{name}.py"
    key = f"bench.piece:{path}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def family(config: dict, root: Path = ROOT):
    return load_piece("families", config["family"], root)


def metric_reader(name: str, root: Path = ROOT):
    return load_piece("metrics", name, root).read


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------
@dataclass
class Run:
    """What the per-layer readers read: the window's rounds (unprofiled)
    and, with a trace, the profiled rounds."""

    spec: CellSpec
    family: object
    p_trainers: int
    dim: int
    window_s: float = 0.0
    rounds: int = 0
    timings: List[Dict[str, float]] = field(default_factory=list)
    logs: List[dict] = field(default_factory=list)
    trace: Optional[profiler.Trace] = None
    traced_logs: List[dict] = field(default_factory=list)

    def round_flops(self, log: dict) -> float:
        return self.family.round_flops(self.spec.config, self.spec.traffic["bflc"],
                                       log["trainers"], log["validations"])


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_window(rt, seconds: float, device):
    """Whole rounds back to back.  A round starts while the last one's
    length still fits before ``seconds``; the window ends at the last round
    boundary at or before ``seconds`` (a round that overruns is left out,
    unless it is the only one).  Returns (window seconds, rounds, index of
    the window's first round in the runtime's records)."""
    first = len(rt.stage_timings)
    synchronize(device)
    t0 = time.perf_counter()
    ends: List[float] = []
    while True:
        rt.run_round()
        now = time.perf_counter() - t0
        if now > seconds and ends:
            break
        ends.append(now)
        last = now - (ends[-2] if len(ends) > 1 else 0.0)
        if now + last > seconds:
            break
    return ends[-1], len(ends), first


def log_dict(log) -> dict:
    return {"trainers": log.trainers, "validations": log.consensus_validations}


def run_cell(spec: CellSpec, seed: int, seconds: float, trace: bool,
             device, t_start: float, hooks=None) -> dict:
    """One run of a cell; returns what the result line is made of."""
    fam, driver = family(spec.config, spec.root), spec.driver
    setup = driver.set_up(spec, fam, seed, device, hooks)
    setup_s = time.perf_counter() - t_start
    rt = setup.rt
    run = Run(spec=spec, family=fam, p_trainers=rt.p_trainers, dim=setup.dim)
    run.window_s, run.rounds, first = run_window(rt, seconds, device)
    last = first + run.rounds
    run.timings = rt.stage_timings[first:last]
    per_round = sorted(sum(t_.values()) for t_ in run.timings)
    note(f"window of {run.rounds} rounds (stage sums {per_round[0]:.3f} to "
         f"{per_round[-1]:.3f} s)", time.perf_counter() - run.window_s)
    run.logs = [log_dict(lg) for lg in rt.logs[first:last]]
    if trace:
        t = time.perf_counter()
        before = len(rt.logs)
        run.trace = profiler.profile_rounds(
            rt.run_round, spec.traffic["profiled_rounds"], rt.pipeline)
        run.traced_logs = [log_dict(lg) for lg in rt.logs[before:]]
        note("profiled rounds", t)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    del rt
    numbers = driver.check(setup, seed, device)
    return {"setup_s": setup_s, "run": run, "numbers": numbers,
            "memory_peak_bytes": peak}


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among the loaded modules (or ``names``) that the
    benchmark may not load, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def end_to_end(name: str, out: dict) -> float:
    run = out["run"]
    if name == "round_s":
        return run.window_s / run.rounds
    if name == "setup_s":
        return out["setup_s"]
    raise KeyError(f"no end-to-end metric named {name!r}")


def result_line(spec: CellSpec, out: dict, trace: bool, device_name: str) -> dict:
    run = out["run"]
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        value = (metric_reader(m["name"], spec.root)(run) if trace
                 else end_to_end(m["name"], out))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": out["numbers"][name], "limit": limit}
              for name, limit in spec.limits.items()}
    device = {"platform": "gpu", "kind": device_name, "count": spec.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": run.rounds, "failed": 0, "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result
