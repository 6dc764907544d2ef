"""The trace reader and the per-layer readers on made-up rounds; the whole
runner on a card (marked ``cuda``)."""
import json
import subprocess
import sys

import pytest

from bench import harness, profiler

ROOT = harness.ROOT


def test_merged():
    assert profiler.merged([(5, 6), (0, 2), (1, 3), (6, 7)]) == [[0, 3], [5, 7]]


def made_up_trace():
    # one round from 0 to 100 us: stage train 0-60, validate 60-100
    device = [("client_gemm_tile_kernel<A>", 10, 30),
              ("client_gemm_reduce_kernel", 25, 40),
              ("repro::fused_candidates_kernel", 70, 90),
              ("late", 150, 160)]
    host = [(profiler.ROUND_RANGE, 0, 100), ("stage.train", 0, 60),
            ("stage.validate", 60, 100)]
    return profiler.read_trace(device, host, wall_s=100e-6)


def test_read_trace():
    tr = made_up_trace()
    assert tr.busy_s == pytest.approx(50e-6)        # 10-40 and 70-90
    assert tr.time_of(("client_gemm_",)) == pytest.approx(35e-6)
    gaps = sorted(tr.gaps, key=lambda g: (round(g[1] * 1e6), g[0]))
    assert [g[0] for g in gaps] == ["train", "validate", "train"]
    assert [round(g[1] * 1e6) for g in gaps] == [10, 10, 30]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["client_gemm_tile_kernel<A>", pytest.approx(20e-6)]
    assert len(bd["idle_gaps"]) == 3


def made_up_run(trace=None):
    spec = harness.cell_spec("cnn_leaf_int8")
    run = harness.Run(spec=spec, family=harness.family(spec.config),
                      p_trainers=213, dim=6_603_710,
                      window_s=4.0, rounds=2,
                      timings=[{"train": 0.5, "validate": 1.0, "pack": 0.1,
                                "aggregate": 0.2, "sample": 0.01,
                                "elect": 0.02, "reward": 0.03}] * 2,
                      logs=[{"trainers": 213, "validations": 213 * 142}] * 2,
                      trace=trace,
                      traced_logs=[{"trainers": 213, "validations": 213 * 142}])
    return spec, run


def test_readers():
    spec, run = made_up_run()
    read = {m["name"]: harness.metric_reader(m["name"])(run)
            for m in spec.per_layer}
    assert read["stage_s.train"] == 0.5
    assert read["stage_s.host_other"] == pytest.approx(0.06)
    assert read["mfu"] == pytest.approx(
        100 * 2 * run.round_flops(run.logs[0]) / 4.0 / 67e12)
    # no trace: the trace's readers read nothing
    assert read["idle_share"] is None and read["client_gemm_roofline"] is None


def test_roofline_readers():
    from bench import counts

    tr = profiler.Trace(window_s=2.0, busy_s=1.5,
                        device_s={"client_gemm_tile_kernel<x>": 0.5,
                                  "repro::fused_candidates_kernel": 0.01})
    spec, run = made_up_run(tr)
    read = {m["name"]: harness.metric_reader(m["name"])(run)
            for m in spec.per_layer}
    assert read["idle_share"] == pytest.approx(25.0)
    assert read["client_gemm_roofline"] == pytest.approx(
        100 * 20 * counts.gemm_step_bound_s(213, 5, 32, 64, 2048, 62, 32)
        / 0.5)
    assert read["fused_candidates_roofline"] == pytest.approx(
        100 * counts.fused_candidates_bound_s(213, 6_603_710) / 0.01)


@pytest.mark.cuda
def test_runner_on_a_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cnn_leaf_int8",
         "--seed", "77", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert line["device"]["busy_s"] > 0
