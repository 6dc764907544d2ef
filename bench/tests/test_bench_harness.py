"""BENCHMARK.json against the benchmark's contract, and the harness finding
every piece by name."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from bench import harness

ROOT = harness.ROOT
BM = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head_size|"
                    r"expansion|experts_per_tok|d_model|d_ff")


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BM) == KEYS["top"]
    assert len(json.dumps(BM).encode()) <= 64 * 1024
    assert 1 <= len(BM["paths"]) <= 16 and all(PATH.match(p) for p in BM["paths"])
    assert len(BM["command"]) <= 32 and all(line(w) for w in BM["command"])
    assert not any(w.startswith("/") or ".." in w for w in BM["command"])
    assert 1 <= BM["run_seconds"] <= 51 and isinstance(BM["run_seconds"], int)
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (BM["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for kind, items in (("config", BM["configs"]), ("workload", BM["workloads"]),
                        ("end_to_end", BM["end_to_end"])):
        assert 1 <= len(items) <= 24
        assert all(set(i) == KEYS[kind] for i in items), kind
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"]


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(kind):
    items = BM[kind]
    names = [i["name"] for i in items]
    assert len(set(names)) == len(names)
    for i in items:
        assert NAME.match(i["name"]), i["name"]
        if "unit" in i:
            assert UNIT.match(i["unit"]), i["unit"]
            assert i["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in i and kind != "end_to_end" and kind != "per_layer":
                assert line(i[key]), (i["name"], key)
        if kind == "per_layer":
            assert line(i["layer"])
        if kind == "configs":
            assert all(NAME.match(k) for k in i["reduced"])
            assert not any(WIDTHS.search(k) for k in i["reduced"]), i["reduced"]
            assert len(i["reduced"]) <= 16
        if kind == "workloads":
            assert NAME.match(i["config"]) and NAME.match(i["traffic"])
            assert i["chips"] in (1, 4)


def test_metric_names_unique_across_kinds():
    names = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(set(names)) == len(names)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics():
    e2e = {m["name"] for m in BM["end_to_end"]}
    cells = {w["name"] for w in BM["workloads"]}
    layers = {}
    for m in BM["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    # metrics of one layer name it letter for letter alike
    assert all(len(v) == 1 for v in layers.values()), layers


def test_every_cell_reports_what_it_must():
    for w in BM["workloads"]:
        spec = harness.cell_spec(w["name"])
        names = {m["name"] for m in spec.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer


def test_configs_used_and_under_paths():
    used = {w["config"] for w in BM["workloads"]}
    files = [c["file"] for c in BM["configs"]]
    assert {c["name"] for c in BM["configs"]} == used
    assert len(set(files)) == len(files)
    for c in BM["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BM["paths"])
        assert (ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://")


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BM["workloads"])
    assert four <= max(1, len(BM["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_harness_finds_every_piece(cell):
    spec = harness.cell_spec(cell)
    assert set(spec.limits) <= set(spec.driver.NUMBERS)
    fam = harness.family(spec.config)
    for attr in ("community", "weights", "program_adapter", "round_flops",
                 "REFERENCE"):
        assert hasattr(fam, attr), attr
    for m in spec.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    for key in ("driver", "validator", "bflc", "checked_rounds", "check_rows",
                "profiled_rounds"):
        assert key in spec.traffic
    for attr in ("set_up", "check", "readings", "NUMBERS"):
        assert hasattr(spec.driver, attr), attr


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    """A later PR adds a traffic file, a limits file and BENCHMARK.json
    entries, and edits nothing that is there."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bm = json.loads(json.dumps(BM))
    traffic = json.loads((ROOT / "bench/traffic/paper_int8.json").read_text())
    traffic["bflc"]["committee_fraction"] = 0.1
    (tmp_path / "bench/traffic/paper_q10_int8.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "bench/limits/cnn_leaf_int8.json",
                tmp_path / "bench/limits/cnn_leaf_q10_int8.json")
    bm["workloads"].append({"name": "cnn_leaf_q10_int8",
                            "config": "femnist_cnn_leaf",
                            "traffic": "paper_q10_int8", "chips": 1,
                            "why": "a committee of a tenth"})
    bm["per_layer"].append({"name": "stage_s.validate_copy", "unit": "s/round",
                            "better": "lower", "source": "program_span",
                            "layer": "committee", "moves": "round_s",
                            "workloads": ["cnn_leaf_q10_int8"]})
    shutil.copy(ROOT / "bench/metrics/stage_s.validate.py",
                tmp_path / "bench/metrics/stage_s.validate_copy.py")
    # a round of another kind brings a driver of its own
    traffic["driver"] = "flat_round_copy"
    (tmp_path / "bench/traffic/paper_q10_int8.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "bench/drivers/flat_round.py",
                tmp_path / "bench/drivers/flat_round_copy.py")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    spec = harness.cell_spec("cnn_leaf_q10_int8", tmp_path)
    assert spec.traffic["bflc"]["committee_fraction"] == 0.1
    assert spec.driver.__file__ == str(tmp_path / "bench/drivers/flat_round_copy.py")
    assert callable(spec.driver.set_up)
    assert spec.config["num_clients"] == 3550
    assert "stage_s.validate_copy" in {m["name"] for m in spec.per_layer}
    assert callable(harness.metric_reader("stage_s.validate_copy", tmp_path))


def test_runner_refuses_without_a_card(tmp_path):
    """No CUDA device here: a non-zero exit and no result line."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench/run.py"), "--workload",
         "cnn_leaf_int8", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_runner_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the runner exits non-zero and prints no result."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cnn_leaf_int8",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
