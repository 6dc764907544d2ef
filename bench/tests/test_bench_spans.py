"""The readers of the program's spans and counters: on made-up rounds that
carry them, on rounds that do not (a program without spans: each reads
None), and on a tiny cell's window run on the CPU."""
from types import SimpleNamespace

import pytest

from bench import harness
from bench.tests.tiny import tiny_cnn

READERS = ("span_s.train.draw", "span_s.train.h2d", "span_s.train.steps",
           "span_s.validate.score", "span_s.validate.consensus",
           "span_s.chain.digest", "h2d_mb", "chain_hash_gbps")


class Entry(dict):
    """A round's stage seconds with the program's spans and counters."""

    def __init__(self, timings, spans, counts):
        super().__init__(timings)
        self.spans, self.counts = spans, counts


def total(host_s, device_s=None, parents=None):
    return SimpleNamespace(host_s=host_s, device_s=device_s,
                           parents=parents or {"round": host_s})


def made_up_entry(scale):
    timings = {"sample": 0.01, "train": 2.0, "validate": 2.5, "pack": 0.1,
               "aggregate": 0.06, "elect": 0.001, "reward": 0.001}
    spans = {
        "train.draw": total(0.5 * scale, parents={"train": 0.5 * scale}),
        "h2d": total(0.3 * scale, parents={"train": 0.2 * scale,
                                           "validate": 0.1 * scale}),
        "train.steps": total(0.01, 1.5 * scale, {"train": 0.01}),
        "validate.score": total(0.02, 2.25 * scale, {"validate": 0.02}),
        "validate.consensus": total(0.04 * scale,
                                    parents={"validate": 0.04 * scale}),
        "chain.digest": total(0.08 * scale, parents={"pack": 0.05 * scale,
                                                     "aggregate": 0.03 * scale}),
    }
    counts = {"h2d_bytes": int(456_600_000 * scale),
              "chain_hashed_bytes": int(80_000_000 * scale)}
    return Entry(timings, spans, counts)


def run_of(timings):
    spec = harness.cell_spec("cnn_leaf_int8")
    return harness.Run(spec=spec, family=harness.family(spec.config),
                       p_trainers=213, dim=6_603_710, window_s=10.0,
                       rounds=len(timings), timings=timings)


def test_the_readers_are_the_cells_metrics():
    spec = harness.cell_spec("cnn_leaf_int8")
    names = [m["name"] for m in spec.per_layer]
    assert set(READERS) <= set(names)
    for m in spec.per_layer:
        if m["name"] in READERS:
            assert m["source"] == "program_span" and m["moves"] == "round_s"


def test_readers_average_the_rounds():
    run = run_of([made_up_entry(1.0), made_up_entry(3.0)])
    read = {name: harness.metric_reader(name)(run) for name in READERS}
    assert read["span_s.train.draw"] == pytest.approx(1.0)
    assert read["span_s.train.h2d"] == pytest.approx(0.4)
    assert read["span_s.train.steps"] == pytest.approx(3.0)
    assert read["span_s.validate.score"] == pytest.approx(4.5)
    assert read["span_s.validate.consensus"] == pytest.approx(0.08)
    assert read["span_s.chain.digest"] == pytest.approx(0.16)
    assert read["h2d_mb"] == pytest.approx(913.2)
    # bytes over seconds, summed over the rounds: 320 MB in 0.32 s
    assert read["chain_hash_gbps"] == pytest.approx(1.0)


def test_readers_read_none_without_spans():
    plain = dict(made_up_entry(1.0))
    run = run_of([plain, dict(plain)])
    assert all(harness.metric_reader(name)(run) is None for name in READERS)


def test_device_readers_read_none_without_device_time():
    entry = made_up_entry(1.0)
    entry.spans["train.steps"].device_s = None
    entry.spans["validate.score"].device_s = None
    run = run_of([entry])
    assert harness.metric_reader("span_s.train.steps")(run) is None
    assert harness.metric_reader("span_s.validate.score")(run) is None
    assert harness.metric_reader("span_s.train.draw")(run) == pytest.approx(0.5)


def test_readers_on_a_tiny_cells_window():
    """The port's own entries, from a window of the tiny cell on the CPU:
    every host reader reads a number within its stage, the counters the
    round's bytes; the device readers read None on the CPU."""
    spec = tiny_cnn()
    out = harness.run_cell(spec, 11, 0.5, False, "cpu", 0.0)
    run = out["run"]
    assert run.rounds >= 1 and all(hasattr(t, "spans") for t in run.timings)
    read = {name: harness.metric_reader(name)(run) for name in READERS}
    assert read["span_s.train.steps"] is None
    assert read["span_s.validate.score"] is None
    stage = {k: sum(t[k] for t in run.timings) / run.rounds
             for k in ("train", "validate", "pack", "aggregate")}
    assert 0 < read["span_s.train.draw"] + read["span_s.train.h2d"] <= stage["train"]
    assert 0 < read["span_s.validate.consensus"] <= stage["validate"]
    assert 0 < read["span_s.chain.digest"] <= stage["pack"] + stage["aggregate"]
    assert read["h2d_mb"] > 0 and read["chain_hash_gbps"] > 0
