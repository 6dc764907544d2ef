"""The round's spans and counters (``repro_torch.spans``): the recorder on
its own, the profiler mirror, a CPU round's spans and counters against
what the round moved and hashed, a round recorded into no recorder, and
chip_smoke's reading of a profiled round by the mirrored spans."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.api import build_runtime
from repro_torch.data import make_femnist_like
from repro_torch.fl.adapter import femnist_adapter
from repro_torch.fl.pipeline import STAGE_TIMING_KEYS
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

SMALL = dict(active_proportion=0.5, k_updates=3, local_steps=2,
             local_batch=8, val_batch=16)
INT8 = dict(SMALL, quantize_chain=True, use_kernels=True)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.fixture(scope="module")
def tiny_ds():
    return make_femnist_like(num_clients=12, mean_samples=20, test_size=64,
                             seed=2)


def runtime(ds, cfg=INT8, **kw):
    kw.setdefault("stages", {"validator": "committee_int8"}
                  if cfg.get("quantize_chain") else None)
    return build_runtime(femnist_adapter(8), ds, cfg, device="cpu", **kw)


class RecordFunctionSpy:
    """Stands in for ``torch.profiler.record_function``, counting entries."""

    entered = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        RecordFunctionSpy.entered.append(self.name)

    def __exit__(self, *exc):
        return False


# ----------------------------------------------------------------------
# the recorder alone
# ----------------------------------------------------------------------
def recorded_round():
    rec = spans.Recorder("cpu")
    timings = {}
    with spans.recording(rec):
        with spans.stage("train", timings):
            with spans.span("train.draw"):
                with spans.span("h2d"):
                    spans.count("h2d_bytes", 10)
            with spans.span("h2d"):
                spans.count("h2d_bytes", 5)
            with spans.span("train.steps", device=True):
                pass
        with spans.stage("pack", timings):
            with spans.span("chain.digest"):
                spans.count("chain_hashed_bytes", 7)
    return rec.entry(timings)


def test_nesting_and_parent_names():
    entry = recorded_round()
    got = {name: set(tot.parents) for name, tot in entry.spans.items()}
    assert got == {"train": {"round"}, "train.draw": {"train"},
                   "h2d": {"train.draw", "train"}, "train.steps": {"train"},
                   "pack": {"round"}, "chain.digest": {"pack"}}
    # a name's host seconds are the sum of its seconds under each parent
    h2d = entry.spans["h2d"]
    assert h2d.host_s == pytest.approx(sum(h2d.parents.values()), abs=1e-12)
    # on the CPU a device span records no device time
    assert entry.spans["train.steps"].device_s is None


def test_host_seconds_nest_within_the_parent():
    entry = recorded_round()
    for name, tot in entry.spans.items():
        assert tot.host_s >= 0
        for parent, host_s in tot.parents.items():
            assert host_s >= 0
            if parent != spans.ROOT:
                assert host_s <= entry.spans[parent].host_s, (name, parent)
    # a stage's span is its timing
    for key in ("train", "pack"):
        assert entry.spans[key].host_s == pytest.approx(entry[key], abs=1e-9)


def test_counters_sum_and_nothing_is_kept_outside_a_round():
    entry = recorded_round()
    assert entry.counts == {"h2d_bytes": 15, "chain_hashed_bytes": 7}
    spans.count("h2d_bytes", 99)                    # no round: nothing
    with spans.span("orphan") as s:
        assert s is not None
    rec = spans.Recorder("cpu")
    with spans.recording(rec):
        spans.count("h2d_bytes", 1)
        spans.count("h2d_bytes", 2)
    second = rec.entry({})
    assert second.counts == {"h2d_bytes": 3} and second.spans == {}


def test_stage_times_without_a_recorder_and_not_on_a_raise():
    timings = {}
    with spans.stage("validate", timings):
        pass
    with spans.stage("validate", timings):
        pass
    assert set(timings) == {"validate"} and timings["validate"] >= 0
    before = timings["validate"]
    with pytest.raises(ValueError):
        with spans.stage("validate", timings):
            raise ValueError("stage failed")
    assert timings["validate"] == before


def test_recording_restores_the_outer_recorder():
    outer, inner = spans.Recorder("cpu"), spans.Recorder("cpu")
    with spans.recording(outer):
        with spans.recording(inner):
            spans.count("n", 1)
        with spans.recording(None):           # no recorder inside: nothing
            spans.count("n", 10)
        spans.count("n", 100)
    assert inner.entry({}).counts == {"n": 1}
    assert outer.entry({}).counts == {"n": 100}
    assert spans._ACTIVE.get() is None


def test_no_record_function_without_a_profiler(monkeypatch):
    RecordFunctionSpy.entered = []
    monkeypatch.setattr(torch.profiler, "record_function", RecordFunctionSpy)
    recorded_round()
    assert RecordFunctionSpy.entered == []


def test_the_mirror_opens_while_a_profiler_runs(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    RecordFunctionSpy.entered = []
    monkeypatch.setattr(torch.profiler, "record_function", RecordFunctionSpy)
    with profile(activities=[ProfilerActivity.CPU]):
        recorded_round()
    assert RecordFunctionSpy.entered == [
        "bflc.train", "bflc.train.draw", "bflc.h2d", "bflc.h2d",
        "bflc.train.steps", "bflc.pack", "bflc.chain.digest"]


# ----------------------------------------------------------------------
# a CPU round
# ----------------------------------------------------------------------
def test_profiled_round_holds_the_mirrored_spans(tiny_ds):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rt = runtime(tiny_ds)
    rt.run_round()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rt.run_round()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU}
    assert {"bflc.train", "bflc.train.draw", "bflc.h2d", "bflc.train.steps",
            "bflc.validate", "bflc.validate.score", "bflc.validate.consensus",
            "bflc.chain.digest"} <= names
    assert not any(n.startswith("stage.") or n == "bench.round" for n in names)


@pytest.mark.parametrize("schedule", ("sequential", "async"))
def test_round_entry_keys_and_spans_within_their_stage(tiny_ds, schedule):
    rt = runtime(tiny_ds, schedule=schedule)
    rt.run_round()
    entry = rt.stage_timings[0]
    assert set(entry) == set(STAGE_TIMING_KEYS)
    assert isinstance(entry, spans.RoundTimings)
    for name in ("train.draw", "h2d", "train.steps", "validate.score",
                 "validate.consensus", "chain.digest"):
        assert name in entry.spans, name
    for name, total in entry.spans.items():
        if name in STAGE_TIMING_KEYS:
            assert total.host_s == pytest.approx(entry[name], rel=1e-6)
            continue
        for parent, host_s in total.parents.items():
            assert parent in STAGE_TIMING_KEYS, (name, parent)
            assert host_s <= entry[parent], (name, parent)
    assert entry.spans["train.draw"].parents.keys() == {"train"}
    assert entry.spans["validate.score"].parents.keys() == {"validate"}
    assert set(entry.spans["chain.digest"].parents) == {"pack", "aggregate"}


@pytest.mark.parametrize("cfg", (INT8, SMALL), ids=("int8", "f32"))
def test_h2d_bytes_are_the_rounds_batches(tiny_ds, cfg):
    rt = runtime(tiny_ds, cfg)
    committee = list(rt.committee)
    log = rt.run_round()
    counts = rt.stage_timings[0].counts
    c = rt.cfg
    # the batches are gathered on the device: only their int64 row
    # indices go over
    trainers = log.trainers * c.local_steps * c.local_batch
    members = len(committee) * c.val_batch
    # the aggregation's score weights go over too: k float32
    weights = c.k_updates * 4
    assert counts["h2d_bytes"] == 8 * (trainers + members) + weights
    assert counts["gathered_rows"] == trainers + members


@pytest.mark.parametrize("cfg", (INT8, SMALL), ids=("int8", "f32"))
def test_chain_hashed_bytes_are_the_rounds_payloads(tiny_ds, cfg):
    rt = runtime(tiny_ds, cfg)
    for t in range(2):
        height = rt.chain.height
        rt.run_round()
        payload_bytes = sum(
            (leaf.nbytes if isinstance(leaf, torch.Tensor)
             else np.asarray(leaf).nbytes)
            for blk in rt.chain.blocks[height:]
            for leaf in tree_leaves(blk.payload))
        assert rt.stage_timings[t].counts["chain_hashed_bytes"] == payload_bytes
    # a digest outside a round (a joining node's verify) counts nothing
    assert rt.chain.verify()
    assert rt.stage_timings[1].counts["chain_hashed_bytes"] == payload_bytes


@pytest.mark.parametrize("baseline", (False, True))
def test_a_round_recorded_into_no_recorder(tiny_ds, baseline, monkeypatch):
    """``recording(None)`` around a round records nothing and changes
    nothing the round computes."""
    from repro_torch.fl import baselines, runtime as fl_runtime

    cfg = dict(seed=0) if baseline else INT8
    kw = {} if baseline else {"stages": {"validator": "committee_int8"}}
    on = build_runtime(femnist_adapter(8), tiny_ds, cfg, baseline=baseline,
                       device="cpu", **kw)
    on.run_round()
    off = build_runtime(femnist_adapter(8), tiny_ds, cfg, baseline=baseline,
                        device="cpu", **kw)
    module = baselines if baseline else fl_runtime
    monkeypatch.setattr(module, "recording", lambda rec: spans.recording(None))
    off.run_round()
    a, b = on.stage_timings[0], off.stage_timings[0]
    assert set(a) == set(b) == set(STAGE_TIMING_KEYS)
    assert b.spans == {} and b.counts == {}
    assert "train.draw" in a.spans and a.counts["h2d_bytes"] > 0
    pa, pb = ((on.params, off.params) if baseline else
              (on.global_params(), off.global_params()))
    for x, y in zip(tree_leaves(pa), tree_leaves(pb)):
        assert torch.equal(x, y)


# ----------------------------------------------------------------------
# chip_smoke's reading of a profiled round
# ----------------------------------------------------------------------
def test_chip_smoke_names_idle_gaps_by_the_innermost_span():
    # a round of 0-100 ms (us): train 0-60 holding draw 0-30 and h2d
    # 30-40, validate 60-100 holding consensus 90-100; busy 45-55, 60-88
    ms = 1000
    spans_ = [("train", 0, 60 * ms), ("train.draw", 0, 30 * ms),
              ("h2d", 30 * ms, 40 * ms), ("validate", 60 * ms, 100 * ms),
              ("validate.consensus", 90 * ms, 100 * ms)]
    busy = [[45 * ms, 55 * ms], [60 * ms, 88 * ms]]
    got = chip_smoke.read_spans(busy, spans_, {"train": 0.07, "validate": 0.05})
    assert [(g["span"], round(g["s"], 6)) for g in got["gaps"]] == [
        ("train.draw", 0.045), ("validate.consensus", 0.012)]
    assert got["idle_by_span"] == pytest.approx(
        {"train.draw": 0.045, "train": 0.005, "validate.consensus": 0.012})
    idle = got["train_idle"]
    assert idle["idle_s"] == pytest.approx(0.050)
    assert idle["in_draw_or_h2d_s"] == pytest.approx(0.040)
    assert idle["share"] == pytest.approx(0.8)
    assert got["stages"]["train"]["device_busy_s"] == pytest.approx(0.010)
    assert got["stages"]["validate"]["profiled_s"] == pytest.approx(0.040)


def test_chip_smoke_intersect():
    assert chip_smoke.intersect([[0, 5], [8, 12]], [[3, 9], [11, 20]]) == [
        [3, 5], [8, 9], [11, 12]]
    assert chip_smoke.length([[0, 2], [5, 6]]) == 3
