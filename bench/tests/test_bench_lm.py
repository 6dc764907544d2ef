"""The OLMo family and the streamed LM round's driver at a tiny size on the
CPU: the community's shape, the port judged correct, the faults and the
control caught, the new metrics read, and the reference loading nothing of
the port."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import harness
from bench.data import shakespeare
from bench.drivers import lm_round

ROOT = harness.ROOT


def tiny_olmo(root=ROOT):
    """The OLMo cell at a tiny width: 12 roles of 40-odd windows of 17
    tokens, 3 warm steps, P = 3, Q = 3, k = 2."""
    spec = harness.cell_spec("olmo1b_shakespeare_int8", root)
    spec.config["model"].update(d_model=64, num_units=2, num_heads=4, d_ff=128,
                                vocab_size=256)
    spec.config.update(num_clients=12, mean_chars=240.0, sd_chars=200.0,
                       seq=16, vocab_ids=250, text_ids=250, test_rows=4,
                       warm_steps=3, warm_batch=4)
    spec.traffic["bflc"].update(active_proportion=0.5)
    return spec


def test_shakespeare_population():
    spec = harness.cell_spec("olmo1b_shakespeare_int8")
    cfg = spec.config
    median, sigma = shakespeare.lognormal_of(cfg["mean_chars"], cfg["sd_chars"])
    assert median == pytest.approx(1931.87, abs=0.01)
    assert sigma == pytest.approx(1.1502, abs=1e-4)
    tokens = shakespeare.role_tokens(cfg, 7)
    assert len(tokens) == 1129 and tokens.min() == cfg["seq"] + 1
    assert int((tokens - cfg["seq"]).sum()) == 632479
    assert sorted(tokens) == sorted(shakespeare.role_tokens(cfg, 8))


def test_community_windows_at_a_stride_of_one():
    spec = tiny_olmo()
    com = shakespeare.make_community(spec.config, 5)
    assert len(com.client_images) == 12
    for x, y in zip(com.client_images, com.client_labels):
        assert x.shape == y.shape and x.shape[1] == 16
        np.testing.assert_array_equal(x[1:, :-1], x[:-1, 1:])
        np.testing.assert_array_equal(x[:, 1:], y[:, :-1])
        assert x.max() < 250
    again = shakespeare.make_community(spec.config, 5)
    np.testing.assert_array_equal(again.client_images[3], com.client_images[3])


def run(spec, hooks=None, seed=2 ** 31 + 11):
    out = harness.run_cell(spec, seed, 0.5, False, "cpu", 0.0, hooks=hooks)
    return harness.result_line(spec, out, False, "cpu"), out


def test_port_is_correct_at_a_tiny_size():
    line, out = run(tiny_olmo())
    assert line["correct"], out["numbers"]
    assert set(line["metrics"]) == {"round_s", "setup_s"}
    assert out["run"].p_trainers == 3


def test_new_metrics_read_a_streamed_window():
    spec = tiny_olmo()
    out = harness.run_cell(spec, 3, 0.5, False, "cpu", 0.0)
    run_ = out["run"]
    for name in ("span_s.train.quantize", "span_s.validate.rebuild",
                 "span_s.train.client"):
        assert harness.metric_reader(name)(run_) is None   # no device time
    assert harness.metric_reader("live_gb")(run_) == 0.0
    assert harness.metric_reader("mfu")(run_) > 0


def test_a_faulty_blob_and_score_are_caught():
    def hooks(rt):
        packer, validator = rt.pipeline.packer, rt.pipeline.validator

        def bad_packer(ctx):
            packer(ctx)
            blob = ctx.chain.blocks[-1].payload
            blob["q"][0] = blob["q"][0] + 1

        class BadValidator:
            def __getattr__(self, attr):
                return getattr(validator, attr)

            def __call__(self, ctx):
                validator(ctx)
                ctx.cohort_scores[0, 0] += 0.25

        rt.pipeline.packer, rt.pipeline.validator = bad_packer, BadValidator()

    line, out = run(tiny_olmo(), hooks)
    assert not line["correct"]
    assert out["numbers"]["blob_mismatch"] > 0
    assert out["numbers"]["chain_mismatch"] > 0


def test_readings_separate_the_control():
    spec = tiny_olmo()
    fam = harness.family(spec.config)
    setup = lm_round.set_up(spec, fam, 4, "cpu")
    r = lm_round.readings(setup, 4, "cpu")
    port, ctrl = r["port"], r["control"]
    assert port["update_gap"] < ctrl["update_gap"]
    assert 10 * port["row_gap"] < ctrl["row_gap"] < r["half_batch"]["row_gap"]
    assert port["blob_mismatch"] == port["chain_mismatch"] == 0
    assert r["half_batch"]["update_gap"] > 10 * port["update_gap"]
    assert r["score_altered"]["score_gap"] > port["score_gap"]


def test_the_lm_reference_loads_nothing_of_the_port():
    probe = (f"import sys; sys.path[:0] = [{str(ROOT)!r}]\n"
             "import bench.reference.olmo, bench.reference.olmo_judge\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=ROOT, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"repro_torch", *harness.FORBIDDEN}
