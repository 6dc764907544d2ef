"""The plain reference against the port at a tiny size on the CPU, and the
check that decides ``correct`` failing on the faults a round can have and
on the control."""
import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import chain as chain_ref
from bench.reference import cnn as cnn_ref
from bench.reference.precision import Precision, tf32_round
from bench.reference.round import consensus, count_gap, label_margins
from bench.reference.tree import paths, tree_map
from tiny import tiny_cnn

F32 = Precision("f32", "cpu")


def run(spec, hooks=None, seed=11):
    out = harness.run_cell(spec, seed, 0.5, False, "cpu", 0.0, hooks=hooks)
    line = harness.result_line(spec, out, False, "cpu")
    return line, out["numbers"]


def test_port_is_correct_at_a_tiny_size():
    line, numbers = run(tiny_cnn())
    assert line["correct"], numbers
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"round_s", "setup_s"}
    assert line["attempted"] >= 1


@pytest.mark.parametrize("kernel", [5, 3])
def test_cnn_logits_and_training_match_the_port(kernel):
    from repro_torch.configs import femnist_cnn
    from repro_torch.fl.adapter import femnist_adapter
    from repro_torch.fl.client import make_local_train_fn

    spec = tiny_cnn()
    spec.config["kernel"] = kernel
    fam = harness.family(spec.config)
    g = torch.Generator().manual_seed(3)
    w = fam.weights(spec.config, None, g, "cpu")
    w["conv1"]["b"] = torch.randn(w["conv1"]["b"].shape, generator=g) * 0.1
    x = torch.randn((6, 28, 28, 1), generator=g)
    torch.testing.assert_close(cnn_ref.logits(w, x, F32),
                               femnist_cnn.apply(w, x), rtol=1e-5, atol=1e-5)
    xs = torch.randn((3, 2, 5, 28, 28, 1), generator=g)
    ys = torch.randint(0, 4, (3, 2, 5), generator=g)
    port = make_local_train_fn(femnist_adapter(4), 0.02, 0.9)(w, xs, ys)
    ref = cnn_ref.train(w, xs, ys, 0.02, 0.9, F32)
    ref64 = cnn_ref.train(w, xs, ys, 0.02, 0.9, Precision("f64", "cpu"))
    for (_, a), (_, b), (_, c) in zip(paths(port), paths(ref), paths(ref64)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
        assert c.dtype == torch.float64
        torch.testing.assert_close(a.double(), c, rtol=1e-4, atol=1e-6)


def test_leaf_weights_are_glorot_uniform():
    spec = harness.cell_spec("cnn_leaf_int8")
    fam = harness.family(spec.config)
    w = fam.weights(spec.config, None, torch.Generator().manual_seed(0), "cpu")
    fc1 = w["fc1"]["w"]
    limit = (6.0 / (3136 + 2048)) ** 0.5
    assert fc1.shape == (3136, 2048)
    assert float(fc1.abs().max()) <= limit
    assert float(fc1.abs().max()) > 0.99 * limit
    assert float(fc1.std()) == pytest.approx(limit / 3 ** 0.5, rel=1e-2)
    assert all(float(w[layer]["b"].abs().max()) == 0.0
               for layer in ("conv1", "conv2", "fc1", "fc2"))


def test_codec_and_hashes_match_the_port():
    from repro_torch.core.blockchain import Block, pytree_digest
    from repro_torch.kernels.ops import quantize_stack

    g = torch.Generator().manual_seed(5)
    rows = torch.randn((3, 5000), generator=g) * 1e-3
    rows[1, 2048:4096] = 0.0
    q, s, d = quantize_stack(rows)
    q2, s2 = chain_ref.quantize(rows)
    assert torch.equal(q, q2) and torch.equal(s, s2) and d == 5000
    blob = {"q": q[0], "scales": s[0], "d": d}
    leaves = [(p, np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v))
              for p, v in paths(blob)]
    assert chain_ref.digest(leaves) == pytree_digest(blob)
    blk = Block(index=3, kind="update", round=0, prev_hash="ab",
                payload_digest="cd", uploader=7, score=0.5, encoded=True)
    assert chain_ref.block_hash(vars(blk)) == blk.compute_hash()


def test_consensus_rules():
    rows = [(5, [0.5, 0.6, 0.7]), (6, [0.1, 0.2, 0.1]), (7, [0.9, 0.8, 0.9])]
    # 6's median 0.1 is under half of the running mean 0.6: rejected
    assert consensus(rows, 0.5, 2) == [(7, 0.9), (5, 0.6)]
    assert consensus(rows, 0.5, 3) == [(7, 0.9), (5, 0.6), (7, 0.9)]


def test_count_gap_and_margins():
    m = torch.tensor([0.5, 0.1, -0.2, -1.0])
    assert count_gap(m, 2) == 0.0
    assert count_gap(m, 3) == pytest.approx(0.2)
    assert count_gap(m, 1) == pytest.approx(0.1)
    lg = torch.tensor([[1.0, 3.0, 2.0], [5.0, 1.0, 0.0]])
    assert torch.equal(label_margins(lg, torch.tensor([1, 1])),
                       torch.tensor([1.0, -4.0]))


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -9, 3.0])
    assert torch.equal(tf32_round(x), torch.tensor([1.0, 1.0 + 2 ** -9, 3.0]))


# ----------------------------------------------------------------------
# faults: each must come out as not correct
# ----------------------------------------------------------------------
def unchanged_state(rt):
    """The aggregator commits the round's model unchanged."""
    from repro_torch.fl import pipeline

    def aggregate(ctx):
        pipeline._commit_aggregate(
            ctx, tree_map(torch.zeros_like, ctx.params))

    rt.pipeline.aggregator = aggregate


def half_batch(rt):
    """Local training on the first half of each batch."""
    train = rt._local_train

    def halved(params, xs, ys):
        b = xs.shape[2] // 2
        return train(params, xs[:, :, :b], ys[:, :, :b])

    rt._local_train = halved


def score_altered(rt):
    """Member 0's scores raised by one hit where they are produced."""
    score = rt._int8_score

    def altered(params, stack, vx, vy):
        s, q, sc = score(params, stack, vx, vy)
        s = s.clone()
        s[:, 0] = torch.where(s[:, 0] < 1, s[:, 0] + 1.0 / vy.shape[1],
                              s[:, 0] - 1.0 / vy.shape[1])
        return s, q, sc

    rt._int8_score = altered


def blob_altered(rt):
    """Lane 0 of every quantized row off by one where it is produced."""
    score = rt._int8_score

    def altered(params, stack, vx, vy):
        s, q, sc = score(params, stack, vx, vy)
        q = q.clone()
        q[:, 0] = torch.where(q[:, 0] < 127, q[:, 0] + 1, q[:, 0] - 1)
        return s, q, sc

    rt._int8_score = altered


def one_slot_off(rt):
    """One trainer's update half again as large as it should be where the
    trainer makes it: a fault in one client slot of the stacked trainer."""
    train = rt._local_train

    def scaled(params, xs, ys):
        out = train(params, xs, ys)
        return tree_map(lambda a: torch.cat([a[:1] * 1.5, a[1:]]), out)

    rt._local_train = scaled


@pytest.mark.parametrize("fault,number", [
    (unchanged_state, "model_gap"), (half_batch, "update_gap"),
    (half_batch, "update_gap_median"), (one_slot_off, "update_gap"),
    (score_altered, "score_gap"), (blob_altered, "blob_mismatch")])
def test_a_fault_is_not_correct(fault, number):
    line, numbers = run(tiny_cnn(), hooks=fault)
    assert not line["correct"]
    assert numbers[number] > line["checks"][number]["limit"], numbers


def test_control_is_not_correct():
    """The reference in TF32 in the port's place fails the update check."""
    spec = tiny_cnn()
    fam = harness.family(spec.config)
    setup = spec.driver.set_up(spec, fam, 21, "cpu")
    readings = spec.driver.readings(setup, 21, "cpu")
    assert readings["control"]["update_gap_median"] > \
        spec.limits["update_gap_median"]
    assert all(readings["port"][k] <= v for k, v in spec.limits.items())
