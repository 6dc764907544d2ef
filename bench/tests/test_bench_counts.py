"""The frozen arithmetic against the hand numbers."""
import pytest
import torch

from bench import counts, harness
from bench.families import femnist_cnn
from bench.reference.tree import paths

LEAF = (5, 32, 64, 2048, 62)        # LEAF's FEMNIST CNN
SMALL = (3, 32, 64, 128, 62)        # the 3 x 3 CNN of PERF.md's kernel table


def spec(cell):
    return harness.cell_spec(cell)


def test_leaf_cnn_counts():
    # conv1 5*5*32 + 32, conv2 5*5*32*64 + 64, fc1 3136*2048 + 2048,
    # fc2 2048*62 + 62
    assert counts.cnn_params(*LEAF) == 832 + 51_264 + 6_424_576 + 127_038
    assert counts.cnn_params(*LEAF) == 6_603_710
    # 2 x (784*25*32 + 196*800*64 + 49*64*2048 + 2048*62)
    assert counts.cnn_forward_flops(*LEAF) == 34_423_808
    # three forwards less conv1's input gradient (2 * 784 * 25 * 32)
    assert counts.cnn_train_flops(*LEAF) == 3 * 34_423_808 - 1_254_400
    assert counts.padded_dim(6_603_710) == 6_604_800


def test_small_cnn_counts():
    assert counts.cnn_params(*SMALL) == 428_350
    assert counts.cnn_forward_flops(*SMALL) == 8_495_616
    assert counts.cnn_train_flops(*SMALL) == 25_035_264


def test_cnn_round_flops_at_leaf():
    s = spec("cnn_leaf_int8")
    assert counts.cnn_dims(s.config) == LEAF + (28,)
    P, Q = 213, 142          # of 355 active: a committee of 0.4
    flops = femnist_cnn.round_flops(s.config, s.traffic["bflc"], P, P * Q)
    train = P * 20 * 32 * 102_017_024
    score = P * Q * 64 * 34_423_808
    assert flops == train + score
    assert train == pytest.approx(1.3907e13, rel=1e-4)
    assert score == pytest.approx(6.6636e13, rel=1e-4)


def test_cnn_weights_are_the_configured_model():
    s = spec("cnn_leaf_int8")
    g = torch.Generator().manual_seed(0)
    w = femnist_cnn.weights(s.config, None, g, "cpu")
    assert sum(leaf.numel() for _, leaf in paths(w)) == s.config["params"]
    assert {p: tuple(leaf.shape) for p, leaf in paths(w)} == \
        counts.cnn_shapes(*LEAF)


def test_kernel_bounds_against_the_kernel_table():
    """PERF.md's kernel table: client_gemm's step of the 3 x 3 CNN at P = 54
    (792.965 us) and fused_candidates at (54, 430,080) (35.190 us)."""
    assert counts.gemm_step_bound_s(54, *SMALL, 32) * 1e6 == \
        pytest.approx(792.965, abs=1e-3)
    assert counts.fused_candidates_bound_s(54, 428_350) * 1e6 == \
        pytest.approx(35.190, abs=1e-3)
    # linear in the clients, so a round's bound is one call of all trainers
    assert counts.gemm_step_bound_s(213, *LEAF, 32) == \
        pytest.approx(213 / 54 * counts.gemm_step_bound_s(54, *LEAF, 32))


def test_gemm_forms_count_the_training_flops():
    """The eleven products of a step, less their bias rows, are the
    training FLOPs of the step's images (the loss and the elementwise
    work are not products)."""
    flops = sum(2 * M * K * N for _, (M, K, N), _, _ in
                counts.gemm_forms(*LEAF, batch=32))
    assert flops == 32 * counts.cnn_train_flops(*LEAF)


def test_bound_picks_the_larger():
    assert counts.bound_s(3.35e12, 0) == 1.0
    assert counts.bound_s(0, 67e12) == 1.0
    assert counts.bound_s(3.35e12, 2 * 67e12) == 2.0
