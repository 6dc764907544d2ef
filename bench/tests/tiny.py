"""The cell of the benchmark cut to a size the CPU tests can hold: the same
files, the same harness, smaller numbers (LEAF's 5 x 5 kernels kept)."""
from bench import harness


def tiny_cnn(root=harness.ROOT):
    spec = harness.cell_spec("cnn_leaf_int8", root)
    spec.config.update(num_clients=40, mean_samples=20, channels=[4, 8],
                       dense=16, classes=4, test_size=16)
    spec.traffic["bflc"].update(active_proportion=0.5, k_updates=4,
                                local_steps=3, local_batch=8, val_batch=16)
    spec.traffic["check_rows"] = 4
    return spec
