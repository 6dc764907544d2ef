"""The yardstick's arithmetic: peaks, FLOPs and bytes from shapes.

Frozen here so that no change to the program can move it.  The peaks are
one NVIDIA H100 SXM's (NVIDIA's data sheet, dense, at 700 W); the port
computes in float32 with TF32 off, so its compute peak is the f32 rate
outside the tensor cores.  A kernel's bound is the larger of its bytes
over the HBM rate and its operations over the f32 rate, with each input
byte read once and each output byte written once (the rule of
``chip_smoke.bound_ms``, copied).  Kernel counts are of the operation, not
of an implementation: a kernel that replaces one is held to the same work.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BLOCK_D = 2048           # the chain codec's tile (lanes a scale)
F32, I8 = 4, 1


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes or operations, whichever
    bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def padded_dim(d: int) -> int:
    return d + (-d) % BLOCK_D


# ----------------------------------------------------------------------
# the FEMNIST CNN: two SAME k x k convolutions of c1 and c2 channels, each
# with a 2x2 max pool, a dense layer and the class layer
# ----------------------------------------------------------------------
def cnn_dims(cfg: dict):
    """(kernel, c1, c2, dense, classes, image) of a CNN configuration."""
    c1, c2 = cfg["channels"]
    return cfg["kernel"], c1, c2, cfg["dense"], cfg["classes"], cfg["image"]


def cnn_shapes(kernel: int, c1: int, c2: int, dense: int, classes: int,
               image: int = 28):
    """{(layer, leaf): shape} of the parameters: HWIO kernels, (in, out)
    dense weights."""
    flat = (image // 4) ** 2 * c2
    return {("conv1", "w"): (kernel, kernel, 1, c1), ("conv1", "b"): (c1,),
            ("conv2", "w"): (kernel, kernel, c1, c2), ("conv2", "b"): (c2,),
            ("fc1", "w"): (flat, dense), ("fc1", "b"): (dense,),
            ("fc2", "w"): (dense, classes), ("fc2", "b"): (classes,)}


def cnn_params(kernel: int, c1: int, c2: int, dense: int, classes: int,
               image: int = 28) -> int:
    return sum(math.prod(shape) for shape in
               cnn_shapes(kernel, c1, c2, dense, classes, image).values())


def cnn_forward_flops(kernel: int, c1: int, c2: int, dense: int, classes: int,
                      image: int = 28) -> int:
    """Multiply-adds x 2 of one image's forward: the two convolutions at
    full and half resolution and the two dense layers."""
    half, pooled = image // 2, image // 4
    taps = kernel * kernel
    return 2 * (image * image * taps * c1 + half * half * taps * c1 * c2
                + pooled * pooled * c2 * dense + dense * classes)


def cnn_train_flops(kernel: int, c1: int, c2: int, dense: int, classes: int,
                    image: int = 28) -> int:
    """One training image: the forward, every weight gradient (as large as
    its forward product) and every input gradient but conv1's, which has
    no input to differentiate."""
    conv1 = 2 * image * image * kernel * kernel * c1
    fwd = cnn_forward_flops(kernel, c1, c2, dense, classes, image)
    return fwd + fwd + (fwd - conv1)


def gemm_forms(kernel: int, c1: int, c2: int, dense: int, classes: int,
               batch: int, image: int = 28):
    """The CNN trainer's eleven per-client products of one SGD step (the
    convolutions as im2col products), as ``chip_smoke.GEMM_FORMS`` lists
    them for the 3 x 3 CNN at batch 32: (form, (M, K, N) a client, bias,
    ones row).  A weight gradient's bias gradient is one more row of its
    product."""
    taps = kernel * kernel
    flat = (image // 4) ** 2 * c2
    full, half = batch * image * image, batch * (image // 2) ** 2
    return (
        ("conv1 forward", (full, taps, c1), True, False),
        ("conv1 weight and bias gradient", (taps, full, c1), False, True),
        ("conv2 forward", (half, taps * c1, c2), True, False),
        ("conv2 input gradient", (half, c2, taps * c1), False, False),
        ("conv2 weight and bias gradient", (taps * c1, half, c2), False, True),
        ("fc1 forward", (batch, flat, dense), True, False),
        ("fc1 input gradient", (batch, dense, flat), False, False),
        ("fc1 weight and bias gradient", (flat, batch, dense), False, True),
        ("fc2 forward", (batch, dense, classes), True, False),
        ("fc2 input gradient", (batch, classes, dense), False, False),
        ("fc2 weight and bias gradient", (dense, batch, classes), False, True),
    )


def gemm_step_bound_s(clients: int, kernel: int, c1: int, c2: int,
                      dense: int, classes: int, batch: int,
                      image: int = 28) -> float:
    """The least time of one SGD step's eleven products for ``clients``
    clients: the sum of each product's bound (bytes: A, B and C once, the
    bias once; operations: 2 M K N a client, the ones row one more M)."""
    total = 0.0
    for _, (M, K, N), bias, ones in gemm_forms(kernel, c1, c2, dense, classes,
                                               batch, image):
        Mo = M + ones
        nbytes = F32 * clients * (M * K + K * N + Mo * N + N * bias)
        total += bound_s(nbytes, 2 * clients * Mo * N * K)
    return total


# ----------------------------------------------------------------------
# the int8 codec's kernels
# ----------------------------------------------------------------------
def fused_candidates_bytes(rows: int, dim: int) -> int:
    """Bytes of rebuilding ``rows`` candidates base + dequant(q) at the
    padded dimension: the int8 rows, the base, the scales read once and
    the f32 candidates written once."""
    dpad = padded_dim(dim)
    nblk = dpad // BLOCK_D
    return rows * dpad * I8 + dpad * F32 + rows * nblk * F32 \
        + rows * dpad * F32


def fused_candidates_bound_s(rows: int, dim: int) -> float:
    return bound_s(fused_candidates_bytes(rows, dim), 2 * rows * padded_dim(dim))
