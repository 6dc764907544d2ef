"""The port's kernels for the BFLC round.

One module per kernel family (``quantize``: codec quantize / dequantize;
``fused_agg``: fused int8 aggregation; ``fused_score``: candidates from
int8 rows; ``fedavg_agg`` and ``cwmed``: f32 aggregation; ``client_gemm``:
the local trainer's per-client matrix products), each holding
the wrapper that launches the CUDA kernel of ``csrc/`` beside its plain
PyTorch version, plus ``ops`` (the public layer) and ``_build``
(nvcc + ctypes).
"""
from repro_torch.kernels.client_gemm import client_gemm_kernel
from repro_torch.kernels.cwmed import cwmed_kernel, trimmed_mean_kernel
from repro_torch.kernels.fedavg_agg import fedavg_agg_kernel
from repro_torch.kernels.fused_agg import METHODS, fused_agg_kernel
from repro_torch.kernels.fused_score import fused_candidates_kernel
from repro_torch.kernels.ops import (
    Int8UpdateCodec,
    aggregate,
    aggregate_quantized,
    candidates_from_quantized,
    cwmed,
    dequantize,
    dequantize_pytree,
    fedavg_agg,
    padded_dim,
    padded_dim_sharded,
    quantize,
    quantize_pytree,
    quantize_stack,
    trimmed_mean,
)
from repro_torch.kernels.quantize import (
    dequantize_kernel,
    quantize_kernel,
    quantize_stack_kernel,
)
from repro_torch.kernels.tiling import BLOCK_D

# every kernel wrapper, by the name its launch count is reported under
KERNEL_WRAPPERS = {
    "quantize": quantize_kernel,
    "quantize_stack": quantize_stack_kernel,
    "dequantize": dequantize_kernel,
    "fused_agg": fused_agg_kernel,
    "fused_candidates": fused_candidates_kernel,
    "fedavg_agg": fedavg_agg_kernel,
    "cwmed": cwmed_kernel,
    "trimmed_mean": trimmed_mean_kernel,
    "client_gemm": client_gemm_kernel,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def design_counts() -> dict:
    """The sort wrappers' launches by the design that ran: {name: {design:
    launches}}."""
    return {name: dict(fn.designs) for name, fn in KERNEL_WRAPPERS.items()
            if hasattr(fn, "designs")}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "designs"):
            fn.designs = {}


__all__ = [
    "BLOCK_D",
    "METHODS",
    "KERNEL_WRAPPERS",
    "Int8UpdateCodec",
    "aggregate",
    "aggregate_quantized",
    "candidates_from_quantized",
    "client_gemm_kernel",
    "cwmed",
    "cwmed_kernel",
    "dequantize",
    "dequantize_kernel",
    "dequantize_pytree",
    "design_counts",
    "fedavg_agg",
    "fedavg_agg_kernel",
    "fused_agg_kernel",
    "fused_candidates_kernel",
    "launch_counts",
    "padded_dim",
    "padded_dim_sharded",
    "quantize",
    "quantize_kernel",
    "quantize_pytree",
    "quantize_stack",
    "quantize_stack_kernel",
    "reset_launch_counts",
    "trimmed_mean",
    "trimmed_mean_kernel",
]
