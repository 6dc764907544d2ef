"""Coordinate-wise median and trimmed mean of K f32 update rows.

Port of ``repro/kernels/cwmed.py`` (``cwmed_kernel``,
``trimmed_mean_kernel`` and the ``median_of_sorted`` /
``trimmed_mean_of_sorted`` reductions the fused int8 kernel shares).  The
reference sorts the K rows of a tile with an odd-even network; the CUDA
kernels of ``csrc/f32_agg.cu`` sort each lane's K values: in registers with
a Batcher network of width 8, 16 or 32 for K <= 32, as runs of 32 merged
through shared memory for 33 <= K <= 128, and by an insertion sort in
shared memory above that (the C entry picks by K; ``sort_design`` asks it
which).  All give the same order statistics, so medians agree by value (a tie of +0.0 and -0.0 may come out
with either sign) and trimmed means bit for bit.

Each wrapper takes a (K, D) f32 stack, any K >= 1 and any D >= 1 (the
kernel masks the ragged edge, so nothing is padded), and dispatches on the
stack's device: a CPU tensor goes to the plain version beside it, a CUDA
tensor launches the kernel or raises.  Launches are counted in
``<wrapper>.launches``, and by the design that ran in
``<wrapper>.designs``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import recip_f32

# method codes of repro_sort_agg in csrc/f32_agg.cu
_CWMED, _TRIMMED_MEAN = 1, 2
# the sort designs the C entries report (csrc/sort_net.cuh sort_path)
_NETWORK, _RUN_MERGE, _INSERTION = 1, 2, 3


def design_name(design: int, size: int) -> str:
    """A sort design as the C entries report it ({design, size}), as text;
    design 0 is the fused kernel's fedavg."""
    return {0: "fedavg", _NETWORK: f"register network W={size}",
            _RUN_MERGE: f"run merge R={size}",
            _INSERTION: "insertion sort in shared memory"}[design]


@functools.lru_cache(maxsize=None)
def sort_design(K: int, insertion: bool = False) -> str:
    """The sort design repro_sort_agg takes for K rows (chosen in
    ``csrc/sort_net.cuh`` sort_path), as text; launches nothing."""
    path = (ctypes.c_int * 2)()
    lib = _build.load("f32_agg")
    _build.check(lib, lib.repro_sort_agg(None, None, K, 1, _CWMED, 0,
                                         int(insertion), ctypes.addressof(path),
                                         None), f"repro_sort_agg (K={K})")
    return design_name(*path)


def count_launch(wrapper, design: str) -> None:
    """One launch of ``wrapper``'s kernel, by the design that ran."""
    wrapper.launches += 1
    wrapper.designs[design] = wrapper.designs.get(design, 0) + 1


def median_of_sorted(rows: torch.Tensor) -> torch.Tensor:
    K = rows.shape[0]
    if K % 2 == 1:
        return rows[K // 2]
    return 0.5 * (rows[K // 2 - 1] + rows[K // 2])


def trimmed_mean_of_sorted(rows: torch.Tensor, trim: int) -> torch.Tensor:
    """Sequential sum of the kept rows times the f32 reciprocal of their
    count (the reference's ``trimmed_mean_of_sorted`` as compiled)."""
    keep = rows[trim : rows.shape[0] - trim]
    acc = keep[0]
    for r in keep[1:]:
        acc = acc + r
    return acc * recip_f32(keep.shape[0])


def cwmed_ref(stack: torch.Tensor) -> torch.Tensor:
    return median_of_sorted(torch.sort(stack, dim=0).values)


def trimmed_mean_ref(stack: torch.Tensor, trim: int) -> torch.Tensor:
    return trimmed_mean_of_sorted(torch.sort(stack, dim=0).values, trim)


def _launch_sort(stack: torch.Tensor, method: int, trim: int,
                 insertion: bool = False) -> torch.Tensor:
    """repro_sort_agg, with ``insertion`` the shared-memory insertion sort
    at any K (to time it beside the design K picks); counts no launch (the
    wrappers do)."""
    _build.require_cuda(stack)
    K, D = stack.shape
    out = torch.empty((D,), dtype=torch.float32, device=stack.device)
    lib = _build.load("f32_agg")
    code = lib.repro_sort_agg(stack.data_ptr(), out.data_ptr(), K, D, method,
                              trim, int(insertion), None,
                              _build.stream_handle(stack))
    _build.check(lib, code, f"repro_sort_agg (K={K}; a K whose column does "
                            f"not fit one lane's shared memory is refused)")
    return out


def cwmed_kernel(stack: torch.Tensor) -> torch.Tensor:
    """(K, D) f32 -> (D,) per-lane median; 0.5 * (a + b) of the middle
    pair for even K."""
    _build.check_f32_stack(stack, "cwmed_kernel")
    if stack.device.type == "cpu":
        return cwmed_ref(stack)
    out = _launch_sort(stack, _CWMED, 0)
    count_launch(cwmed_kernel, sort_design(stack.shape[0]))
    return out


cwmed_kernel.launches = 0
cwmed_kernel.designs = {}


def trimmed_mean_kernel(stack: torch.Tensor, *, trim: int) -> torch.Tensor:
    """(K, D) f32 -> (D,) mean of each lane's sorted values [trim : K-trim]."""
    _build.check_f32_stack(stack, "trimmed_mean_kernel")
    K = stack.shape[0]
    if not 0 <= 2 * trim < K:
        raise ValueError(f"trim={trim} too large for K={K}")
    if stack.device.type == "cpu":
        return trimmed_mean_ref(stack, trim)
    out = _launch_sort(stack, _TRIMMED_MEAN, trim)
    count_launch(trimmed_mean_kernel, sort_design(K))
    return out


trimmed_mean_kernel.launches = 0
trimmed_mean_kernel.designs = {}
