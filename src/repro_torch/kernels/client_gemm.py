"""Per-client matrix products of the local trainer, fixed per client.

``client_gemm(a, b, bias)`` computes ``a[p] @ b[p] (+ bias[p])`` for a
stack of P clients.  A client's result must not depend on how many
clients share the call: the reference compiles one per-client XLA program
(``tests/test_sharded_round.py:81-97`` holds a sharded trainer's rows to
the vmapped one's at atol 0), while PyTorch's batched convolutions and
matmuls pick their algorithm and reduction split by the whole call's
shape.  So:

* a CUDA tensor launches ``csrc/client_gemm.cu``, whose every output is
  one FMA chain over k in order (for K >= SPLIT_K, chains over fixed
  chunks of K added in order), whatever P, M or N, on the path and tile
  that the kernel's entry picks from the shape, the strides and the
  alignment (``client_gemm_path`` names it);
  ``client_gemm_ordered_ref`` computes those chains exactly, for the
  tests;
* a CPU tensor takes ``client_gemm_ref``: one ``torch.mm`` a client, at
  the same (M, K) x (K, N) shape whatever P, which the CPU backend
  computes the same way every time at one thread count (its sgemm blocks
  the sums by the thread count).

The kernel and ``client_gemm_ref`` agree to f32 rounding, not bit for bit
(the CPU's sgemm blocks its sums).  Operands may be strided views (the
backward's transposes); the kernel reads them in place.  ``ones_row``
appends the row ``ones @ b`` (a linear layer's bias gradient) to the
product, in the same launch.  Launches are counted in
``client_gemm_kernel.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.numerics import fma_f32

# a product whose K reaches SPLIT_K is summed in chunks of K_CHUNK (one
# block each) that a second kernel adds in order: the split depends on K
# alone, so a client's bits still do not depend on P
SPLIT_K = 2048
K_CHUNK = 512


def k_splits(K: int) -> int:
    return -(-K // K_CHUNK) if K >= SPLIT_K else 1


def client_gemm_ref(a: torch.Tensor, b: torch.Tensor,
                    bias: torch.Tensor | None = None, *,
                    ones_row: bool = False) -> torch.Tensor:
    """(P, M, K) @ (P, K, N) (+ (P, N)) -> (P, M, N), one ``mm`` a client;
    with ``ones_row``, (P, M + 1, N) whose last row is ``ones @ b``."""
    out = torch.stack([torch.mm(a[p], b[p]) for p in range(a.shape[0])])
    if ones_row:
        ones = b.new_ones(()).expand(b.shape[0], 1, b.shape[1])
        out = torch.cat([out, torch.stack([torch.mm(ones[p], b[p])
                                           for p in range(b.shape[0])])], 1)
    return out if bias is None else out + bias[:, None, :]


def client_gemm_ordered_ref(a: torch.Tensor, b: torch.Tensor,
                            bias: torch.Tensor | None = None, *,
                            ones_row: bool = False) -> torch.Tensor:
    """The kernel's arithmetic exactly, on any device: every output the
    f32 FMA chain over k in order (``numerics.fma_f32``), K >= SPLIT_K in
    chunks of K_CHUNK added in order, then the bias; with ``ones_row`` the
    row of ones @ b.  K steps of elementwise float64 work: for tests."""
    P, M, K = a.shape
    if ones_row:
        a = torch.cat([a, a.new_ones((P, 1, K))], 1)
    chunk = K_CHUNK if k_splits(K) > 1 else K
    out = None
    for k0 in range(0, K, chunk):
        acc = a.new_zeros((P, a.shape[1], b.shape[2]))
        for k in range(k0, min(K, k0 + chunk)):
            acc = fma_f32(a[:, :, k, None], b[:, None, k, :], acc)
        out = acc if out is None else out + acc
    return out if bias is None else out + bias[:, None, :]


def client_gemm_kernel(a: torch.Tensor, b: torch.Tensor,
                       bias: torch.Tensor | None = None, *,
                       ones_row: bool = False) -> torch.Tensor:
    """a: (P, M, K) f32, b: (P, K, N) f32, bias: (P, N) f32 or None.
    Returns the contiguous (P, M, N) f32 product, (P, M + 1, N) with
    ``ones_row``."""
    _check(a, b, bias)
    if a.device.type == "cpu":
        return client_gemm_ref(a, b, bias, ones_row=ones_row)
    P, M, K = a.shape
    Mo, N = M + ones_row, b.shape[2]
    out = torch.empty((P, Mo, N), dtype=torch.float32, device=a.device)
    splits = k_splits(K)
    ws = (torch.empty((P, splits, Mo, N), dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    _entry(a, b, bias, ones_row, out, ws, None)
    client_gemm_kernel.launches += 1
    return out


client_gemm_kernel.launches = 0


def client_gemm_path(a: torch.Tensor, b: torch.Tensor,
                     ones_row: bool = False) -> str:
    """The path the kernel takes for ``a @ b`` on the card (chosen in
    ``csrc/client_gemm.cu`` from M, N, K, the strides and the base
    addresses, never P), as text; launches nothing."""
    _check(a, b, None)
    if a.device.type != "cuda":
        raise ValueError(f"client_gemm_path: no kernel for device {a.device}")
    path = (ctypes.c_int * 6)()
    _entry(a, b, None, ones_row, None, None, ctypes.addressof(path))
    bm, bn, a_kfast, b_kfast, vec_a, vec_b = path
    splits = k_splits(a.shape[2])
    return (("stream" if bm == 0 else f"tile {bm}x{bn}")
            + f", A along {'k' if a_kfast else 'm'}{' 16 B' if vec_a else ''}"
            + f", B along {'k' if b_kfast else 'n'}{' 16 B' if vec_b else ''}"
            + f", {splits} chunk{'s' if splits > 1 else ''}")


def _check(a: torch.Tensor, b: torch.Tensor, bias: torch.Tensor | None) -> None:
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"client_gemm: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    P, M, K = a.shape
    N = b.shape[2]
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"client_gemm: want float32, got {a.dtype}, {b.dtype}")
    if bias is not None and (bias.shape != (P, N) or bias.stride(1) != 1):
        raise ValueError(f"client_gemm: bias {tuple(bias.shape)} "
                         f"{bias.stride()}, want ({P}, {N}) unit-stride rows")
    if a.device.type == "cpu":
        return
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}: want cuda or cpu")
    for t in (b, bias):
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if min(P, M, K, N) == 0:
        raise ValueError(f"client_gemm: empty product {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def _entry(a, b, bias, ones_row, out, ws, path) -> None:
    """One call of ``repro_client_gemm`` on checked CUDA inputs: a launch
    into ``out`` (and ``ws`` when K is split), or with ``path`` (the
    address of 6 ints) the path it would take."""
    P, M, K = a.shape
    splits = k_splits(K)
    lib = _build.load("client_gemm")
    code = lib.repro_client_gemm(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(),
        None if bias is None else bias.data_ptr(),
        0 if bias is None else bias.stride(0),
        None if out is None else out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        P, M, b.shape[2], K, splits, K_CHUNK if splits > 1 else K, ones_row,
        path, _build.stream_handle(a))
    _build.check(lib, code, "repro_client_gemm")


class ClientLinear(torch.autograd.Function):
    """``x[p] @ w[p] + b[p]`` with a backward built from the same per-client
    products: dx = g @ w^T, and dw = x^T @ g with db = ones @ g (a
    fixed-order sum over the rows, where ``g.sum(1)`` would reduce in a
    shape-chosen order) as one product's last row."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return client_gemm_kernel(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (client_gemm_kernel(g, w.transpose(1, 2))
              if ctx.needs_input_grad[0] else None)
        gwb = client_gemm_kernel(x.transpose(1, 2), g, ones_row=True)
        return gx, gwb[:, :-1], gwb[:, -1]


# x: (P, M, K), w: (P, K, N), b: (P, N) -> (P, M, N), differentiable
client_linear = ClientLinear.apply
