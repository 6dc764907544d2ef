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
  chunks of K added in order), whatever P, M or N;
* a CPU tensor takes ``client_gemm_ref``: one ``torch.mm`` per client, at
  the same (M, K) x (K, N) shape whatever P, which the CPU backend
  computes the same way every time at one thread count (its sgemm blocks
  the sums by the thread count).

The two agree to f32 rounding, not bit for bit (the CPU's sgemm blocks
its sums).  Operands may be strided views (the backward's transposes);
the kernel reads them in place.  Launches are counted in
``client_gemm_kernel.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# a product whose K reaches SPLIT_K is summed in chunks of K_CHUNK (one
# block each) that a second kernel adds in order: the split depends on K
# alone, so a client's bits still do not depend on P
SPLIT_K = 2048
K_CHUNK = 512


def k_splits(K: int) -> int:
    return -(-K // K_CHUNK) if K >= SPLIT_K else 1


def client_gemm_ref(a: torch.Tensor, b: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """(P, M, K) @ (P, K, N) (+ (P, N)) -> (P, M, N), one ``mm`` a client."""
    out = torch.stack([torch.mm(a[p], b[p]) for p in range(a.shape[0])])
    return out if bias is None else out + bias[:, None, :]


def client_gemm_kernel(a: torch.Tensor, b: torch.Tensor,
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """a: (P, M, K) f32, b: (P, K, N) f32, bias: (P, N) f32 or None.
    Returns the contiguous (P, M, N) f32 product."""
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
        return client_gemm_ref(a, b, bias)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}: want cuda or cpu")
    for t in (b, bias):
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    out = torch.empty((P, M, N), dtype=torch.float32, device=dev)
    splits = k_splits(K)
    ws = (torch.empty((P, splits, M, N), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    lib = _build.load("client_gemm")
    code = lib.repro_client_gemm(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(),
        None if bias is None else bias.data_ptr(),
        0 if bias is None else bias.stride(0),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        P, M, N, K, splits, K_CHUNK if splits > 1 else K,
        _build.stream_handle(a))
    _build.check(lib, code, "repro_client_gemm")
    client_gemm_kernel.launches += 1
    return out


client_gemm_kernel.launches = 0


class ClientLinear(torch.autograd.Function):
    """``x[p] @ w[p] + b[p]`` with a backward built from the same per-client
    products: dx = g @ w^T, dw = x^T @ g, db = ones @ g (a fixed-order sum
    over the rows, where ``g.sum(1)`` would reduce in a shape-chosen order)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return client_gemm_kernel(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = (client_gemm_kernel(g, w.transpose(1, 2))
              if ctx.needs_input_grad[0] else None)
        gw = client_gemm_kernel(x.transpose(1, 2), g)
        ones = g.new_ones(()).expand(g.shape[0], 1, g.shape[1])
        gb = client_gemm_kernel(ones, g)[:, 0]
        return gx, gw, gb


# x: (P, M, K), w: (P, K, N), b: (P, N) -> (P, M, N), differentiable
client_linear = ClientLinear.apply
