"""The chain's hashing and int8 codec, worked out again.

A payload's digest is SHA-256 over each leaf, in sorted-path order, of
``repr(path)``, the NumPy dtype string, ``str(shape)`` and the bytes; a
block's hash is SHA-256 over the previous hash, ``index|kind|round``, the
payload digest, ``uploader|score`` and the codec flag.  The codec stores
each update as int8 lanes with one f32 scale a 2048-lane tile: scale =
max|x| * f32(1/127) (1 for an all-zero tile), q = round half to even of
x / scale, clipped to +-127; the tail past D is zero.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

BLOCK_D = 2048
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def digest(leaves) -> str:
    """``leaves``: [(path, numpy array)] in sorted-path order."""
    h = hashlib.sha256()
    for path, arr in leaves:
        arr = np.asarray(arr)
        h.update(repr(path).encode())
        h.update(arr.dtype.str.encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def block_hash(block: dict) -> str:
    h = hashlib.sha256()
    h.update(block["prev_hash"].encode())
    h.update(f"{block['index']}|{block['kind']}|{block['round']}".encode())
    h.update(block["payload_digest"].encode())
    h.update(f"{block['uploader']}|{block['score']}".encode())
    h.update(f"{block['encoded']}".encode())
    return h.hexdigest()


def quantize(rows: torch.Tensor):
    """(K, D) f32 -> (q (K, Dpad) int8, scales (K, Dpad / 2048) f32)."""
    K, D = rows.shape
    dpad = D + (-D) % BLOCK_D
    x = torch.zeros((K, dpad), dtype=torch.float32, device=rows.device)
    x[:, :D] = rows
    tiles = x.reshape(K, -1, BLOCK_D)
    amax = tiles.abs().amax(dim=2)
    scales = torch.where(amax > 0, amax * INV_127, torch.ones_like(amax))
    q = torch.round(tiles / scales[:, :, None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(K, dpad), scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, D: int) -> torch.Tensor:
    """(K, Dpad) int8 -> (K, D) float64, exact."""
    K = q.shape[0]
    x = q.reshape(K, -1, BLOCK_D).double() * scales.double()[:, :, None]
    return x.reshape(K, -1)[:, :D]
