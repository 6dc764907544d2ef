"""msgpack tree checkpointing (params, optimizer state, chain snapshots).

Port of ``repro/checkpoint/ckpt.py``, in the reference's file format, so
either package reads the other's files.  A file holds one map:

  b"treedef"    an informational string (the reference writes JAX's
                ``str(treedef)``; loading ignores it)
  b"leaves"     the leaves in sorted-key order, each {b"__nd": True,
                b"dtype": numpy dtype name, b"shape": [...], b"data": raw
                bytes}; bfloat16 leaves go through an int16 view under
                the name b"bfloat16"
  b"structure"  the skeleton of dicts (b"__d", keys sorted), lists and
                tuples (b"__l", b"__t"), None (b"__n") and leaves
                (b"__leaf")

As in JAX, ``None`` is an empty subtree: it has no leaf and comes back as
``None``.  Leaves are written from tensors, numpy arrays or Python
scalars, and load as tensors on the ``device`` asked for.  The codec is
``checkpoint/_msgpack.py``.
"""
from __future__ import annotations

import os
from typing import Any, Iterator, List

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack

# dtype names a checkpoint may carry, as torch dtypes
_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


def _flatten(tree: Any) -> List[Any]:
    """Leaves in sorted-key order; ``None`` holds none."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    return [tree]


def _encode_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            name, arr = "bfloat16", t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
            name = arr.dtype.name
    else:
        arr = np.asarray(x)
        name = arr.dtype.name
    return {
        b"__nd": True,
        b"dtype": name.encode(),
        b"shape": list(arr.shape),
        b"data": arr.tobytes(),
    }


def _decode_leaf(d: dict, device) -> torch.Tensor:
    name = bytes(d[b"dtype"]).decode()
    if name not in _DTYPES:
        raise ValueError(f"checkpoint leaf of dtype {name!r} is not supported")
    dtype, shape = _DTYPES[name], list(d[b"shape"])
    data = d[b"data"]
    if memoryview(data).nbytes == 0:
        return torch.empty(shape, dtype=dtype, device=device)
    # bytes onto the device first: the copy there is aligned for any dtype
    raw = torch.frombuffer(data, dtype=torch.uint8)
    return raw.to(device=device, copy=True).view(dtype).reshape(shape)


def _structure_of(tree):
    """Serializable skeleton (dicts/lists/tuples/None markers).

    Dict keys are SORTED to match the leaf order."""
    if isinstance(tree, dict):
        return {b"__d": {str(k).encode(): _structure_of(tree[k])
                         for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {b"__l": [_structure_of(v) for v in tree],
                b"__t": isinstance(tree, tuple)}
    if tree is None:
        return {b"__n": True}
    return {b"__leaf": True}


def _rebuild(struct, leaves_iter: Iterator):
    if b"__d" in struct:
        return {k.decode(): _rebuild(v, leaves_iter)
                for k, v in struct[b"__d"].items()}
    if b"__l" in struct:
        vals = [_rebuild(v, leaves_iter) for v in struct[b"__l"]]
        return tuple(vals) if struct[b"__t"] else vals
    if struct.get(b"__n"):
        return None
    return next(leaves_iter)


def _rebuild_like(like, leaves_iter: Iterator):
    """``like``'s structure over the loaded leaves (JAX's unflatten)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild_like(like[k], leaves_iter) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        vals = [_rebuild_like(v, leaves_iter) for v in like]
        if isinstance(like, tuple) and hasattr(like, "_fields"):
            return type(like)(*vals)
        return type(like)(vals)
    return next(leaves_iter)


def payload_of(tree: Any) -> dict:
    """The map a checkpoint of ``tree`` holds."""
    leaves = _flatten(tree)
    return {
        b"treedef": f"repro_torch tree, {len(leaves)} leaves".encode(),
        b"leaves": [_encode_leaf(leaf) for leaf in leaves],
        b"structure": _structure_of(tree),
    }


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` atomically (a temporary file, then a
    rename), so a reader polling the directory never sees half a file."""
    payload = payload_of(tree)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        _msgpack.pack(payload, f.write)
    os.replace(tmp, path)


def load_pytree(path: str, like: Any = None, device="cpu") -> Any:
    with open(path, "rb") as f:
        data = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(data)
    payload = _msgpack.unpackb(data)
    leaves = [_decode_leaf(d, device) for d in payload[b"leaves"]]
    if like is not None:
        it = iter(leaves)
        out = _rebuild_like(like, it)
        if next(it, None) is not None:
            raise ValueError(f"{path} holds more leaves than ``like``")
        return out
    return _rebuild(payload[b"structure"], iter(leaves))


def is_quantized_blob(tree: Any) -> bool:
    """True for an ``Int8UpdateCodec`` chain blob ({"q", "scales", "d"})."""
    return (
        isinstance(tree, dict)
        and set(tree.keys()) == {"q", "scales", "d"}
        and not isinstance(tree["d"], dict)
    )


def load_model_payload(path: str, codec: Any = None, device="cpu") -> Any:
    """Load a chain model snapshot: a raw parameter tree, or — when the
    snapshot is an int8-codec chain blob and a codec is supplied — the
    decoded tree.  Leaves load onto ``device`` and a blob is decoded
    there (on CUDA by the dequantize kernel).  The serving hot-swap path
    restores through here."""
    tree = load_pytree(path, device=device)
    if is_quantized_blob(tree):
        if codec is None:
            raise ValueError(
                f"{path} holds an int8 chain blob; pass the chain's "
                "Int8UpdateCodec to decode it"
            )
        # the blob's d comes back as a 0-d tensor; the slice bound must be
        # a Python int
        tree = dict(tree, d=int(tree["d"]))
        return codec.decode(tree)
    return tree
