"""The subset of MessagePack that the checkpoints use, in pure Python.

The reference writes its checkpoints with ``msgpack.packb(payload,
use_bin_type=True)`` and reads them with ``msgpack.unpackb(data,
raw=True)``; the card's machine has no ``msgpack``, so the port carries
this codec of its own.  It covers what a checkpoint holds: maps, arrays
(lists and tuples), bin, bool, nil and integers (keys and names are
bin).  Decoded bin values are memoryviews into the data, so a leaf is
not copied before it becomes a tensor; map keys are bytes.  Anything else raises ``TypeError`` on packing and ``ValueError`` on
unpacking.

Every value takes msgpack's smallest encoding (fixint, fixmap, fixarray,
then the 8-, 16-, 32- and 64-bit forms), as ``msgpack.packb``
writes it, so the port's files are byte for byte the ones the reference
would write for the same payload.
"""
from __future__ import annotations

import io
import struct
from typing import Any, Callable, Optional, Tuple

_BE = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}


def _head(write: Callable, code: int, n: int, width: int) -> None:
    write(bytes((code,)) + struct.pack(_BE[width], n))


def _sized(write: Callable, n: int, fix: Optional[int], fix_max: int,
           codes: Tuple[Tuple[int, int], ...]) -> None:
    """A length header: the fix form when ``n <= fix_max``, else the first
    of ``codes`` ((code, byte width), ascending) whose width holds ``n``."""
    if fix is not None and n <= fix_max:
        write(bytes((fix | n,)))
        return
    for code, width in codes:
        if n < 1 << (8 * width):
            _head(write, code, n, width)
            return
    raise ValueError(f"length {n} exceeds msgpack's 32-bit limit")


def _pack_int(write: Callable, x: int) -> None:
    if 0 <= x < 0x80:
        write(bytes((x,)))
    elif -32 <= x < 0:
        write(bytes((x & 0xFF,)))
    elif x >= 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if x < 1 << (8 * width):
                _head(write, code, x, width)
                return
        raise OverflowError(f"{x} does not fit msgpack's uint64")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                          (0xD3, ">q")):
            bits = 8 * struct.calcsize(fmt)
            if x >= -(1 << (bits - 1)):
                write(bytes((code,)) + struct.pack(fmt, x))
                return
        raise OverflowError(f"{x} does not fit msgpack's int64")


def pack(obj: Any, write: Callable) -> None:
    """Write ``obj``'s encoding through ``write`` (large bins are passed on
    as they are, not copied)."""
    if obj is None:
        write(b"\xc0")
    elif obj is True:
        write(b"\xc3")
    elif obj is False:
        write(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(write, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        _sized(write, n, None, -1, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        write(obj)
    elif isinstance(obj, (list, tuple)):
        _sized(write, len(obj), 0x90, 15, ((0xDC, 2), (0xDD, 4)))
        for item in obj:
            pack(item, write)
    elif isinstance(obj, dict):
        _sized(write, len(obj), 0x80, 15, ((0xDE, 2), (0xDF, 4)))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} in a checkpoint")


def packb(obj: Any) -> bytes:
    buf = io.BytesIO()
    pack(obj, buf.write)
    return buf.getvalue()


class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width: int) -> int:
        return struct.unpack(_BE[width], self.take(width))[0]

    def raw(self, n: int, key: bool):
        out = self.take(n)
        return bytes(out) if key else out

    def value(self, key: bool = False) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):          # bin 8 / 16 / 32
            return self.raw(self.uint(1 << (b - 0xC4)), key)
        if 0xCC <= b <= 0xCF:                # uint 8 .. 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                # int 8 .. 64
            fmt = ">" + "bhiq"[b - 0xD0]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                         f"checkpoint subset")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(key=True)
            out[k] = self.value()
        return out


def unpackb(data) -> Any:
    """Decode one object, as ``msgpack.unpackb(data, raw=True)`` does, except
    that bin values (not map keys) come back as memoryviews into ``data``
    rather than bytes copies."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.mv):
        raise ValueError("extra bytes after the msgpack object")
    return obj
