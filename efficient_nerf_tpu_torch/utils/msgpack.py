"""A decoder for the msgpack that `flax.serialization.to_bytes` writes, so
that the port reads the JAX package's checkpoints without flax or the
`msgpack` package (the card's machine has neither).

It reads the types flax emits: nil, bool, the int and float widths, str,
bin, array (as a list), map, and flax's ext types: 1 an ndarray (the
msgpack of (shape, dtype name, C-order bytes), read with np.frombuffer
and so read-only, as flax's), 2 a complex, 3 a numpy scalar. A map of
flax's chunked-array form (`__msgpack_chunked_array__`, which flax writes
for a leaf over its MAX_CHUNK_SIZE) is joined back into one array. One
difference: a bfloat16 leaf (which flax restores through jax's ml_dtypes)
comes back widened to float32, exactly, as numpy has no bfloat16.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

__all__ = ["msgpack_restore"]

_CHUNKED = "__msgpack_chunked_array__"
# fixed-width items: first byte -> struct format
_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length-prefixed items: first byte -> (kind, width of the length)
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4), 0xde: ("map", 2), 0xdf: ("map", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _ndarray(data) -> np.ndarray:
    shape, name, buf = msgpack_restore(data)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        re, im = msgpack_restore(data)
        return complex(re, im)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack: ext type {code} is not one that flax writes")


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _read(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7f:
        return b, pos
    if b >= 0xe0:
        return b - 0x100, pos
    if b <= 0x8f:
        kind, n = "map", b & 0x0f
    elif b <= 0x9f:
        kind, n = "array", b & 0x0f
    elif b <= 0xbf:
        kind, n = "str", b & 0x1f
    elif b in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[b], pos
    elif b in _FIXED:
        fmt = _FIXED[b]
        (v,) = struct.unpack_from(fmt, buf, pos)
        return v, pos + struct.calcsize(fmt)
    elif b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    elif b in _SIZED:
        kind, width = _SIZED[b]
        (n,) = struct.unpack_from(_LEN[width], buf, pos)
        pos += width
    else:
        raise ValueError(f"msgpack: byte 0x{b:02x} at {pos - 1} starts no item")
    if kind in ("str", "bin", "ext") and pos + n + (kind == "ext") > len(buf):
        raise IndexError(f"{kind} of {n} bytes at {pos}")

    if kind == "str":
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "ext":
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _read(buf, pos)
            out.append(v)
        return out, pos
    d = {}
    for _ in range(n):
        k, pos = _read(buf, pos)
        d[k], pos = _read(buf, pos)
    return (_unchunk(d) if _CHUNKED in d else d), pos


def msgpack_restore(data) -> Any:
    """`flax.serialization.msgpack_restore` of bytes (or any buffer): nested
    dicts and lists with numpy leaves. Raises ValueError on a truncated or
    padded buffer or on a type that flax does not write."""
    buf = memoryview(data).cast("B")
    try:
        out, pos = _read(buf, 0)
    except (IndexError, struct.error) as e:
        raise ValueError(f"msgpack: truncated ({e})") from None
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} bytes after the object")
    return out
