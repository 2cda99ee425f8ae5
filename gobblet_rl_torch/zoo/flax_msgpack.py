"""A reader of flax's msgpack serialization, in plain Python and numpy.

``flax.serialization.to_bytes`` writes a parameter tree as msgpack: nested
maps with string keys whose leaves are ndarrays packed as msgpack
extension type 1 (itself a msgpack ``(shape, dtype name, bytes)`` triple)
or numpy scalars as extension type 3 (the same triple of a 0-d array).
:func:`msgpack_restore` decodes that subset — maps, strings, binaries,
arrays, integers, floats and those two extension types — into the tree
``flax.serialization.msgpack_restore`` returns, and raises ``ValueError``
on anything else.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# type byte -> struct format of a fixed-width number
_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
# type byte -> (struct format of the length, reader method)
_SIZED = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xD9: (">B", "text"), 0xDA: (">H", "text"), 0xDB: (">I", "text"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map"),
          0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:                                   # positive fixint
            return b
        if b >= 0xE0:                                   # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            return getattr(self, kind)(self.unpack(fmt))
        if 0xD4 <= b <= 0xD8:                           # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpackb(payload)
    if not (isinstance(shape, list) and isinstance(dtype_name, str)
            and isinstance(buffer, bytes)):
        raise ValueError("malformed ndarray extension")
    try:
        dtype = np.dtype(dtype_name)
    except TypeError:
        raise ValueError(f"unsupported array dtype {dtype_name!r}") from None
    return np.frombuffer(buffer, dtype=dtype).reshape(shape)


def _unpackb(data: bytes):
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack value")
    return out


def msgpack_restore(data: bytes) -> dict:
    """The tree of a flax msgpack blob: nested dicts of numpy arrays."""
    tree = _unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("a flax blob holds a map at its top")
    return tree
