"""A reader and a writer of flax's msgpack serialization, in plain Python
and numpy.

``flax.serialization.to_bytes`` writes a parameter tree as msgpack: nested
maps with string keys whose leaves are ndarrays packed as msgpack
extension type 1 (itself a msgpack ``(shape, dtype name, bytes)`` triple)
or numpy scalars as extension type 3 (the same triple of a 0-d array).
:func:`msgpack_restore` decodes that subset — maps, strings, binaries,
arrays, integers, floats and those two extension types — into the tree
``flax.serialization.msgpack_restore`` returns, and raises ``ValueError``
on anything else.  :func:`msgpack_serialize` is its inverse: it writes
that subset with the smallest header msgpack-python chooses for each
value, so its bytes are those of ``flax.serialization.msgpack_serialize``
for the same tree in the same key order.
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


def _header(n: int, fix: int | None, fix_max: int, wide: tuple) -> bytes:
    """The smallest header of a sized value of length ``n``: the fixed form
    ``fix | n`` up to ``fix_max``, else the first of ``wide``'s
    ``(type byte, struct format)`` whose width holds ``n``."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for type_byte, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([type_byte]) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack value of length {n} is too long")


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    ranges = ((0xCC, ">B", 0, 0xFF), (0xD0, ">b", -0x80, -1), (0xCD, ">H", 0, 0xFFFF),
              (0xD1, ">h", -0x8000, -1), (0xCE, ">I", 0, 0xFFFFFFFF),
              (0xD2, ">i", -0x80000000, -1), (0xCF, ">Q", 0, 0xFFFFFFFFFFFFFFFF),
              (0xD3, ">q", -0x8000000000000000, -1))
    for type_byte, fmt, lo, hi in ranges:
        if lo <= n <= hi:
            return bytes([type_byte]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit in 64 bits")


def _pack_ext(code: int, payload: bytes) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixext:
        head = bytes([fixext[len(payload)]])
    else:
        head = _header(len(payload), None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    return _packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(x, out: list) -> None:
    if isinstance(x, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    elif type(x) is dict:
        out.append(_header(len(x), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I"))))
        for key, value in x.items():
            if type(key) is not str:
                raise ValueError(f"a map key must be a string, not {key!r}")
            _pack(key, out)
            _pack(value, out)
    elif type(x) is list:
        out.append(_header(len(x), 0x90, 15, ((0xDC, ">H"), (0xDD, ">I"))))
        for value in x:
            _pack(value, out)
    elif type(x) is str:
        data = x.encode("utf-8")
        out.append(_header(len(data), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))))
        out.append(data)
    elif type(x) is bytes:
        out.append(_header(len(x), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))))
        out.append(x)
    elif type(x) is int:
        out.append(_pack_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    else:
        raise ValueError(f"cannot serialize {type(x).__name__} into a flax blob")


def _packb(x) -> bytes:
    out: list = []
    _pack(x, out)
    return b"".join(out)


def msgpack_serialize(tree: dict) -> bytes:
    """The flax msgpack blob of ``tree``: nested dicts with string keys
    (written in their iteration order) whose leaves are ndarrays, numpy
    scalars, strings, bytes, integers, floats or lists of them."""
    if type(tree) is not dict:
        raise ValueError("a flax blob holds a map at its top")
    return _packb(tree)
