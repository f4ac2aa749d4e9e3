"""The subset of MessagePack that segtpu's ``state.msgpack`` files use
(flax's ``serialization.to_bytes``), read and written without the
``msgpack`` package.

A segtpu snapshot is a tree of maps with str keys whose leaves are numpy
arrays, packed as flax's ext type 1 (``ndarray``: the msgpack array
``[shape, dtype name, raw C-order bytes]``) or type 3 (a numpy scalar, the
same payload), plus ints, floats, str, bin, bool and nil. :func:`unpackb`
decodes every one of those (arrays come back as read-only numpy views of the
buffer; a ``bfloat16`` array comes back widened to float32, exactly);
:func:`packb` encodes the same types with the encodings the ``msgpack``
package chooses (smallest int form, float64, str8/bin8 and up), maps in
their insertion order, so its bytes equal flax's ``to_bytes`` of the same
tree (``msgpack_serialize(..., in_place=True)``).
Chunked arrays (flax splits leaves over 2**30 bytes) are not supported.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # first byte -> (kind, struct format of its length or value)
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
    0xca: ("value", ">f"), 0xcb: ("value", ">d"),
    0xcc: ("value", ">B"), 0xcd: ("value", ">H"), 0xce: ("value", ">I"), 0xcf: ("value", ">Q"),
    0xd0: ("value", ">b"), 0xd1: ("value", ">h"), 0xd2: ("value", ">i"), 0xd3: ("value", ">q"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload, ext=False)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C")


def _read(r: _Reader, ext: bool) -> Any:
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f, ext)
    if 0x90 <= b <= 0x9f:
        return [_read(r, ext) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), "utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _FIXEXT:
        return _ext(r.unpack(">b"), bytes(r.take(_FIXEXT[b])), ext)
    if b not in _SIZED:
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the supported subset")
    kind, fmt = _SIZED[b]
    n = r.unpack(fmt)
    if kind == "value":
        return n
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "array":
        return [_read(r, ext) for _ in range(n)]
    if kind == "map":
        return _read_map(r, n, ext)
    code = r.unpack(">b")
    return _ext(code, bytes(r.take(n)), ext)


def _read_map(r: _Reader, n: int, ext: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r, ext)
        out[key] = _read(r, ext)
    return out


def _ext(code: int, payload: bytes, ext: bool):
    if not ext:
        raise ValueError("nested msgpack ext type")
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack ext type {code} is outside the supported subset")


def unpackb(data: bytes, ext: bool = True) -> Any:
    """Decode one msgpack object (``msgpack.unpackb(data, raw=False)`` with
    flax's ext hook)."""
    r = _Reader(data)
    out = _read(r, ext)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def _sized(prefixes: Tuple[Tuple[int, int, str], ...], n: int) -> bytes:
    for limit, byte, fmt in prefixes:
        if n < limit:
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return bytes([x])
    if -32 <= x < 0:
        return struct.pack(">b", x)
    if x >= 0:
        for limit, byte, fmt in ((1 << 8, 0xcc, ">B"), (1 << 16, 0xcd, ">H"),
                                 (1 << 32, 0xce, ">I"), (1 << 64, 0xcf, ">Q")):
            if x < limit:
                return bytes([byte]) + struct.pack(fmt, x)
    else:
        for limit, byte, fmt in ((1 << 7, 0xd0, ">b"), (1 << 15, 0xd1, ">h"),
                                 (1 << 31, 0xd2, ">i"), (1 << 63, 0xd3, ">q")):
            if x >= -limit:
                return bytes([byte]) + struct.pack(fmt, x)
    raise ValueError(f"int {x} does not fit msgpack")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _sized(((1 << 8, 0xc7, ">B"), (1 << 16, 0xc8, ">H"), (1 << 32, 0xc9, ">I")), n)
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(a: np.ndarray) -> bytes:
    a = np.asarray(a)
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def _pack(x: Any, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.ndarray):
        out.append(_pack_ext(EXT_NDARRAY, _ndarray_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(x))))
    elif isinstance(x, int):
        out.append(_pack_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        n = len(raw)
        out.append((bytes([0xa0 | n]) if n < 32 else
                    _sized(((1 << 8, 0xd9, ">B"), (1 << 16, 0xda, ">H"), (1 << 32, 0xdb, ">I")),
                           n)) + raw)
    elif isinstance(x, (bytes, bytearray)):
        out.append(_sized(((1 << 8, 0xc4, ">B"), (1 << 16, 0xc5, ">H"), (1 << 32, 0xc6, ">I")),
                          len(x)) + bytes(x))
    elif isinstance(x, (list, tuple)):
        n = len(x)
        out.append(bytes([0x90 | n]) if n < 16 else
                   _sized(((1 << 16, 0xdc, ">H"), (1 << 32, 0xdd, ">I")), n))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        n = len(x)
        out.append(bytes([0x80 | n]) if n < 16 else
                   _sized(((1 << 16, 0xde, ">H"), (1 << 32, 0xdf, ">I")), n))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(x).__name__}")


def packb(tree: Any) -> bytes:
    """Encode ``tree`` (dicts, lists, str, bytes, ints, floats, bool, None,
    numpy arrays and scalars as flax's ext types)."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)
