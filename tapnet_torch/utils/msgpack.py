"""A decoder of the msgpack that `flax.serialization.to_bytes` writes, so
the port reads the JAX package's `ckpt_*.msgpack` without the `msgpack`
package (the card's machine has none).

    tree = unpackb(open(path, "rb").read())

Covers nil, booleans, integers, floats, strings, binaries, arrays (as
lists) and maps (as dicts), and flax's extension types 1 (a numpy array,
packed as msgpack `[shape, dtype name, raw C-order bytes]`) and 3 (a numpy
scalar, packed the same way). Anything else raises ValueError: other
extension types, dtypes numpy does not know (bfloat16
where `ml_dtypes` is not loaded), and flax's chunked
arrays (leaves over 2^30 bytes, which flax splits into
`{"__msgpack_chunked_array__": ...}` maps).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-size headers: byte -> struct format of the length or value
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",        # bin
        0xd9: ">B", 0xda: ">H", 0xdb: ">I",        # str
        0xdc: ">H", 0xdd: ">I",                    # array
        0xde: ">H", 0xdf: ">I",                    # map
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}        # ext
_NUM = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
        0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, raw = unpackb(payload)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: array dtype {name!r} is not a numpy "
                         "dtype") from None
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack: extension type {code} is not supported")


def _decode(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_decode(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), "utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _NUM:
        return r.unpack(_NUM[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXEXT[b])))
    if b in _LEN:
        n = r.unpack(_LEN[b])
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(r.take(n))
        if b in (0xd9, 0xda, 0xdb):
            return str(r.take(n), "utf-8")
        if b in (0xdc, 0xdd):
            return [_decode(r) for _ in range(n)]
        if b in (0xde, 0xdf):
            return _map(r, n)
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    raise ValueError(f"msgpack: byte 0x{b:02x} at {r.pos - 1} starts no "
                     "supported object")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    if CHUNKED in out:
        raise ValueError("msgpack: flax chunked arrays (leaves over 2^30 "
                         "bytes) are not supported")
    return out


def unpackb(data: bytes):
    """Decode one msgpack object that fills `data`."""
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes")
    return out
