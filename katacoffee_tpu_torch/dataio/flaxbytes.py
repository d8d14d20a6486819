"""The msgpack subset that flax's `serialization.to_bytes` writes, in pure
Python, so the port reads and writes the JAX package's trainer checkpoints
without msgpack or flax.

What flax writes for a `TrainState` (`flax/serialization.py`
`msgpack_serialize`): nested maps with str keys, ndarray leaves as ext type
1 whose payload is itself msgpack of `(shape, dtype.name, C-order bytes)`,
numpy scalars as ext type 3 (same payload), and Python ints, floats, bools,
None, str and bytes in msgpack's smallest encodings (what msgpack-python's
`packb(..., use_bin_type=True)` gives). `encode(decode(blob)) == blob` for
such a blob.

Flax splits arrays above `MAX_CHUNK_SIZE` bytes into chunk maps; no model of
`nn/configs.py` comes near that, and `encode` raises on such a leaf instead
of writing it in a form flax would not read back as one array.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """The header of a str, bin, array or map of length n."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code]) + data
    for head, fmt, top in ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32)):
        if n < top:
            return bytes([head]) + struct.pack(fmt, n) + bytes([code]) + data
    raise OverflowError(f"ext payload of {n} bytes does not fit msgpack")


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    return encode((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _encode(x, out: list) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        b = x.encode("utf-8")
        out.append(_sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b)
    elif type(x) in (bytes, bytearray, memoryview):
        b = bytes(x)
        out.append(_sized(len(b), None, 0, (0xC4, 0xC5, 0xC6)) + b)
    elif type(x) in (list, tuple):
        out.append(_sized(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in x:
            _encode(v, out)
    elif type(x) is dict:
        out.append(_sized(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in x.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(x, np.ndarray):
        if x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError(f"an array of {x.size * x.dtype.itemsize} bytes is above flax's MAX_CHUNK_SIZE; "
                             "flax would chunk it and this codec does not")
        out.append(_ext(EXT_NDARRAY, _array_payload(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _array_payload(np.asarray(x))))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def encode(tree) -> bytes:
    """msgpack bytes of a tree of dicts (str keys), lists, tuples, numpy
    arrays and scalars, and Python scalars, as flax writes them."""
    out: list = []
    _encode(tree, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        c = self.unpack(">B")
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            v = self.unpack(ints[c])
            return float(v) if c in (0xCA, 0xCB) else v
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in lengths:
            n = self.unpack(lengths[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str(n)
            return self.array(n) if c <= 0xDD else self.map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            return self.ext(fixext[c])
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = decode(payload)
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr[()] if code == EXT_NPSCALAR else arr


def decode(data: bytes):
    """The tree that `encode` (or flax's msgpack) wrote: dicts, lists,
    numpy arrays (ext 1), numpy scalars (ext 3) and Python scalars."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack value")
    return out
