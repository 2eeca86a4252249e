"""Reader and writer for the msgpack files flax.serialization produces
(`to_bytes` / `from_bytes`), without the msgpack or flax packages.

Only the subset flax uses for a state dict is handled: maps with str keys,
nil, bool, int, float, str, bin, arrays (lists), and extension type 1, an
ndarray packed as the msgpack triple (shape, dtype name, raw bytes).  This
is the format of models/depthcov.msgpack and of the body of a mapping-state
snapshot (utils/checkpoint.py), so files written by either package load in
the other.  Anything else (other extension types, non-str map keys, flax's
chunked arrays above 1 GiB, trailing bytes) raises ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
_CHUNKED_KEY = "__msgpack_chunked_array__"
_DTYPES = {n: np.dtype(n) for n in (
    "bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64")}


# --- reading -----------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.num("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.num({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.num("b"), n)
        if b == 0xCA:
            return self.num(">f")
        if b == 0xCB:
            return self.num(">d")
        if 0xCC <= b <= 0xCF:
            return self.num({0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}[b])
        if 0xD0 <= b <= 0xD3:
            return self.num({0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b])
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            return self.ext(self.num("b"), n)
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.num({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.num({0xDC: ">H", 0xDD: ">I"}[b]))
        if b in (0xDE, 0xDF):
            return self.map(self.num({0xDE: ">H", 0xDF: ">I"}[b]))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at offset {self.pos - 1}")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            if k == _CHUNKED_KEY:
                raise ValueError("msgpack: flax chunked arrays are not supported")
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int) -> np.ndarray:
        payload = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported extension type {code}")
        triple = unpackb(payload)
        if not (isinstance(triple, list) and len(triple) == 3
                and isinstance(triple[0], list) and isinstance(triple[1], str)
                and isinstance(triple[2], bytes)):
            raise ValueError("msgpack: malformed ndarray extension")
        shape, name, raw = triple
        if name not in _DTYPES:
            raise ValueError(f"msgpack: unsupported ndarray dtype '{name}'")
        dtype = _DTYPES[name]
        if int(np.prod(shape, dtype=np.int64)) * dtype.itemsize != len(raw):
            raise ValueError("msgpack: ndarray byte count does not match its shape")
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def unpackb(data):
    """Decode one msgpack value (the whole of `data`)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out


def load(path: str):
    with open(path, "rb") as f:
        return unpackb(f.read())


# --- writing -----------------------------------------------------------------

def _head(n: int, fix, fix_max: int, codes) -> bytes:
    """Length header: the fix form up to fix_max, else the 8/16/32-bit form
    (codes = (c8 or None, c16, c32))."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    c8, c16, c32 = codes
    if c8 is not None and n < 1 << 8:
        return bytes([c8, n])
    if n < 1 << 16:
        return bytes([c16]) + struct.pack(">H", n)
    if n < 1 << 32:
        return bytes([c32]) + struct.pack(">I", n)
    raise ValueError("msgpack: object too large")


def _pack_into(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        # the shortest form, as msgpack-python (and so flax) writes it
        if -32 <= obj <= 0x7F:
            out.append(struct.pack("b", obj) if obj < 0 else bytes([obj]))
            return
        forms = ((b"\xcc", ">B"), (b"\xcd", ">H"), (b"\xce", ">I"), (b"\xcf", ">Q")) \
            if obj > 0 else ((b"\xd0", ">b"), (b"\xd1", ">h"), (b"\xd2", ">i"), (b"\xd3", ">q"))
        for code, fmt in forms:
            try:
                out.append(code + struct.pack(fmt, obj))
                return
            except struct.error:            # too large for this form
                pass
        raise ValueError("msgpack: int out of range")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(_head(len(obj), None, 0, (0xC4, 0xC5, 0xC6)))
        out.append(bytes(obj))
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.name not in _DTYPES:
            raise ValueError(f"msgpack: unsupported ndarray dtype '{arr.dtype.name}'")
        body = packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])
        n = len(body)
        if n in (1, 2, 4, 8, 16):
            out.append(bytes([0xD4 + n.bit_length() - 1]))
        else:
            out.append(_head(n, None, 0, (0xC7, 0xC8, 0xC9)))
        out.append(struct.pack("b", EXT_NDARRAY))
        out.append(body)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            _pack_into(out, k)
            _pack_into(out, v)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack_into(out, v)
    else:
        raise ValueError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Encode a tree of dicts (str keys), lists, scalars, bytes and numpy
    arrays, arrays as flax's extension type 1."""
    out: list = []
    _pack_into(out, obj)
    return b"".join(out)


def save(path: str, obj) -> None:
    with open(path, "wb") as f:
        f.write(packb(obj))
