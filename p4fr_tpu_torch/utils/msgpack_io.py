"""The port's msgpack codec, for the files that flax's
``serialization.msgpack_serialize`` writes (the JAX package's native
checkpoints, ``p4fr_tpu/utils/checkpoint.py``). It needs neither flax nor
the ``msgpack`` package.

The subset: maps, arrays, str, bin, int, float, bool and nil, and flax's
three ext types:

- 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
- 2, a complex: the msgpack of ``(real, imag)``;
- 3, a numpy scalar: an ndarray of shape ``()``, unpacked to its scalar.

Arrays larger than flax's ``MAX_CHUNK_SIZE`` (2**30 bytes) travel as a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
flat chunk, ..}}``; ``unpackb`` reassembles them. A dtype named
``bfloat16`` (numpy has none) is read as uint16 and viewed as a
``torch.bfloat16`` tensor. ``packb`` writes what a native checkpoint holds
(maps, lists, str, bin, int, float, bool, nil and numpy arrays below
``MAX_CHUNK_SIZE``) as flax writes it: the shortest form of every int, str,
bin, map, array and ext, floats as float64.

Bin payloads (an array's bytes) are sliced out of the buffer, not decoded
byte by byte: ``np.frombuffer`` over the slice, read-only, sharing the
file's bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # tag -> (struct format, size) of the fixed-width scalars
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw  # str as bytes (flax's inner ndarray tuples)

    def take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("msgpack: truncated data")
        return self.buf[start:self.pos]

    def length(self, size: int) -> int:
        return struct.unpack(_LEN[size], self.take(size))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map_(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return self.array(tag & 0x0f)
        if 0xa0 <= tag <= 0xbf:
            return self.str_(tag & 0x1f)
        if tag == 0xc0:
            return None
        if tag in (0xc2, 0xc3):
            return tag == 0xc3
        if tag in _FIXED:
            fmt, n = _FIXED[tag]
            return struct.unpack(fmt, self.take(n))[0]
        if tag in (0xc4, 0xc5, 0xc6):  # bin 8/16/32: a slice, no copy
            return self.take(self.length(1 << (tag - 0xc4)))
        if tag in (0xd9, 0xda, 0xdb):
            return self.str_(self.length(1 << (tag - 0xd9)))
        if tag in (0xdc, 0xdd):
            return self.array(self.length(2 if tag == 0xdc else 4))
        if tag in (0xde, 0xdf):
            return self.map_(self.length(2 if tag == 0xde else 4))
        if 0xd4 <= tag <= 0xd8:  # fixext 1/2/4/8/16
            return self.ext(1 << (tag - 0xd4))
        if tag in (0xc7, 0xc8, 0xc9):
            return self.ext(self.length(1 << (tag - 0xc7)))
        raise ValueError(f"msgpack: unsupported tag 0x{tag:02x}")

    def array(self, n: int) -> List:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[bytes(key) if isinstance(key, memoryview) else key] = self.obj()
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).obj()
            return complex(real, imag)
        if code == EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _ndarray(data: memoryview):
    shape, name, payload = _Reader(data, raw=True).obj()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = np.frombuffer(payload, dtype=np.int16)
        return torch.from_numpy(flat.copy()).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(payload, dtype=np.dtype(name)).reshape(shape)


def _dict_to_tuple(d: Dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            chunks = _dict_to_tuple(tree["chunks"])
            cat = (torch.cat if isinstance(chunks[0], torch.Tensor)
                   else np.concatenate)(chunks)
            return cat.reshape(_dict_to_tuple(tree["shape"]))
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """msgpack bytes -> the Python tree flax's ``msgpack_restore`` gives:
    numpy arrays (bfloat16 as ``torch.bfloat16`` tensors), chunked arrays
    reassembled, bin as ``memoryview`` slices."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(out)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _head(out: List[bytes], n: int, fix_base, fix_max: int, tags) -> None:
    """A length header: the fix form up to ``fix_max``, else the first of
    ``tags`` (8-, 16-, 32-bit lengths; None where the type has no such
    form) that holds ``n``."""
    if fix_base is not None and n <= fix_max:
        out.append(bytes([fix_base | n]))
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (0xff, 0xffff, 0xffffffff)):
        if tag is not None and n <= limit:
            out.append(bytes([tag]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for tag, fmt, limit in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                                (0xce, ">I", 0xffffffff), (0xcf, ">Q", 2 ** 64 - 1)):
            if v <= limit:
                out.append(bytes([tag]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for tag, fmt, bits in ((0xd0, ">b", 7), (0xd1, ">h", 15), (0xd2, ">i", 31),
                               (0xd3, ">q", 63)):
            if v >= -(1 << bits):
                out.append(bytes([tag]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int {v} too small")


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fix:
        out.append(bytes([fix[n]]))
    else:
        _head(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out.append(struct.pack(">b", code))
    out.append(data)


def _pack(out: List[bytes], v) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, np.ndarray):
        if v.nbytes > MAX_CHUNK_SIZE or v.dtype.hasobject or v.dtype.isalignedstruct:
            raise ValueError(f"msgpack: cannot write a {v.dtype} array of {v.nbytes} bytes")
        # flax's ``_ndarray_to_bytes``: the msgpack of (shape, dtype name, bytes)
        _ext(out, EXT_NDARRAY, packb([list(v.shape), v.dtype.name, v.tobytes("C")]))
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _head(out, len(b), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out.append(b)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        _head(out, len(b), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(b)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 15, (None, 0xde, 0xdf))
        for k, item in v.items():
            _pack(out, k)
            _pack(out, item)
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, (None, 0xdc, 0xdd))
        for item in v:
            _pack(out, item)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(v).__name__}")


def packb(tree) -> bytes:
    """A tree of dicts, lists, Python scalars and numpy arrays -> msgpack
    bytes in flax's format."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)
