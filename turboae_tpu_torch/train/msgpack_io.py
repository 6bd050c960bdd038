"""Reader and writer of flax msgpack checkpoints, in pure Python and numpy.

The JAX package writes checkpoints with `flax.serialization.msgpack_serialize`
(train/checkpoint.py). The port reads and writes them without flax or
msgpack: this module codes the msgpack wire format (maps, arrays, str, bin,
ints, floats, nil, bool, ext) and flax's ndarray extension, ext type 1,
whose payload is a packed (shape, dtype name, C-order buffer). Lists come back as dicts keyed '0', '1', ... as
flax's own `msgpack_restore` gives them, and the writer stores them so, as
flax's `to_state_dict` does.
"""
from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError('truncated msgpack data')
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        raise ValueError(f'unsupported msgpack ext type {code}')

    def value(self) -> Any:
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), 'utf-8')
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.unpack({0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}[b])))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
            return self.ext(self.unpack('>b'), n)
        if b == 0xca:
            return self.unpack('>f')
        if b == 0xcb:
            return self.unpack('>d')
        ints = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
                0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if b in ints:
            return self.unpack(ints[b])
        if 0xd4 <= b <= 0xd8:
            n = 1 << (b - 0xd4)
            return self.ext(self.unpack('>b'), n)
        if b in (0xd9, 0xda, 0xdb):
            return str(self.take(self.unpack({0xd9: '>B', 0xda: '>H', 0xdb: '>I'}[b])), 'utf-8')
        if b in (0xdc, 0xdd):
            return self.array(self.unpack('>H' if b == 0xdc else '>I'))
        if b in (0xde, 0xdf):
            return self.map(self.unpack('>H' if b == 0xde else '>I'))
        raise ValueError(f'invalid msgpack type byte 0x{b:02x}')

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills `data`."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f'{len(r.data) - r.pos} trailing bytes after msgpack object')
    return out


def _check_unchunked(tree):
    if isinstance(tree, dict):
        if '__msgpack_chunked_array__' in tree:
            raise NotImplementedError('chunked arrays (over 1 GB) are not supported')
        for v in tree.values():
            _check_unchunked(v)


def load_msgpack(path: str) -> Any:
    """The nested tree of a flax msgpack file, arrays as numpy arrays."""
    with open(path, 'rb') as f:
        tree = unpackb(f.read())
    _check_unchunked(tree)
    return tree


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7f:
        return struct.pack('>B', n)
    if -32 <= n < 0:
        return struct.pack('>b', n)
    if n >= 0:
        for code, fmt, top in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                               (0xce, '>I', 1 << 32), (0xcf, '>Q', 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, bottom in ((0xd0, '>b', -(1 << 7)), (0xd1, '>h', -(1 << 15)),
                                  (0xd2, '>i', -(1 << 31)), (0xd3, '>q', -(1 << 63))):
            if n >= bottom:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f'integer {n} does not fit msgpack')


def _pack_len(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str/bin/array/map of n items: a fix type when n fits,
    else the 8/16/32-bit length forms in `codes` (None where absent)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, ('>B', '>H', '>I'), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f'{n} items do not fit msgpack')


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_len(n, None, 0, (0xc7, 0xc8, 0xc9))
    return head + struct.pack('>b', code) + payload


def _ndarray_payload(a: np.ndarray) -> bytes:
    """flax's _ndarray_to_bytes: (shape, dtype name, C-order buffer)."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError('object and structured dtypes cannot be written')
    return packb((list(a.shape), a.dtype.name, a.tobytes('C')))


def _pack(obj, out: list):
    if obj is None:
        out.append(b'\xc0')
    elif isinstance(obj, bool):
        out.append(b'\xc3' if obj else b'\xc2')
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b'\xcb' + struct.pack('>d', obj))
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        out.append(_pack_len(len(data), 0xa0, 31, (0xd9, 0xda, 0xdb)) + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_pack_len(len(data), None, 0, (0xc4, 0xc5, 0xc6)) + data)
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(EXT_NDARRAY, _ndarray_payload(obj)))
    elif isinstance(obj, (list, tuple)):
        out.append(_pack_len(len(obj), 0x90, 15, (None, 0xdc, 0xdd)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_pack_len(len(obj), 0x80, 15, (None, 0xde, 0xdf)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f'cannot write {type(obj).__name__} as msgpack')


def packb(obj) -> bytes:
    """Encode one object: None, bool, int, float, str, bytes, numpy arrays
    (flax's ext type 1), lists, tuples and dicts."""
    out: list = []
    _pack(obj, out)
    return b''.join(out)


def to_state_dict(tree):
    """The tree as flax stores it: lists and tuples become dicts keyed
    '0', '1', ..., dict keys become strings, in sorted order (flax rebuilds
    the tree with JAX's tree_map, which sorts them)."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        items = sorted(((str(k), v) for k, v in tree.items()), key=lambda kv: kv[0])
        return {k: to_state_dict(v) for k, v in items}
    return tree


def save_msgpack(path: str, tree) -> None:
    """Write `tree` in flax's msgpack format, atomically: to <path>.tmp, then
    os.replace onto `path` (JAX train/checkpoint.py:29-32)."""
    blob = packb(to_state_dict(tree))
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(blob)
    os.replace(tmp, path)
