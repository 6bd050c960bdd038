"""A frozen reader of flax msgpack checkpoints: the msgpack wire format
(maps, arrays, str, bin, ints, floats, nil, bool, ext) and flax's ndarray
extension (ext type 1: a packed (shape, dtype name, C-order buffer)).
Lists come back as dicts keyed '0', '1', ..., as flax stores them."""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_INTS = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
         0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}


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
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f'unsupported msgpack ext type {code}')
        shape, dtype_name, buf = _Reader(payload).value()
        return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()

    def value(self) -> Any:
        b = self.unpack('>B')
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
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
        if b in _INTS:
            return self.unpack(_INTS[b])
        if 0xd4 <= b <= 0xd8:
            return self.ext(self.unpack('>b'), 1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            return str(self.take(self.unpack({0xd9: '>B', 0xda: '>H', 0xdb: '>I'}[b])), 'utf-8')
        if b in (0xdc, 0xdd):
            return [self.value() for _ in range(self.unpack('>H' if b == 0xdc else '>I'))]
        if b in (0xde, 0xdf):
            return self.map(self.unpack('>H' if b == 0xde else '>I'))
        raise ValueError(f'invalid msgpack type byte 0x{b:02x}')

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def load(path: str) -> Any:
    """The nested tree of a flax msgpack file, arrays as numpy arrays."""
    with open(path, 'rb') as f:
        r = _Reader(f.read())
    tree = r.value()
    if r.pos != len(r.data):
        raise ValueError(f'{len(r.data) - r.pos} trailing bytes in {path}')
    return tree
