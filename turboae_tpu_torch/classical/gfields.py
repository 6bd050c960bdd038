"""Binary Galois fields GF(2^m) and polynomial helpers.

Clean-room reimplementation of the commpy GF API
(reference: commpy/channelcoding/gfields.py:15-196) built on log/antilog
tables instead of per-element bit-twiddling loops — same primitive
polynomials, same element/power conventions, validated against the reference
golden vectors (tests/test_torch_classical_ext.py).
"""
from __future__ import annotations

from math import gcd
from typing import List

import numpy as np

# primitive polynomial per m (same table as the reference, gfields.py:50-51)
PRIMPOLYS = [0, 3, 7, 11, 19, 37, 67, 137, 285, 529, 1033,
             2053, 4179, 8219, 17475, 32771, 69643]


def _build_tables(m: int, prim_poly: int):
    """antilog[i] = alpha^i (tuple form); log[x] = power of x."""
    q = 2 ** m
    antilog = np.zeros(q - 1, int)
    log = np.zeros(q, int)
    x = 1
    for i in range(q - 1):
        antilog[i] = x
        log[x] = i
        x <<= 1
        if x & q:
            x ^= prim_poly
    return antilog, log


_TABLE_CACHE = {}


def _tables(m: int):
    if m not in _TABLE_CACHE:
        _TABLE_CACHE[m] = _build_tables(m, PRIMPOLYS[m])
    return _TABLE_CACHE[m]


def polydivide(x: int, y: int) -> int:
    """Remainder of GF(2) polynomial division x mod y (gfields.py:166-176)."""
    dy = y.bit_length()
    while x.bit_length() >= dy:
        x ^= y << (x.bit_length() - dy)
    return x


def polymultiply(x: int, y: int, m: int, prim_poly: int) -> int:
    """GF(2^m) product of tuple-form elements modulo prim_poly."""
    prod = 0
    a, b = int(x), int(y)
    while b:
        if b & 1:
            prod ^= a
        a <<= 1
        b >>= 1
    return polydivide(prod, prim_poly)


def poly_to_string(x: int) -> str:
    terms = []
    i = 0
    while x:
        if x & 1:
            terms.append(f'x^{i}')
        x >>= 1
        i += 1
    return ' + '.join(terms)


class GF:
    """Element set of GF(2^m) in tuple (polynomial-coefficient) form."""

    def __init__(self, x, m: int):
        self.m = m
        self.prim_poly = PRIMPOLYS[m]
        if isinstance(x, (int, np.integer)):
            self.elements = np.array([int(x)])
        else:
            self.elements = np.asarray(x).astype(int)

    def __add__(self, other: 'GF') -> 'GF':
        if len(self.elements) != len(other.elements):
            raise ValueError('element counts must match')
        return GF(self.elements ^ other.elements, self.m)

    def __mul__(self, other: 'GF') -> 'GF':
        if len(self.elements) != len(other.elements):
            raise ValueError('element counts must match')
        antilog, log = _tables(self.m)
        a, b = self.elements, other.elements
        out = np.zeros_like(a)
        nz = (a != 0) & (b != 0)
        out[nz] = antilog[(log[a[nz]] + log[b[nz]]) % (2 ** self.m - 1)]
        return GF(out, self.m)

    def power_to_tuple(self) -> 'GF':
        """alpha^i -> tuple form (gfields.py:75-85)."""
        antilog, _ = _tables(self.m)
        return GF(antilog[self.elements % (2 ** self.m - 1)], self.m)

    def tuple_to_power(self) -> 'GF':
        """tuple form -> power of alpha; 0 maps to 0 (gfields.py:87-104)."""
        _, log = _tables(self.m)
        out = np.where(self.elements != 0, log[self.elements], 0)
        return GF(out, self.m)

    def order(self) -> np.ndarray:
        """Multiplicative order of each element (gfields.py:106-114)."""
        n = 2 ** self.m - 1
        powers = self.tuple_to_power().elements
        return np.array([n // gcd(int(p), n) for p in powers], float)

    def cosets(self) -> List['GF']:
        """Cyclotomic cosets grouping elements by conjugacy (gfields.py:116-139)."""
        n = 2 ** self.m - 1
        powers = self.tuple_to_power().elements
        mark = np.zeros(len(powers), int)
        count = 1
        for idx in range(len(powers)):
            if mark[idx] == 0:
                a = int(powers[idx])
                mark[idx] = count
                i = 1
                while (a * (2 ** i)) % n != a:
                    target = (a * (2 ** i)) % n
                    for j in range(len(powers)):
                        if mark[j] == 0 and powers[j] == target:
                            mark[j] = count
                    i += 1
                count += 1
        return [GF(self.elements[mark == c], self.m) for c in range(1, count)]

    def minpolys(self) -> np.ndarray:
        """Minimal polynomial (as integer bitmask) of each element
        (gfields.py:141-163): prod over the conjugacy class of (x - root)."""
        full = GF(np.arange(2 ** self.m), self.m)
        full_cosets = full.cosets()
        out = []
        for x in self.elements:
            for coset in full_cosets:
                if x in coset.elements:
                    # poly coefficients in GF(2^m), ascending degree:
                    # start with (x + root0)
                    poly = [int(coset.elements[0]), 1]
                    for root in coset.elements[1:]:
                        root = int(root)
                        # poly *= (x + root)
                        new = [0] * (len(poly) + 1)
                        for d, c in enumerate(poly):
                            new[d + 1] ^= c
                            new[d] ^= polymultiply(c, root, self.m,
                                                   self.prim_poly)
                        poly = new
                    # coefficients end up in {0,1}; pack to integer
                    val = 0
                    for d, c in enumerate(poly):
                        if c:
                            val |= (1 << d)
                    out.append(val)
                    break
        return np.array(out, int)
