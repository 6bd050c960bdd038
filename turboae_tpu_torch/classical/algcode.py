"""Algebraic (cyclic) codes: generator polynomial enumeration.

Reference: commpy/channelcoding/algcode.py:14-67. Enumerates products of
minimal polynomials of cyclotomic-coset leaders whose degrees sum to n-k.
Validated against the reference golden vectors (tests/test_torch_classical_ext.py).
"""
from __future__ import annotations

import numpy as np

from .gfields import GF
from .trellis import dec2bitarray


def _polymul_gf2(a: int, b: int) -> int:
    prod = 0
    while b:
        if b & 1:
            prod ^= a
        a <<= 1
        b >>= 1
    return prod


def cyclic_code_genpoly(n: int, k: int) -> np.ndarray:
    """All generator polynomials (as integers) of the (n, k) cyclic code."""
    if n % 2 == 0:
        raise ValueError('n cannot be an even number')

    for m in range(1, 18):
        if (2 ** m - 1) % n == 0:
            break

    x_gf = GF(np.arange(1, 2 ** m), m)
    coset_fields = x_gf.cosets()

    coset_leaders = np.array([f.elements[0] for f in coset_fields])
    minpol_degrees = np.array([len(f.elements) for f in coset_fields])

    minpol_list = GF(coset_leaders, m).minpolys()
    poly_list = []

    for i in range(1, 2 ** len(minpol_list)):
        mask = dec2bitarray(i, len(minpol_list))
        if int(minpol_degrees[mask == 1].sum()) == n - k:
            gpoly = 1
            for poly in minpol_list[mask == 1]:
                gpoly = _polymul_gf2(int(gpoly), int(poly))
            poly_list.append(gpoly)

    return np.array(poly_list, int)
