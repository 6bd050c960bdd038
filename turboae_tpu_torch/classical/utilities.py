"""Bit/array utilities (reference commpy/utilities.py:24-142).

dec2bitarray / bitarray2dec live in classical.trellis (they carry the
index-wrap quirk the trellis build depends on) and are re-exported here.
"""
from __future__ import annotations

import numpy as np

from .trellis import bitarray2dec, dec2bitarray  # noqa: F401


def hamming_dist(in_bitarray_1, in_bitarray_2) -> int:
    """Hamming distance between bit arrays (utilities.py:74-94)."""
    return int(np.bitwise_xor(np.asarray(in_bitarray_1, int),
                              np.asarray(in_bitarray_2, int)).sum())


def euclid_dist(in_array1, in_array2) -> float:
    """Squared euclidean distance (utilities.py:96-115)."""
    d = np.asarray(in_array1, float) - np.asarray(in_array2, float)
    return float((d * d).sum())


def upsample(x, n: int) -> np.ndarray:
    """Insert n-1 zeros between samples (utilities.py:117-142)."""
    x = np.asarray(x)
    y = np.zeros(len(x) * n, dtype=complex)
    y[0::n] = x
    return y
