"""The classical random interleaver and its MT19937 seed contract
(JAX: classical/interleavers.py; reference commpy/channelcoding/interleavers.py:13-82).

RandInterlv(length, seed) draws numpy.random.RandomState(seed).permutation
of arange(length); seed 0 is the permutation the classical and neural
stacks share (reference channel_ae.py:33, turbo_codes_benchmark.py:74).
"""
from __future__ import annotations

import numpy as np

from ..ops.interleave import rand_perm


class RandInterlv:
    def __init__(self, length: int, seed: int):
        self.p_array = rand_perm(length, seed)

    def interlv(self, in_array):
        return np.asarray(in_array)[self.p_array]

    def deinterlv(self, in_array):
        in_array = np.asarray(in_array)
        out = np.zeros(len(in_array), in_array.dtype)
        out[self.p_array] = in_array
        return out
