"""Trellis tables of rate-1/n convolutional codes (JAX: classical/trellis.py:20-158).

The port's own numpy copy of the table semantics of commpy's Trellis
(reference commpy/channelcoding/convcode.py:70-225), its dec2bitarray
index wrap for values wider than the bit width included. Only k=1 codes
occur in the reference (Turbo-757 G=[7,5] fb=7, Turbo-LTE G=[13,11]
fb=13); k>1 raises. The tables are tiny (2^M x 2) and built on the host;
`device_tables` hands them to the device decoders, one copy a device.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch


def dec2bitarray(in_number: int, bit_width: int) -> np.ndarray:
    """MSB-first bit array, with commpy's negative-index wrap for values
    wider than bit_width (commpy/utilities.py:24-50)."""
    binary_string = bin(int(in_number))
    length = len(binary_string)
    bitarray = np.zeros(bit_width, 'int')
    for i in range(length - 2):
        bitarray[bit_width - i - 1] = int(binary_string[length - i - 1])
    return bitarray


def bitarray2dec(in_bitarray) -> int:
    number = 0
    for i in range(len(in_bitarray)):
        number += int(in_bitarray[i]) * (2 ** (len(in_bitarray) - 1 - i))
    return number


class Trellis:
    """next_state_table and output_table of a k=1 rate-1/n convolutional code.

    memory: [M]; g_matrix: (1, n) octal generator polynomials; feedback: the
    octal feedback polynomial (code_type 'rsc' puts it on the diagonal,
    commpy convcode.py:159-161)."""

    def __init__(self, memory, g_matrix, feedback: int = 0, code_type: str = 'default'):
        memory = np.atleast_1d(np.asarray(memory))
        g_matrix = np.array(g_matrix, dtype=int, ndmin=2)
        self.k, self.n = g_matrix.shape
        if self.k != 1:
            raise NotImplementedError('only k=1 convolutional codes are supported '
                                      '(every code of the reference is k=1)')
        if code_type == 'rsc':
            g_matrix = g_matrix.copy()
            g_matrix[0][0] = feedback

        M = int(memory.sum())
        self.total_memory = M
        self.number_states = 2 ** M
        self.number_inputs = 2 ** self.k
        self.code_type = code_type

        fb_taps = dec2bitarray(feedback, M)
        gen_bits = [dec2bitarray(g_matrix[0][r], M + 1) for r in range(self.n)]
        nst = np.zeros((self.number_states, self.number_inputs), 'int')
        out = np.zeros((self.number_states, self.number_inputs), 'int')
        for state in range(self.number_states):
            sr = dec2bitarray(state, M)
            fb = int((fb_taps * sr).sum())                    # not reduced mod 2 (convcode.py:199)
            for u in range(self.number_inputs):
                outbits = np.zeros(self.n, 'int')
                for r in range(self.n):
                    contrib = int((sr * gen_bits[r][1:]).sum()) % 2
                    outbits[r] = (contrib + ((u * gen_bits[r][0] + fb) % 2)) % 2
                new_sr = np.empty(M, 'int')
                new_sr[1:] = sr[:-1]
                new_sr[0] = (u + fb) % 2                      # convcode.py:200-203
                out[state][u] = bitarray2dec(outbits)
                nst[state][u] = bitarray2dec(new_sr)
        self.next_state_table = nst
        self.output_table = out

    def output_bits(self) -> np.ndarray:
        """(states, inputs, n) binary output table."""
        tbl = np.zeros((self.number_states, self.number_inputs, self.n), 'int')
        for s in range(self.number_states):
            for u in range(self.number_inputs):
                tbl[s, u] = dec2bitarray(self.output_table[s, u], self.n)
        return tbl


def turbo757_trellis() -> Trellis:
    """Turbo-757 component code (reference encoders.py:784-787)."""
    return Trellis(np.array([2]), np.array([[7, 5]]), feedback=7)


def turbo_lte_trellis() -> Trellis:
    """Turbo-LTE component code (reference encoders.py:780-783)."""
    return Trellis(np.array([3]), np.array([[13, 11]]), feedback=13)


def device_tables(host: Dict[str, np.ndarray]) -> Callable[[torch.device], Dict[str, torch.Tensor]]:
    """fn(device) -> the host arrays as tensors on that device, copied once a
    device: integer arrays as int64, floating ones as f32, bool as bool."""
    def dtype(a):
        a = np.asarray(a)
        return a.astype(np.int64 if a.dtype.kind in 'iu' else np.float32 if a.dtype.kind == 'f' else a.dtype)
    host = {k: dtype(v) for k, v in host.items()}
    cache: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables(device):
        if device not in cache:
            cache[device] = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        return cache[device]
    return tables
