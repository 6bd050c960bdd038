"""Modem / DSP layer: PSK & QAM modems with hard and soft (LLR) demodulation,
OFDM tx/rx, MIMO ML detection.

Reference: commpy/modulation.py:26-193 (py2-era). Vectorized numpy
re-implementation with identical constellation/bit-mapping conventions:
PSK symbol i -> exp(j*2*pi*(i-1)/m); QAM from the (2i-1) offset grid over the
product mapping; soft demod LLR = log(sum_1 exp(-|y-c|^2/N0) /
sum_0 exp(-|y-c|^2/N0)) with the reference's bit ordering.
"""
from __future__ import annotations

from itertools import product

import numpy as np

from .trellis import dec2bitarray


class Modem:
    constellation: np.ndarray
    num_bits_symbol: int
    symbol_mapping: np.ndarray

    def modulate(self, input_bits) -> np.ndarray:
        bits = np.asarray(input_bits).astype(int)
        nb = self.num_bits_symbol
        n_sym = len(bits) // nb
        idx = bits[:n_sym * nb].reshape(n_sym, nb)
        weights = 2 ** np.arange(nb - 1, -1, -1)
        return self.constellation[idx @ weights]

    def demodulate(self, input_symbols, demod_type: str, noise_var: float = 0):
        y = np.asarray(input_symbols)
        nb = self.num_bits_symbol
        if demod_type == 'hard':
            d = np.abs(y[:, None] - self.constellation[None, :])
            idx = np.argmin(d, axis=1)
            out = np.zeros(len(y) * nb, int)
            for i, v in enumerate(idx):
                out[i * nb:(i + 1) * nb] = dec2bitarray(int(v), nb)
            return out
        if demod_type == 'soft':
            # exp(-|y - c|^2 / N0) per (symbol, const point)
            metric = np.exp(-np.abs(y[:, None] - self.constellation[None, :]) ** 2
                            / noise_var)
            out = np.zeros(len(y) * nb)
            const_idx = np.asarray(self.symbol_mapping)
            for bit_index in range(nb):
                one_mask = ((const_idx >> bit_index) & 1).astype(bool)
                llr_num = metric[:, one_mask].sum(axis=1)
                llr_den = metric[:, ~one_mask].sum(axis=1)
                # reference stores bit_index into position nb-1-bit_index
                out[nb - 1 - bit_index::nb] = np.log(llr_num / llr_den)
            return out
        raise ValueError(f'unknown demod_type {demod_type}')


class PSKModem(Modem):
    """m-PSK (reference modulation.py:97-117): symbol i -> angle 2pi(i-1)/m."""

    def __init__(self, m: int):
        self.m = m
        self.num_bits_symbol = int(np.log2(m))
        self.symbol_mapping = np.arange(m)
        i = self.symbol_mapping
        self.constellation = (np.cos(2 * np.pi * (i - 1) / m) +
                              1j * np.sin(2 * np.pi * (i - 1) / m))


class QAMModem(Modem):
    """Square m-QAM (reference modulation.py:119-139)."""

    def __init__(self, m: int):
        self.m = m
        self.num_bits_symbol = int(np.log2(m))
        self.symbol_mapping = np.arange(m)
        side = int(np.sqrt(m))
        mapping = np.arange(1, side + 1) - side / 2.0
        self.constellation = np.array(
            [(2 * a - 1) + 1j * (2 * b - 1) for a, b in product(mapping, repeat=2)])


def ofdm_tx(x, nfft: int, nsc: int, cp_length: int) -> np.ndarray:
    """OFDM transmit: map nsc subcarriers into nfft bins, IFFT, prepend CP
    (reference modulation.py:141-157)."""
    x = np.asarray(x)
    out = []
    for i in range(x.shape[1]):
        symbols = x[:, i]
        freq = np.zeros(nfft, complex)
        freq[1:nsc // 2 + 1] = symbols[nsc // 2:]
        freq[-(nsc // 2):] = symbols[:nsc // 2]
        t = np.fft.ifft(freq)
        out.append(np.concatenate([t[-cp_length:], t]))
    return np.concatenate(out)


def ofdm_rx(y, nfft: int, nsc: int, cp_length: int) -> np.ndarray:
    """OFDM receive: strip CP, FFT, de-map subcarriers
    (reference modulation.py:159-171)."""
    y = np.asarray(y)
    n_sym = len(y) // (nfft + cp_length)
    x_hat = np.zeros((nsc, n_sym), complex)
    for i in range(n_sym):
        sym = y[i * nfft + (i + 1) * cp_length:(i + 1) * (nfft + cp_length)]
        freq = np.fft.fft(sym)
        x_hat[:, i] = np.concatenate([freq[-(nsc // 2):], freq[1:nsc // 2 + 1]])
    return x_hat


def mimo_ml(y, h, constellation) -> np.ndarray:
    """2x2 MIMO maximum-likelihood detection (reference modulation.py:173-193)."""
    constellation = np.asarray(constellation)
    m = len(constellation)
    x_ideal = np.array([np.tile(constellation, m),
                        np.repeat(constellation, m)])
    y_vec = np.tile(np.asarray(y).reshape(-1, 1), (1, m * m))
    min_idx = np.argmin(np.sum(np.abs(y_vec - h @ x_ideal), axis=0))
    return x_ideal[:, min_idx]
