"""DSP extras: pulse-shaping filters, PN / Zadoff-Chu sequences, impairments.

Reference: commpy/filters.py:24-186, commpy/sequences.py:21-83,
commpy/impairments.py:21-40. Vectorized numpy; limit-point handling of the
(root-)raised-cosine filters matches the reference's special cases.
"""
from __future__ import annotations

import numpy as np


def rcosfilter(N: int, alpha: float, Ts: float, Fs: float):
    """Raised-cosine FIR impulse response; returns (time_idx, h)."""
    T_delta = 1.0 / Fs
    time_idx = (np.arange(N) - N / 2) * T_delta
    h = np.zeros(N)
    for x in range(N):
        t = (x - N / 2) * T_delta
        if t == 0.0:
            h[x] = 1.0
        elif alpha != 0 and abs(t) == Ts / (2 * alpha):
            h[x] = (np.pi / 4) * np.sinc(t / Ts)
        else:
            h[x] = np.sinc(t / Ts) * np.cos(np.pi * alpha * t / Ts) / \
                (1 - (2 * alpha * t / Ts) ** 2)
    return time_idx, h


def rrcosfilter(N: int, alpha: float, Ts: float, Fs: float):
    """Root-raised-cosine FIR impulse response; returns (time_idx, h)
    (reference filters.py:72-135)."""
    T_delta = 1.0 / Fs
    time_idx = (np.arange(N) - N / 2) * T_delta
    h = np.zeros(N)
    for x in range(N):
        t = (x - N / 2) * T_delta
        if t == 0.0:
            h[x] = 1.0 - alpha + (4 * alpha / np.pi)
        elif alpha != 0 and abs(t) == Ts / (4 * alpha):
            h[x] = (alpha / np.sqrt(2)) * (
                ((1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))) +
                ((1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha))))
        else:
            h[x] = (np.sin(np.pi * t * (1 - alpha) / Ts) +
                    4 * alpha * (t / Ts) * np.cos(np.pi * t * (1 + alpha) / Ts)) / \
                (np.pi * t * (1 - (4 * alpha * t / Ts) ** 2) / Ts)
    return time_idx, h


def gaussianfilter(N: int, alpha: float, Ts: float, Fs: float):
    """Gaussian FIR impulse response (reference filters.py:138-165)."""
    T_delta = 1.0 / Fs
    time_idx = (np.arange(N) - N / 2) * T_delta
    h = (np.sqrt(np.pi) / alpha) * np.exp(-(np.pi * time_idx / alpha) ** 2)
    return time_idx, h


def rectfilter(N: int, Ts: float, Fs: float):
    """Rectangular FIR impulse response (reference filters.py:168-186)."""
    h = np.ones(N)
    time_idx = (np.arange(N) - N / 2) / Fs
    return time_idx, h


def pnsequence(pn_order: int, pn_seed: str, pn_mask: str,
               seq_length: int) -> np.ndarray:
    """LFSR PN sequence (reference sequences.py:21-66): output tap is the last
    register stage; feedback is XOR of masked stages; register rolls right."""
    sr = np.array([int(c) for c in pn_seed])
    mask = np.array([int(c) for c in pn_mask])
    out = np.zeros(seq_length, int)
    for i in range(seq_length):
        new_bit = int(np.bitwise_xor.reduce(sr[mask == 1])) if mask.any() else 0
        out[i] = sr[pn_order - 1]
        sr = np.roll(sr, 1)
        sr[0] = new_bit
    return out


def zcsequence(u: int, seq_length: int) -> np.ndarray:
    """Zadoff-Chu sequence (reference sequences.py:68-83)."""
    n = np.arange(seq_length)
    return np.exp(-1j * np.pi * u * n * (n + 1) / seq_length)


def add_frequency_offset(waveform, Fs: float, delta_f: float) -> np.ndarray:
    """Carrier frequency offset impairment (reference impairments.py:21-40)."""
    waveform = np.asarray(waveform)
    return waveform * np.exp(1j * 2 * np.pi * (delta_f / Fs) *
                             np.arange(len(waveform)))
