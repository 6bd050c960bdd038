"""Channel impairments of the classical benchmarks, on the host in numpy
(JAX: classical/channels.py; reference commpy/utils.py:45-247 corrupt_signal,
commpy/channels.py awgn/bsc/bec).

The port's own copy, line for line; its SNR conversions are
utils/metrics.py's. Every sampler draws from the GLOBAL
numpy RNG, as JAX's does, so a CLI run seeded by np.random.seed gets the
same received symbols as JAX's. The reference's per-sample Gilbert-Elliott
loop is vectorized by the cumulative parity of the Markov chain's flips.
"""
from __future__ import annotations

import math

import numpy as np

from ..utils.metrics import snr_db2sigma, snr_sigma2db  # noqa: F401  (re-exported, as JAX's module has them)


def _ge_states(length, p_stay=0.8, rng=np.random):
    """Vectorized 2-state Markov chain starting in the good state."""
    stay = rng.random_sample(length) < p_stay
    # state flips when stay=False; cumulative parity of flips gives the state
    flips = ~stay
    state_changes = np.cumsum(np.concatenate([[0], flips[:-1]])) % 2
    return state_changes == 0  # True = good


def corrupt_signal(input_signal, noise_type, sigma=1.0, vv=5.0,
                   radar_power=20.0, radar_prob=5e-2, denoise_thd=10.0,
                   modulate_mode='bpsk', snr_mixture=(0, 0, 0)):
    """BPSK-modulate and corrupt a bit stream (reference utils.py:45-247)."""
    x = np.asarray(input_signal, float)
    shape = x.shape
    bpsk = 2.0 * x - 1.0

    if noise_type == 'awgn':
        return bpsk + sigma * np.random.standard_normal(shape)

    if noise_type == 'bsc':
        flip = np.random.choice([-1.0, 1.0], shape, p=[sigma, 1 - sigma])
        return bpsk * flip

    if noise_type == 'bec':
        keep = np.random.choice([0.0, 1.0], shape, p=[sigma, 1 - sigma])
        return bpsk * keep

    if noise_type == 'ge':
        good = _ge_states(shape[0])
        keep_prob = np.where(good, 1.0, sigma)
        flip = np.where(np.random.random_sample(shape[0]) < keep_prob, 1.0, -1.0)
        return bpsk * flip

    if noise_type == 'ge_awgn':
        good = _ge_states(shape[0])
        sig_good = snr_db2sigma(snr_sigma2db(sigma) + 1)
        sig_bad = snr_db2sigma(snr_sigma2db(sigma) - 1)
        sig = np.where(good, sig_good, sig_bad)
        return bpsk + sig * np.random.standard_normal(shape)

    if noise_type == 'fading':
        h = np.sqrt(np.random.standard_normal(shape) ** 2 +
                    np.random.standard_normal(shape) ** 2) / np.sqrt(3.14 / 2.0)
        return h * bpsk + sigma * np.random.standard_normal(shape)

    if noise_type == 't-dist':
        noise = sigma * math.sqrt((vv - 2.0) / vv) * \
            np.random.standard_t(vv, size=shape)
        return bpsk + noise

    if noise_type == 'radar':
        rx = bpsk + sigma * np.random.standard_normal(shape)
        add_pos = np.random.choice([0.0, 1.0], shape,
                                   p=[1 - radar_prob, radar_prob])
        return rx + radar_power * np.random.standard_normal(shape) * add_pos

    if noise_type == 'awgn+radar':
        rx = bpsk + sigma * np.random.standard_normal(shape)
        add_pos = np.random.choice([-1.0, 0.0, 1.0], shape,
                                   p=[radar_prob / 2, 1 - radar_prob,
                                      radar_prob / 2])
        keep = 1.0 - np.abs(add_pos)
        return rx * keep + np.random.normal(radar_power, 1.0, shape) * add_pos

    if noise_type == 'awgn+radar+denoise':
        rx = corrupt_signal(x, 'awgn+radar', sigma, vv, radar_power, radar_prob)
        return np.clip(rx, -denoise_thd, denoise_thd)

    if noise_type in ('hyeji_bursty+denoise', 'radar_saturate', 'radar_erasure'):
        rx = bpsk + sigma * np.random.standard_normal(shape)
        add_pos = np.random.choice([0.0, 1.0], shape,
                                   p=[1 - radar_prob, radar_prob])
        rx = rx + radar_power * np.random.standard_normal(shape) * add_pos
        if denoise_thd == 10.0:
            # optimal threshold (reference utils.py:170-174) + 1
            s1, s2 = sigma, radar_power
            a = math.sqrt((2 * s1 ** 2 * (s1 ** 2 + s2 ** 2) / s2 ** 2) *
                          math.log(math.sqrt(s1 ** 2 + s2 ** 2) / s1)) + 1
        else:
            a = denoise_thd
        rx = np.clip(rx, -a, a)
        if noise_type in ('hyeji_bursty+denoise', 'radar_erasure'):
            rx = rx * (rx != a).astype(float)   # erase saturated positions
        return rx

    if noise_type in ('mixture', 'mixture-normalized'):
        ref_sigma = 1.0  # 0 dB
        rx_ref = bpsk + ref_sigma * np.random.standard_normal(shape)
        rx = bpsk + sigma * np.random.standard_normal(shape)
        add_pos = np.random.choice([0.0, 1.0], shape, p=[0.5, 0.5])
        keep = 1.0 - add_pos
        if noise_type == 'mixture-normalized':
            return rx_ref * keep / ref_sigma ** 2 + rx * add_pos / sigma ** 2
        return rx_ref * keep + rx * add_pos

    if noise_type == 'mix_snr_turbo':
        return bpsk + snr_mixture[0] * np.random.standard_normal(shape)

    if noise_type == 'random_snr_turbo':
        s = np.random.uniform(snr_mixture[2], snr_mixture[0], shape)
        return bpsk + s * np.random.standard_normal(shape)

    # fallback: awgn
    return bpsk + sigma * np.random.standard_normal(shape)


def awgn(input_signal, snr_dB, rate=1.0):
    """Additive white Gaussian noise channel (reference commpy/channels.py:29-64);
    supports complex signals."""
    x = np.asarray(input_signal)
    avg_energy = np.sum(np.abs(x) ** 2) / len(x)
    snr_linear = 10 ** (snr_dB / 10.0)
    noise_variance = avg_energy / (2 * rate * snr_linear)
    if x.dtype in (complex, np.complex64, np.complex128):
        noise = (np.sqrt(noise_variance) * np.random.randn(len(x)) +
                 1j * np.sqrt(noise_variance) * np.random.randn(len(x)))
    else:
        noise = np.sqrt(2 * noise_variance) * np.random.randn(len(x))
    return x + noise


def bsc(input_bits, p_t):
    """Binary symmetric channel (reference commpy/channels.py:67-92)."""
    output_bits = np.asarray(input_bits).copy()
    flip = np.random.random_sample(output_bits.shape) < p_t
    return output_bits ^ flip


def bec(input_bits, p_e):
    """Binary erasure channel: erased positions become -1
    (reference commpy/channels.py:95-117)."""
    out = np.asarray(input_bits).copy().astype(float)
    out[np.random.random_sample(out.shape) < p_e] = -1
    return out


def get_test_sigmas(snr_start, snr_end, snr_points):
    """SNR sweep grid + sigmas (reference commpy/utils.py:404-429)."""
    snrs = np.linspace(snr_start, snr_end, snr_points)
    sigmas = np.array([snr_db2sigma(s) for s in snrs])
    return snrs, sigmas
