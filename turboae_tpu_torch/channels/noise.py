"""Channel noise (JAX: channels/noise.py:36-41, 131-157), AWGN branch.

Noise is drawn on the device from an explicit torch.Generator. The JAX
package draws from jax.random, so the two agree in distribution, not in value;
tests hand both sides the same noise instead.

Training noise (`generate_noise` without `test_sigma`) has a per-element
sigma drawn uniformly in [sigma(snr_high), sigma(snr_low)]; the trainer
passes the encoder phase's or the decoder phase's SNR range.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils.metrics import snr_db2sigma


def _check_channel(cfg):
    if cfg.channel != 'awgn':
        raise NotImplementedError(f'channel {cfg.channel!r} is not ported yet')


def sample_noise(shape, cfg, sigma, generator: torch.Generator, device) -> torch.Tensor:
    """sigma * N(0, 1); sigma is a float or a tensor broadcast to `shape`."""
    _check_channel(cfg)
    return sigma * torch.randn(shape, generator=generator, device=device)


def train_sigma(shape, snr_low: float, snr_high: float, generator: torch.Generator,
                device) -> torch.Tensor:
    """Per-element uniform sigma in [sigma(snr_high), sigma(snr_low)]."""
    s_low = snr_db2sigma(snr_low)      # the larger sigma (lower SNR)
    s_high = snr_db2sigma(snr_high)
    u = torch.rand(shape, generator=generator, device=device)
    return (s_low - s_high) * u + s_high


def generate_noise(shape, cfg, generator: torch.Generator, device,
                   test_sigma: Optional[float] = None, snr_low: float = 0.0,
                   snr_high: float = 0.0) -> torch.Tensor:
    """Training noise (test_sigma None) at a uniform sigma mixture over
    [snr_low, snr_high] dB, or test noise at test_sigma dB."""
    _check_channel(cfg)
    if test_sigma is None:
        sigma = train_sigma(shape, snr_low, snr_high, generator, device)
    else:
        sigma = snr_db2sigma(test_sigma)
    return sample_noise(shape, cfg, sigma, generator, device)
