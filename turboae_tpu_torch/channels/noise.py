"""Channel noise (JAX: channels/noise.py:35-46), AWGN branch.

Noise is drawn on the device from an explicit torch.Generator. The JAX
package draws from jax.random, so the two agree in distribution, not in value;
tests hand both sides the same noise instead.
"""
from __future__ import annotations

import torch


def sample_noise(shape, cfg, sigma: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    if cfg.channel != 'awgn':
        raise NotImplementedError(f'channel {cfg.channel!r} is not ported yet')
    return sigma * torch.randn(shape, generator=generator, device=device)
