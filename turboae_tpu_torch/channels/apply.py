"""Channel application: the transmitted codes combined with the sampled noise
(JAX: channels/apply.py:18-33; reference channel_ae.py:41-65).

  - additive channels (awgn, t-dist, radar, ge_awgn): codes + noise;
  - erasure (bec):                                    codes * mask;
  - flip (bsc, and ge as the reference routes it):    codes * (2 mask - 1);
  - non-coherent Rayleigh fading:                     h * codes + noise,
    h = sqrt(N1^2 + N2^2) / sqrt(3.14 / 2) (the reference's 3.14, kept);
  - any other channel: codes + noise, as the JAX package falls back.

Fading draws its gain from an explicit torch.Generator; a fading call
without one raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dist import mesh as dm


def fading_gain(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Rayleigh gain normalised by the reference's sqrt(3.14 / 2), drawn on
    the generator's device and returned on `device`; under a mesh drawn at
    the global batch, this rank's rows kept (dist/mesh.py:rows)."""
    def draw(s):
        n1 = torch.randn(s, generator=generator, device=generator.device)
        n2 = torch.randn(s, generator=generator, device=generator.device)
        return torch.sqrt(n1 ** 2 + n2 ** 2) / (3.14 / 2.0) ** 0.5
    return dm.rows(draw, shape).to(device)


def apply_channel(codes: torch.Tensor, noise: torch.Tensor, channel: str,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if channel == 'bec':
        return codes * noise
    if channel in ('bsc', 'ge'):
        return codes * (2.0 * noise - 1.0)
    if channel == 'fading':
        if generator is None:
            raise ValueError('the fading channel draws its gain from a generator; '
                             'pass generator=')
        return fading_gain(codes.shape, generator, codes.device) * codes + noise
    return codes + noise
