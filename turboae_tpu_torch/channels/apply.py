"""Channel application (JAX: channels/apply.py:18-20), additive branch."""
from __future__ import annotations

import torch


def apply_channel(codes: torch.Tensor, noise: torch.Tensor, channel: str) -> torch.Tensor:
    if channel != 'awgn':
        raise NotImplementedError(f'channel {channel!r} is not ported yet')
    return codes + noise
