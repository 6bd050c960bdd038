"""Straight-through quantizers, forward only (JAX: ops/ste.py:24-69).

The evaluation path needs only the forward: clamp to the limit, then sign for
two levels or uniform rounding otherwise. The straight-through backward of the
JAX package's custom_vjp belongs to the training slice.
"""
from __future__ import annotations

import torch


def ste_quantize(x: torch.Tensor, value_limit: float = 1.0,
                 quantize_level: float = 2) -> torch.Tensor:
    lim = value_limit
    x_clamped = torch.clamp(x, -lim, lim)
    if quantize_level == 2:
        return torch.sign(x_clamped)
    scale = (quantize_level - 1.0) / (2.0 * lim)
    return torch.round((x_clamped + lim) * scale) / scale - lim


def rx_quantize(x: torch.Tensor, quant_limit: float = 1.0,
                quant_level: float = 2) -> torch.Tensor:
    """Received-signal quantizer (JAX ops/ste.py:57-61)."""
    return ste_quantize(x, quant_limit, quant_level)
