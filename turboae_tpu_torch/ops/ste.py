"""Straight-through quantizers (JAX: ops/ste.py:24-69).

Forward: clamp to the limit, then sign for two levels or uniform rounding
otherwise. Backward (`_STE.backward`, JAX `_ste_bwd`, :48-54): the incoming
gradient passes straight through, first zeroed where the SAVED INPUT lies
outside [-limit, limit] ('inputs' / 'both'), THEN clamped to
[-grad_limit, grad_limit] ('gradient' / 'both'), in that order.
"""
from __future__ import annotations

import torch

CLIPPING = ('inputs', 'gradient', 'both', 'none')


def _quantize_fwd(x: torch.Tensor, value_limit: float, quantize_level: float) -> torch.Tensor:
    lim = value_limit
    x_clamped = torch.clamp(x, -lim, lim)
    if quantize_level == 2:
        return torch.sign(x_clamped)
    scale = (quantize_level - 1.0) / (2.0 * lim)
    return torch.round((x_clamped + lim) * scale) / scale - lim


class _STE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, value_limit, quantize_level, grad_limit, clipping):
        ctx.save_for_backward(x)
        ctx.value_limit, ctx.grad_limit, ctx.clipping = value_limit, grad_limit, clipping
        return _quantize_fwd(x, value_limit, quantize_level)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lim = ctx.value_limit
        if ctx.clipping in ('inputs', 'both'):
            g = torch.where((x <= lim) & (x >= -lim), g, torch.zeros_like(g))
        if ctx.clipping in ('gradient', 'both'):
            g = torch.clamp(g, -ctx.grad_limit, ctx.grad_limit)
        return g, None, None, None, None


def ste_quantize(x: torch.Tensor, value_limit: float = 1.0, quantize_level: float = 2,
                 grad_limit: float = 0.01, clipping: str = 'both') -> torch.Tensor:
    """STE quantizer; clipping in {'inputs', 'gradient', 'both', 'none'}."""
    if clipping not in CLIPPING:
        raise ValueError(f'clipping must be one of {CLIPPING}, got {clipping!r}')
    return _STE.apply(x, value_limit, quantize_level, grad_limit, clipping)


def rx_quantize(x: torch.Tensor, quant_limit: float = 1.0,
                quant_level: float = 2) -> torch.Tensor:
    """Received-signal quantizer (JAX ops/ste.py:60-63): gradient gated to
    the limit and clamped to +-0.25."""
    return ste_quantize(x, quant_limit, quant_level, 0.25, 'both')


def mod_quantize(x: torch.Tensor) -> torch.Tensor:
    """Modulation STE (JAX ops/ste.py:66-69): limit 1.0, binary, input gating
    only."""
    return ste_quantize(x, 1.0, 2, 0.0, 'inputs')
