"""Learned modulation and demodulation (JAX: models/modulation.py; reference
modulations.py:46-110).

The modulator reshapes the codes (B, L, n) row-major into symbols of
mod_rate coded values, (B, L * n / mod_rate, mod_rate), and maps each to an
I/Q pair through 1x1 conv stacks: {'layer': mod_num_layer layers
mod_rate -> mod_num_unit with ELU, 'final': one layer to 2, no activation}.
Then one of three power controls (cfg.mod_pc):
  - 'qpsk': global whitening, then the modulation STE (ops/ste.py);
  - 'symbol_power': whitening per symbol position, statistics over the batch
    and I/Q axes, Bessel-corrected (reference modulations.py:74-81);
  - 'block_power': global whitening.
Means are taken as XLA takes them (utils/metrics.py:f32_mean), and under a
mesh (dist/mesh.py) over the global batch. The
demodulator maps received (B, L * n / mod_rate, 2) back to (B, L, n) through
{'layer': 2 -> demod_num_unit with ELU, 'final': to mod_rate}.
"""
from __future__ import annotations

import torch

from ..ops import conv1d as cv
from ..ops.ste import mod_quantize
from ..dist import mesh as dm
from ..utils.device import torch_dtype


def _whiten(x: torch.Tensor, dims=None) -> torch.Tensor:
    """(x - mean) / Bessel std over `dims` (all axes when None), kept for
    broadcasting."""
    mean = dm.batch_mean(x, dims, keepdim=True)
    ss = dm.batch_sum((x - mean) ** 2, dims, keepdim=True)
    return (x - mean) / torch.sqrt(ss / (dm.batch_count(x, dims) - 1))


def mod_init(gen: torch.Generator, cfg, device='cpu'):
    return {'layer': cv.stack_init(gen, cfg.mod_num_layer, cfg.mod_rate, cfg.mod_num_unit, 1,
                                   device),
            'final': cv.stack_init(gen, 1, cfg.mod_num_unit, 2, 1, device)}


def mod_apply(params, cfg, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, L, n) -> power-controlled symbols (B, L * n / mod_rate, 2)."""
    dt = torch_dtype(cfg.dtype)
    x = codes.reshape(codes.shape[0], cfg.block_len * cfg.code_rate_n // cfg.mod_rate,
                      cfg.mod_rate)
    h = cv.stack_apply(params['layer'], x, compute_dtype=dt)
    sym = cv.stack_apply(params['final'], h, no_act=True, compute_dtype=dt)
    if cfg.mod_pc == 'qpsk':
        return mod_quantize(_whiten(sym))
    if cfg.mod_pc == 'symbol_power':
        return _whiten(sym, (0, 2))
    return _whiten(sym)


def demod_init(gen: torch.Generator, cfg, device='cpu'):
    return {'layer': cv.stack_init(gen, cfg.demod_num_layer, 2, cfg.demod_num_unit, 1, device),
            'final': cv.stack_init(gen, 1, cfg.demod_num_unit, cfg.mod_rate, 1, device)}


def demod_apply(params, cfg, symbols: torch.Tensor) -> torch.Tensor:
    """received symbols (B, L * n / mod_rate, 2) -> (B, L, n)."""
    dt = torch_dtype(cfg.dtype)
    h = cv.stack_apply(params['layer'], symbols, compute_dtype=dt)
    out = cv.stack_apply(params['final'], h, no_act=True, compute_dtype=dt)
    return out.reshape(symbols.shape[0], cfg.block_len, cfg.code_rate_n)
