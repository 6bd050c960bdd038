"""The flagship encoder ENC_interCNN (JAX: models/encoders.py:37-79).

Params: {'b1' | 'b2' | 'b3': {'cnn': [conv layers], 'lin': linear head}} in
PyTorch's layout (see ops/conv1d.py). Bits x are (B, L, k) in {0, 1}; codes
are (B, L, 3). The encoder's conv stacks run unfused, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..ops import conv1d as cv
from ..ops.activations import activation
from ..ops.interleave import interleave
from ..ops.power import power_constraint
from ..utils.device import torch_dtype


def _branch_init(gen, cfg, device):
    """One branch: a conv stack code_rate_k -> enc_num_unit and a head to 1."""
    return {'cnn': cv.stack_init(gen, cfg.enc_num_layer, cfg.code_rate_k,
                                 cfg.enc_num_unit, cfg.enc_kernel_size, device),
            'lin': cv.linear_init(gen, cfg.enc_num_unit, 1, device)}


def intercnn_init(gen: torch.Generator, cfg, device='cpu'):
    """Params of the three branches b1, b2, b3 (JAX encoders.py:62-67)."""
    if cfg.encoder != 'TurboAE_rate3_cnn':
        raise NotImplementedError(f'encoder {cfg.encoder!r} is not ported yet (ROADMAP M9/M11)')
    return {name: _branch_init(gen, cfg, device) for name in ('b1', 'b2', 'b3')}


def _branch_apply(p, cfg, x):
    dt = torch_dtype(cfg.dtype)
    h = cv.stack_apply(p['cnn'], x, compute_dtype=dt)
    return activation(cfg.enc_act)(cv.linear_apply(p['lin'], h, compute_dtype=dt))


def intercnn_apply(params, cfg, x, perms, training=True, stats=None):
    """Returns (codes, stats). perms['p1'] is the forward interleaver."""
    if cfg.encoder != 'TurboAE_rate3_cnn':
        raise NotImplementedError(f'encoder {cfg.encoder!r} is not ported yet (ROADMAP M9/M11)')
    x = 2.0 * x - 1.0                       # BPSK map (JAX encoders.py:71)
    x_sys = _branch_apply(params['b1'], cfg, x)
    x_p1 = _branch_apply(params['b2'], cfg, x)
    x_p2 = _branch_apply(params['b3'], cfg, interleave(x, perms['p1']))
    x_tx = torch.cat([x_sys, x_p1, x_p2], dim=2)
    return power_constraint(x_tx, cfg, training, stats)
