"""Encoders and their registry (JAX: models/encoders.py:37-79,192-259,349-376).

ENC_interCNN, the flagship's, in both conv flavours: 'TurboAE_rate3_cnn'
with plain stacks and 'TurboAE_rate3_cnn_dense' with dense ones. Params:
{'b1' | 'b2' | 'b3': {'cnn': [conv layers], 'lin': linear head}} in
PyTorch's layout (see ops/conv1d.py). Bits x are (B, L, k) in {0, 1}; codes
are (B, L, n). The encoder's conv stacks run unfused, as in the JAX package.

The RNN encoders (ops/gru.py) have branches {'rnn': [biRNN layers],
'lin': head from 2 * enc_num_unit}: 'Turboae_rate3_rnn' (three branches,
cfg.enc_rnn), 'TurboAE_rate3_rnn_sys' (a hard systematic bit and two
parity branches) and 'TurboAE_rate2_rnn' (two branches, always GRU). They
read the raw bits, with no BPSK map, as the reference does.

`make_encoder(cfg)` gives (init, apply) for cfg.encoder; DeepTurbo's fixed
classical encoders come from models/deepturbo.py. A key of the JAX
registry that is not ported yet raises NotImplementedError naming its
ROADMAP item; an unknown key raises ValueError, as in JAX.
"""
from __future__ import annotations

import torch

from ..ops import conv1d as cv
from ..ops import gru as rnn
from ..ops.activations import activation
from ..ops.interleave import interleave
from ..ops.power import power_constraint
from ..utils.device import torch_dtype


def dense(cfg) -> bool:
    """Whether cfg's CNN stacks are dense: the reference keys the flavour of
    both the encoder's and DEC_LargeCNN's stacks off the ENCODER's name
    (decoders.py:172-176); plain only for the flagship's."""
    return cfg.encoder != 'TurboAE_rate3_cnn'


def _branch_init(gen, cfg, device, is_dense: bool):
    """One branch: a conv stack code_rate_k -> enc_num_unit and a head to 1."""
    init = cv.dense_stack_init if is_dense else cv.stack_init
    return {'cnn': init(gen, cfg.enc_num_layer, cfg.code_rate_k, cfg.enc_num_unit,
                        cfg.enc_kernel_size, device),
            'lin': cv.linear_init(gen, cfg.enc_num_unit, 1, device)}


def intercnn_init(gen: torch.Generator, cfg, device='cpu'):
    """Params of the three branches b1, b2, b3 (JAX encoders.py:62-67)."""
    return {name: _branch_init(gen, cfg, device, dense(cfg)) for name in ('b1', 'b2', 'b3')}


def _branch_apply(p, cfg, x, is_dense: bool):
    dt = torch_dtype(cfg.dtype)
    stack = cv.dense_stack_apply if is_dense else cv.stack_apply
    h = stack(p['cnn'], x, compute_dtype=dt)
    return activation(cfg.enc_act)(cv.linear_apply(p['lin'], h, compute_dtype=dt))


def intercnn_apply(params, cfg, x, perms, training=True, stats=None):
    """Returns (codes, stats). perms['p1'] is the forward interleaver."""
    is_dense = dense(cfg)
    x = 2.0 * x - 1.0                       # BPSK map (JAX encoders.py:71)
    x_sys = _branch_apply(params['b1'], cfg, x, is_dense)
    x_p1 = _branch_apply(params['b2'], cfg, x, is_dense)
    x_p2 = _branch_apply(params['b3'], cfg, interleave(x, perms['p1']), is_dense)
    x_tx = torch.cat([x_sys, x_p1, x_p2], dim=2)
    return power_constraint(x_tx, cfg, training, stats)


def _rnn_branch_init(gen, cfg, device, kind):
    return {'rnn': rnn.birnn_init(gen, cfg.code_rate_k, cfg.enc_num_unit, cfg.enc_num_layer,
                                  kind, device),
            'lin': cv.linear_init(gen, 2 * cfg.enc_num_unit, 1, device)}


def _rnn_branch_apply(p, cfg, x, kind):
    dt = torch_dtype(cfg.dtype)
    h = rnn.birnn_apply(p['rnn'], x, kind, compute_dtype=dt)
    return activation(cfg.enc_act)(cv.linear_apply(p['lin'], h, compute_dtype=dt))


def interrnn_init(gen: torch.Generator, cfg, device='cpu'):
    """ENC_interRNN: three branches b1, b2, b3 (JAX encoders.py:204-208)."""
    return {b: _rnn_branch_init(gen, cfg, device, cfg.enc_rnn) for b in ('b1', 'b2', 'b3')}


def interrnn_apply(params, cfg, x, perms, training=True, stats=None):
    """Raw bits into every branch, b3's interleaved (JAX :211-218)."""
    x_sys = _rnn_branch_apply(params['b1'], cfg, x, cfg.enc_rnn)
    x_p1 = _rnn_branch_apply(params['b2'], cfg, x, cfg.enc_rnn)
    x_p2 = _rnn_branch_apply(params['b3'], cfg, interleave(x, perms['p1']), cfg.enc_rnn)
    return power_constraint(torch.cat([x_sys, x_p1, x_p2], dim=2), cfg, training, stats)


def interrnn_sys_init(gen: torch.Generator, cfg, device='cpu'):
    """ENC_interRNN_sys: two parity branches b1, b2 (JAX :221-225)."""
    return {b: _rnn_branch_init(gen, cfg, device, cfg.enc_rnn) for b in ('b1', 'b2')}


def interrnn_sys_apply(params, cfg, x, perms, training=True, stats=None):
    """[2x - 1, power_constraint(parity)] (JAX :228-236)."""
    x_p1 = _rnn_branch_apply(params['b1'], cfg, x, cfg.enc_rnn)
    x_p2 = _rnn_branch_apply(params['b2'], cfg, interleave(x, perms['p1']), cfg.enc_rnn)
    x_tx, stats = power_constraint(torch.cat([x_p1, x_p2], dim=2), cfg, training, stats)
    return torch.cat([2.0 * x - 1.0, x_tx], dim=2), stats


def rate2rnn_init(gen: torch.Generator, cfg, device='cpu'):
    """ENC_turbofy_rate2: two GRU branches b1, b2 (JAX :239-247)."""
    return {b: _rnn_branch_init(gen, cfg, device, 'gru') for b in ('b1', 'b2')}


def rate2rnn_apply(params, cfg, x, perms, training=True, stats=None):
    """[b1(x), b2(interleave(x))] (JAX :250-257)."""
    x_sys = _rnn_branch_apply(params['b1'], cfg, x, 'gru')
    x_p2 = _rnn_branch_apply(params['b2'], cfg, interleave(x, perms['p1']), 'gru')
    return power_constraint(torch.cat([x_sys, x_p2], dim=2), cfg, training, stats)


ENC_REGISTRY = {
    'TurboAE_rate3_cnn': (intercnn_init, intercnn_apply),
    'TurboAE_rate3_cnn_dense': (intercnn_init, intercnn_apply),
    'Turboae_rate3_rnn': (interrnn_init, interrnn_apply),
    'TurboAE_rate3_rnn_sys': (interrnn_sys_init, interrnn_sys_apply),
    'TurboAE_rate2_rnn': (rate2rnn_init, rate2rnn_apply),
}

# the JAX registry's other keys, all of the CNN zoo's ROADMAP item M9
UNPORTED_ENCODERS = {
    'TurboAE_rate2_cnn': 'M9', 'rate3_cnn': 'M9', 'rate2_cnn': 'M9', 'turboae_2int': 'M9',
    'TurboAE_rate3_cnn2d': 'M9', 'TurboAE_rate3_cnn2d_dense': 'M9', 'rate3_cnn2d': 'M9',
}


def make_encoder(cfg):
    """(init, apply) of cfg.encoder (JAX encoders.py:364-376)."""
    if cfg.encoder in ('Turbo_rate3_757', 'Turbo_rate3_lte'):
        from .deepturbo import turbo_enc_apply, turbo_enc_init
        return turbo_enc_init, turbo_enc_apply
    if cfg.encoder in UNPORTED_ENCODERS:
        raise NotImplementedError(f'encoder {cfg.encoder!r} is not ported yet '
                                  f'(ROADMAP {UNPORTED_ENCODERS[cfg.encoder]})')
    if cfg.encoder not in ENC_REGISTRY:
        raise ValueError(f'unknown encoder {cfg.encoder}')
    return ENC_REGISTRY[cfg.encoder]
