"""The iterative decoder DEC_LargeCNN and its registry
(JAX: models/decoders.py:52-148,589-602).

Its conv flavour is keyed off the ENCODER's name, as in the reference
(encoders.dense): plain stacks only for encoder 'TurboAE_rate3_cnn', dense
stacks (ops/conv1d.py) for every other encoder, DeepTurbo's included.

The JAX package stacks the first num_iteration-1 iterations' weights for a
lax.scan and peels the last one. Here every iteration has its own entry:
params = {'iters': [it_0, ..., it_{n-1}]}, each
{'dec1_cnn', 'dec2_cnn': [conv layers], 'dec1_lin', 'dec2_lin': heads}; the
last iteration's dec2 head emits one channel. The iterations run as a Python
loop.

With cfg.use_fused_conv every conv stack goes through the hand-written bf16
kernel (kernels/conv_stack.py), its output cast back to cfg.dtype, as
JAX decoders.py:99-104 routes them through the Pallas kernel.
"""
from __future__ import annotations

import torch

from ..kernels.conv_stack import fused_stack_apply_bf16
from ..ops import conv1d as cv
from ..ops.interleave import deinterleave, interleave
from ..utils.device import torch_dtype
from .encoders import dense


def largecnn_init(gen: torch.Generator, cfg, device='cpu'):
    """{'iters': [...]}, one entry per iteration (JAX decoders.py:54-93):
    two stacks (2 + num_iter_ft) -> dec_num_unit and two heads to
    num_iter_ft, except the last iteration's dec2 head, which emits 1."""
    n_in = 2 + cfg.num_iter_ft
    U, nl, K = cfg.dec_num_unit, cfg.dec_num_layer, cfg.dec_kernel_size
    stack_init = cv.dense_stack_init if dense(cfg) else cv.stack_init
    iters = []
    for i in range(cfg.num_iteration):
        last = i == cfg.num_iteration - 1
        iters.append({
            'dec1_cnn': stack_init(gen, nl, n_in, U, K, device),
            'dec2_cnn': stack_init(gen, nl, n_in, U, K, device),
            'dec1_lin': cv.linear_init(gen, U, cfg.num_iter_ft, device),
            'dec2_lin': cv.linear_init(gen, U, 1 if last else cfg.num_iter_ft, device),
        })
    return {'iters': iters}


def largecnn_apply(params, cfg, received, perms) -> torch.Tensor:
    """received (B, L, 3) -> (B, L, 1) sigmoid bit estimates.

    perms holds 'p1' and its inverse 'p1_inv' as int64 tensors."""
    dt = torch_dtype(cfg.dtype)
    if dense(cfg):
        def stackf(layers, x):
            return cv.dense_stack_apply(layers, x, compute_dtype=dt)
    elif cfg.use_fused_conv:
        def stackf(layers, x):
            return fused_stack_apply_bf16(layers, x).to(dt)
    else:
        def stackf(layers, x):
            return cv.stack_apply(layers, x, compute_dtype=dt)
    p, inv = perms['p1'], perms['p1_inv']

    r_sys = received[:, :, 0:1]
    r_par1 = received[:, :, 1:2]
    r_par2 = received[:, :, 2:3]
    r_sys_int = interleave(r_sys, p)
    b, l, _ = received.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32,
                        device=received.device)

    def half_iter(w_cnn, w_lin, inputs, sub):
        # raw linear head: CNN decoders apply no dec_act
        x_plr = cv.linear_apply(w_lin, stackf(w_cnn, inputs), compute_dtype=dt)
        return x_plr - sub if cfg.extrinsic else x_plr

    *iters, final = params['iters']
    for w in iters:
        x_plr = half_iter(w['dec1_cnn'], w['dec1_lin'],
                          torch.cat([r_sys, r_par1, prior], dim=2), prior)
        x_plr_int = interleave(x_plr, p)
        x_plr2 = half_iter(w['dec2_cnn'], w['dec2_lin'],
                           torch.cat([r_sys_int, r_par2, x_plr_int], dim=2),
                           x_plr_int)
        prior = deinterleave(x_plr2, inv)

    # final iteration: dec2's head emits one channel, no extrinsic subtraction
    x_plr = half_iter(final['dec1_cnn'], final['dec1_lin'],
                      torch.cat([r_sys, r_par1, prior], dim=2), prior)
    x_plr_int = interleave(x_plr, p)
    h = stackf(final['dec2_cnn'], torch.cat([r_sys_int, r_par2, x_plr_int], dim=2))
    logit = cv.linear_apply(final['dec2_lin'], h, compute_dtype=dt)
    return torch.sigmoid(deinterleave(logit, inv))


DEC_REGISTRY = {
    'TurboAE_rate3_cnn': (largecnn_init, largecnn_apply),
    'TurboAE_rate3_cnn_dense': (largecnn_init, largecnn_apply),
}

# the JAX registry's other keys, by the ROADMAP item that ports them
UNPORTED_DECODERS = {
    'TurboAE_rate3_rnn': 'M10', 'TurboAE_rate2_rnn': 'M10', 'nbcjr_rate3': 'M10',
    'TurboAE_rate3_cnn_2inter': 'M9', 'TurboAE_rate2_cnn': 'M9', 'rate3_cnn': 'M9',
    'TurboAE_rate3_cnn2d': 'M9', 'TurboAE_rate3_cnn2d_dense': 'M9', 'rate3_cnn2d': 'M9',
    'turboae_2int': 'M9',
}


def make_decoder(cfg):
    """(init, apply) of cfg.decoder (JAX decoders.py:605-608)."""
    if cfg.decoder in UNPORTED_DECODERS:
        raise NotImplementedError(f'decoder {cfg.decoder!r} is not ported yet '
                                  f'(ROADMAP {UNPORTED_DECODERS[cfg.decoder]})')
    if cfg.decoder not in DEC_REGISTRY:
        raise ValueError(f'unknown decoder {cfg.decoder}')
    return DEC_REGISTRY[cfg.decoder]
