"""The decoders and their registry (JAX: models/decoders.py): the
iterative DEC_LargeCNN, DEC_LargeCNN2Int, DEC_LargeCNN_rate2, DEC_LargeRNN,
DEC_LargeRNN_rate2, NeuralTurbofyDec and the 2D DEC_LargeCNN2D, and the
single-pass CNN_decoder_rate3 and DEC_CNN2D.

Its conv flavour is keyed off the ENCODER's name, as in the reference
(encoders.dense): plain stacks only for encoder 'TurboAE_rate3_cnn', dense
stacks (ops/conv1d.py) for every other encoder, DeepTurbo's included.

The JAX package stacks the first num_iteration-1 iterations' weights for a
lax.scan and peels the last one. Here every iteration has its own entry:
params = {'iters': [it_0, ..., it_{n-1}]}, each
{'dec1_cnn', 'dec2_cnn': [conv layers], 'dec1_lin', 'dec2_lin': heads}; the
last iteration's dec2 head emits one channel. The iterations run as a Python
loop.

With cfg.use_fused_conv every plain conv stack goes through the
hand-written bf16 kernel K2 (kernels/conv_stack.py), its output cast back
to cfg.dtype, as JAX decoders.py:99-104 routes them through the Pallas
kernel. Dense stacks, which JAX leaves to XLA, go under the same flag in
bf16 through the hand-written dense kernel K3 (one launch a stack), which
raises on the card where it cannot hold a stack; f32 dense stacks never
fuse.

DEC_LargeCNN2Int ('TurboAE_rate3_cnn_2inter', 'turboae_2int') and
DEC_LargeCNN_rate2 ('TurboAE_rate2_cnn') have DEC_LargeCNN's params but
always plain, never fused stacks, as in JAX (decoders.py:248-352).

The 2D decoders view the received block as a (cfg.img_size, cfg.img_size)
image and permute its pixels in the flattened row-major order of
ops/interleave.interleave_2d. Their conv flavour is keyed off the encoder's
name too: dense only for 'TurboAE_rate3_cnn2d_dense' (encoders.dense2d).
DEC_LargeCNN2D's iterations hold 'dec1_cnn', 'dec2_cnn' (2D stacks) and
'dec1_out', 'dec2_out' (one-layer 1x1 stacks that keep their ELU, except
the last iteration's dec2_out); DEC_CNN2D is {'dec', 'out'}.

The RNN decoders' iterations hold 'dec1_rnn' and 'dec2_rnn' (biRNN stacks,
ops/gru.py) in place of the conv stacks, with heads from 2 * dec_num_unit.
nbcjr_rate3 shares one biGRU and head over every iteration:
{'rnn', 'out', 'final'}.

Under a mesh that shards time (dist/mesh.py) every 1D conv stack runs over
this rank's halo window (`_halo`: the stack's input gathered along time, a
window of its receptive field beyond this rank's positions, the kept rows
cropped), fused stacks included; the interleavers gather their narrow
inputs (ops/interleave.py); the biRNNs (ops/gru.py) and the 2D decoders run
on the whole block (`whole_time`).

Every apply takes `training` and a `generator`. Only DEC_LargeRNN reads
them: in training with cfg.dropout > 0 it drops units after the first
layer of each biRNN and on each head before dec_act, with masks drawn from
the generator in the order the half-iterations run (each half: the RNN's
mask, then the head's). As in the reference, the last iteration's dec2 RNN
has no inter-layer dropout; its head has.
"""
from __future__ import annotations

import torch

from ..dist import mesh as dm
from ..kernels.conv_stack import fused_dense_stack_apply_bf16, fused_stack_apply_bf16
from ..ops import conv1d as cv
from ..ops import gru as rnn
from ..ops.activations import activation
from ..ops.interleave import deinterleave, interleave
from ..utils.device import torch_dtype
from ..utils.logging import span
from .encoders import dense, dense2d


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


def _halo(stackf):
    """stackf(layers, x) over this rank's halo window under a time-sharded
    mesh (dist/mesh.py:halo_apply); stackf itself otherwise."""
    return lambda layers, x: dm.halo_apply(lambda t: stackf(layers, t), x, cv.halo(layers))


def largecnn_apply(params, cfg, received, perms, training=False, generator=None) -> torch.Tensor:
    """received (B, L, 3) -> (B, L, 1) sigmoid bit estimates.

    perms holds 'p1' and its inverse 'p1_inv' as int64 tensors."""
    dt = torch_dtype(cfg.dtype)
    if dense(cfg):
        fused = (fused_dense_stack_apply_bf16 if cfg.use_fused_conv and dt == torch.bfloat16
                 else None)

        def stackf(layers, x):
            return cv.dense_stack_apply(layers, x, compute_dtype=dt, fused=fused)
    elif cfg.use_fused_conv:
        def stackf(layers, x):
            return fused_stack_apply_bf16(layers, x).to(dt)
    else:
        def stackf(layers, x):
            return cv.stack_apply(layers, x, compute_dtype=dt)
    return _cnn_iterations(params, cfg, _halo(stackf), received[:, :, 0:1], received[:, :, 1:2],
                           received[:, :, 2:3], perms)


def _cnn_iterations(params, cfg, stackf, r_sys, r_par1, r_par2, perms) -> torch.Tensor:
    """DEC_LargeCNN's iterations: dec1 reads [r_sys, r_par1, prior], dec2
    [r_sys interleaved by p1, r_par2, dec1's extrinsic interleaved]. Each
    iteration, the last included, is a span `decode.iter`."""
    dt = torch_dtype(cfg.dtype)
    p, inv = perms['p1'], perms['p1_inv']
    r_sys_int = interleave(r_sys, p)
    b, l, _ = r_sys.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32, device=r_sys.device)

    def half_iter(w_cnn, w_lin, inputs, sub):
        # raw linear head: CNN decoders apply no dec_act
        x_plr = cv.linear_apply(w_lin, stackf(w_cnn, inputs), compute_dtype=dt)
        return x_plr - sub if cfg.extrinsic else x_plr

    *iters, final = params['iters']
    for w in iters:
        with span('decode.iter'):
            x_plr = half_iter(w['dec1_cnn'], w['dec1_lin'],
                              torch.cat([r_sys, r_par1, prior], dim=2), prior)
            x_plr_int = interleave(x_plr, p)
            x_plr2 = half_iter(w['dec2_cnn'], w['dec2_lin'],
                               torch.cat([r_sys_int, r_par2, x_plr_int], dim=2),
                               x_plr_int)
            prior = deinterleave(x_plr2, inv)

    # final iteration: dec2's head emits one channel, no extrinsic subtraction
    with span('decode.iter'):
        x_plr = half_iter(final['dec1_cnn'], final['dec1_lin'],
                          torch.cat([r_sys, r_par1, prior], dim=2), prior)
        x_plr_int = interleave(x_plr, p)
        h = stackf(final['dec2_cnn'], torch.cat([r_sys_int, r_par2, x_plr_int], dim=2))
        logit = cv.linear_apply(final['dec2_lin'], h, compute_dtype=dt)
        return torch.sigmoid(deinterleave(logit, inv))


def _rnn_iters_init(gen, cfg, device, n_in: int, kind: str):
    """Per iteration two 2-layer biRNNs n_in -> 2 * dec_num_unit and two
    heads to num_iter_ft, the last iteration's dec2 head to 1 (JAX
    decoders.py:155-173, 357-372)."""
    U, iters = cfg.dec_num_unit, []
    for i in range(cfg.num_iteration):
        last = i == cfg.num_iteration - 1
        iters.append({
            'dec1_rnn': rnn.birnn_init(gen, n_in, U, 2, kind, device),
            'dec2_rnn': rnn.birnn_init(gen, n_in, U, 2, kind, device),
            'dec1_lin': cv.linear_init(gen, 2 * U, cfg.num_iter_ft, device),
            'dec2_lin': cv.linear_init(gen, 2 * U, 1 if last else cfg.num_iter_ft, device),
        })
    return {'iters': iters}


def largernn_init(gen: torch.Generator, cfg, device='cpu'):
    """DEC_LargeRNN (JAX decoders.py:155-173): biRNNs of kind cfg.dec_rnn."""
    return _rnn_iters_init(gen, cfg, device, 2 + cfg.num_iter_ft, cfg.dec_rnn)


def largernn_apply(params, cfg, received, perms, training=False, generator=None):
    """DEC_LargeRNN (JAX decoders.py:176-241): dec_act on every head. Each
    iteration, the last included, is a span `decode.iter`."""
    dt = torch_dtype(cfg.dtype)
    act = activation(cfg.dec_act)
    p, inv = perms['p1'], perms['p1_inv']
    drop = cfg.dropout if training and cfg.dropout > 0 and generator is not None else 0.0

    def head(w_lin, h):
        # the reference's dec_act(dropout(linear(...))) (decoders.py:103)
        x = cv.linear_apply(w_lin, h, compute_dtype=dt)
        return act(rnn.dropout(x, drop, generator) if drop else x)

    def half_iter(w_rnn, w_lin, inputs, sub):
        h = rnn.birnn_apply(w_rnn, inputs, cfg.dec_rnn, compute_dtype=dt, dropout=drop,
                            generator=generator)
        x_plr = head(w_lin, h)
        return x_plr - sub if cfg.extrinsic else x_plr

    r_sys, r_par1, r_par2 = received[:, :, 0:1], received[:, :, 1:2], received[:, :, 2:3]
    r_sys_int = interleave(r_sys, p)
    b, l, _ = received.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32, device=received.device)
    *iters, final = params['iters']
    for w in iters:
        with span('decode.iter'):
            x_plr = half_iter(w['dec1_rnn'], w['dec1_lin'],
                              torch.cat([r_sys, r_par1, prior], dim=2), prior)
            x_plr_int = interleave(x_plr, p)
            x_plr2 = half_iter(w['dec2_rnn'], w['dec2_lin'],
                               torch.cat([r_sys_int, r_par2, x_plr_int], dim=2), x_plr_int)
            prior = deinterleave(x_plr2, inv)
    with span('decode.iter'):
        x_plr = half_iter(final['dec1_rnn'], final['dec1_lin'],
                          torch.cat([r_sys, r_par1, prior], dim=2), prior)
        x_plr_int = interleave(x_plr, p)
        # the final dec2 RNN runs without inter-layer dropout (JAX :235-240)
        h = rnn.birnn_apply(final['dec2_rnn'], torch.cat([r_sys_int, r_par2, x_plr_int], dim=2),
                            cfg.dec_rnn, compute_dtype=dt)
        return torch.sigmoid(deinterleave(head(final['dec2_lin'], h), inv))


def largernn_rate2_init(gen: torch.Generator, cfg, device='cpu'):
    """DEC_LargeRNN_rate2 (JAX decoders.py:354-372): GRUs of 1 + num_iter_ft
    inputs."""
    return _rnn_iters_init(gen, cfg, device, 1 + cfg.num_iter_ft, 'gru')


def largernn_rate2_apply(params, cfg, received, perms, training=False, generator=None):
    """DEC_LargeRNN_rate2 (JAX decoders.py:375-417): raw linear heads, no
    dec_act; received is (B, L, 2) [sys, interleaved parity]."""
    dt = torch_dtype(cfg.dtype)
    p, inv = perms['p1'], perms['p1_inv']

    def half(w_rnn, w_lin, inputs, sub):
        h = rnn.bigru_apply(w_rnn, inputs, compute_dtype=dt)
        x = cv.linear_apply(w_lin, h, compute_dtype=dt)
        return x - sub if cfg.extrinsic else x

    r_sys, r_int = received[:, :, 0:1], received[:, :, 1:2]
    b, l, _ = received.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32, device=received.device)
    *iters, final = params['iters']
    for w in iters:
        x_plr = half(w['dec1_rnn'], w['dec1_lin'], torch.cat([r_sys, prior], dim=2), prior)
        x_int = interleave(x_plr, p)
        x_plr2 = half(w['dec2_rnn'], w['dec2_lin'], torch.cat([r_int, x_int], dim=2), x_int)
        prior = deinterleave(x_plr2, inv)
    x_plr = half(final['dec1_rnn'], final['dec1_lin'], torch.cat([r_sys, prior], dim=2), prior)
    x_int = interleave(x_plr, p)
    h = rnn.bigru_apply(final['dec2_rnn'], torch.cat([r_int, x_int], dim=2), compute_dtype=dt)
    logit = cv.linear_apply(final['dec2_lin'], h, compute_dtype=dt)
    return torch.sigmoid(deinterleave(logit, inv))


def nbcjr_init(gen: torch.Generator, cfg, device='cpu'):
    """NeuralTurbofyDec (JAX decoders.py:437-442): one 2-layer biGRU of
    code_rate_n + num_iter_ft - 1 inputs, its head and a final linear."""
    U = cfg.dec_num_unit
    return {'rnn': rnn.bigru_init(gen, cfg.code_rate_n + cfg.num_iter_ft - 1, U, 2, device),
            'out': cv.linear_init(gen, 2 * U, cfg.num_iter_ft, device),
            'final': cv.linear_init(gen, cfg.num_iter_ft, 1, device)}


def nbcjr_apply(params, cfg, received, perms, training=False, generator=None):
    """NeuralTurbofyDec (JAX decoders.py:445-481): the same weights every
    iteration; the prior is subtracted when NOT cfg.extrinsic, the
    reference's inversion (decoders.py:825)."""
    dt = torch_dtype(cfg.dtype)
    p, inv = perms['p1'], perms['p1_inv']

    def half(inputs, sub):
        h = rnn.bigru_apply(params['rnn'], inputs, compute_dtype=dt)
        x = cv.linear_apply(params['out'], h, compute_dtype=dt)
        return x - sub if not cfg.extrinsic else x

    r_sys, r_par1, r_par2 = received[:, :, 0:1], received[:, :, 1:2], received[:, :, 2:3]
    r_sys_int = interleave(r_sys, p)
    b, l, _ = received.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32, device=received.device)
    for _ in range(cfg.num_iteration - 1):
        x_plr = half(torch.cat([r_sys, r_par1, prior], dim=2), prior)
        x_int = interleave(x_plr, p)
        prior = deinterleave(half(torch.cat([r_sys_int, r_par2, x_int], dim=2), x_int), inv)
    x_plr = half(torch.cat([r_sys, r_par1, prior], dim=2), prior)
    x_int = interleave(x_plr, p)
    h = rnn.bigru_apply(params['rnn'], torch.cat([r_sys_int, r_par2, x_int], dim=2),
                        compute_dtype=dt)
    x_dec = cv.linear_apply(params['out'], h, compute_dtype=dt)
    x_final = torch.sigmoid(cv.linear_apply(params['final'], x_dec, compute_dtype=dt))
    return deinterleave(x_final, inv)


def plain_cnn_init(gen: torch.Generator, cfg, device='cpu'):
    """DEC_LargeCNN's params over plain stacks, whatever the encoder (JAX
    decoders.py:248-251, 305-308)."""
    return largecnn_init(gen, cfg.replace(encoder='TurboAE_rate3_cnn'), device)


def _plain_stack(cfg):
    dt = torch_dtype(cfg.dtype)
    return _halo(lambda layers, x: cv.stack_apply(layers, x, compute_dtype=dt))


def largecnn2int_apply(params, cfg, received, perms, training=False, generator=None):
    """DEC_LargeCNN2Int (JAX decoders.py:254-298): each iteration interleaves
    the prior by p1, goes from dec1 to dec2 by inv1 then p2, and ends by
    inv2."""
    dt = torch_dtype(cfg.dtype)
    stackf = _plain_stack(cfg)
    p1, inv1, p2, inv2 = perms['p1'], perms['p1_inv'], perms['p2'], perms['p2_inv']
    r_sys, r_par1, r_par2 = received[:, :, 0:1], received[:, :, 1:2], received[:, :, 2:3]
    r_sys_int1, r_sys_int2 = interleave(r_sys, p1), interleave(r_sys, p2)
    b, l, _ = received.shape
    prior = torch.zeros((b, l, cfg.num_iter_ft), dtype=torch.float32, device=received.device)

    def half(w_cnn, w_lin, inputs, sub):
        x = cv.linear_apply(w_lin, stackf(w_cnn, inputs), compute_dtype=dt)
        return x - sub if cfg.extrinsic else x

    def dec1(w, prior):
        prior_i = interleave(prior, p1)
        x_plr = half(w['dec1_cnn'], w['dec1_lin'], torch.cat([r_sys_int1, r_par1, prior_i], dim=2),
                     prior_i)
        return interleave(deinterleave(x_plr, inv1), p2)

    *iters, final = params['iters']
    for w in iters:
        x_int = dec1(w, prior)
        x_plr2 = half(w['dec2_cnn'], w['dec2_lin'], torch.cat([r_sys_int2, r_par2, x_int], dim=2),
                      x_int)
        prior = deinterleave(x_plr2, inv2)
    x_int = dec1(final, prior)
    h = stackf(final['dec2_cnn'], torch.cat([r_sys_int2, r_par2, x_int], dim=2))
    logit = cv.linear_apply(final['dec2_lin'], h, compute_dtype=dt)
    return torch.sigmoid(deinterleave(logit, inv2))


def largecnn_rate2_apply(params, cfg, received, perms, training=False, generator=None):
    """DEC_LargeCNN_rate2 (JAX decoders.py:311-351): DEC_LargeCNN's
    iterations over plain stacks on received (B, L, 2) [sys, parity of the
    interleaved bits]: dec1 reads the de-interleaved parity, dec2 the
    parity as it is."""
    r_par = received[:, :, 1:2]
    return _cnn_iterations(params, cfg, _plain_stack(cfg), received[:, :, 0:1],
                           deinterleave(r_par, perms['p1_inv']), r_par, perms)


def cnn_rate3_init(gen: torch.Generator, cfg, device='cpu'):
    """CNN_decoder_rate3 (JAX decoders.py:420-424): one stack code_rate_n ->
    dec_num_unit and a head to 1."""
    return {'cnn': cv.stack_init(gen, cfg.dec_num_layer, cfg.code_rate_n, cfg.dec_num_unit,
                                 cfg.dec_kernel_size, device),
            'lin': cv.linear_init(gen, cfg.dec_num_unit, 1, device)}


def cnn_rate3_apply(params, cfg, received, perms, training=False, generator=None):
    """sigmoid(head(stack(received))) (JAX decoders.py:427-430)."""
    dt = torch_dtype(cfg.dtype)
    h = _plain_stack(cfg)(params['cnn'], received)
    return torch.sigmoid(cv.linear_apply(params['lin'], h, compute_dtype=dt))


def _stack2d(cfg):
    return (cv.dense_stack2d_init, cv.dense_stack2d_apply) if dense2d(cfg) else \
        (cv.stack2d_init, cv.stack2d_apply)


def largecnn2d_init(gen: torch.Generator, cfg, device='cpu'):
    """DEC_LargeCNN2D (JAX decoders.py:488-508): per iteration two 2D stacks
    (2 + num_iter_ft) -> dec_num_unit and two one-layer 1x1 stacks to
    num_iter_ft, the last iteration's dec2_out to 1."""
    init, _ = _stack2d(cfg)
    n_in, U, ft = 2 + cfg.num_iter_ft, cfg.dec_num_unit, cfg.num_iter_ft
    iters = []
    for i in range(cfg.num_iteration):
        last = i == cfg.num_iteration - 1
        iters.append({
            'dec1_cnn': init(gen, cfg.dec_num_layer, n_in, U, cfg.dec_kernel_size, device),
            'dec2_cnn': init(gen, cfg.dec_num_layer, n_in, U, cfg.dec_kernel_size, device),
            'dec1_out': init(gen, 1, U, ft, 1, device),
            'dec2_out': init(gen, 1, U, 1 if last else ft, 1, device),
        })
    return {'iters': iters}


def largecnn2d_apply(params, cfg, received, perms, training=False, generator=None):
    """DEC_LargeCNN2D (JAX decoders.py:511-560): received (B, L, 3) as a
    (B, S, S, 3) image -> (B, L, code_rate_k)."""
    return dm.whole_time(lambda full: _largecnn2d(params, cfg, full, perms), received)


def _largecnn2d(params, cfg, received, perms):
    dt = torch_dtype(cfg.dtype)
    _, stack = _stack2d(cfg)
    s, b = cfg.img_size, received.shape[0]
    p, inv = perms['p1'], perms['p1_inv']

    def pix_perm(x, idx):
        c = x.shape[-1]
        return interleave(x.reshape(b, s * s, c), idx).reshape(b, s, s, c)

    def half(w_cnn, w_out, inputs, sub):
        # the per-iteration heads keep their ELU (JAX :532-534)
        x = stack(w_out, stack(w_cnn, inputs, compute_dtype=dt), compute_dtype=dt)
        return x - sub if cfg.extrinsic else x

    img = received.reshape(b, s, s, cfg.code_rate_n)
    r_sys, r_par1, r_par2 = img[..., 0:1], img[..., 1:2], img[..., 2:3]
    r_sys_int = pix_perm(r_sys, p)
    prior = torch.zeros((b, s, s, cfg.num_iter_ft), dtype=torch.float32, device=received.device)
    *iters, final = params['iters']
    for w in iters:
        x_plr = half(w['dec1_cnn'], w['dec1_out'], torch.cat([r_sys, r_par1, prior], dim=3), prior)
        x_int = pix_perm(x_plr, p)
        x_plr2 = half(w['dec2_cnn'], w['dec2_out'], torch.cat([r_sys_int, r_par2, x_int], dim=3),
                      x_int)
        prior = pix_perm(x_plr2, inv)
    x_plr = half(final['dec1_cnn'], final['dec1_out'], torch.cat([r_sys, r_par1, prior], dim=3),
                 prior)
    x_int = pix_perm(x_plr, p)
    h = stack(final['dec2_cnn'], torch.cat([r_sys_int, r_par2, x_int], dim=3), compute_dtype=dt)
    logit = stack(final['dec2_out'], h, no_act=True, compute_dtype=dt)
    return torch.sigmoid(pix_perm(logit, inv)).reshape(b, cfg.block_len, cfg.code_rate_k)


def cnn2d_init(gen: torch.Generator, cfg, device='cpu'):
    """DEC_CNN2D (JAX decoders.py:563-570): a 2D stack code_rate_n ->
    dec_num_unit and a one-layer 1x1 stack to 1."""
    init, _ = _stack2d(cfg)
    return {'dec': init(gen, cfg.dec_num_layer, cfg.code_rate_n, cfg.dec_num_unit,
                        cfg.dec_kernel_size, device),
            'out': init(gen, 1, cfg.dec_num_unit, 1, 1, device)}


def cnn2d_apply(params, cfg, received, perms, training=False, generator=None):
    """sigmoid(ELU(out(dec(image)))): the out stack applies its ELU before the
    sigmoid (JAX decoders.py:573-582)."""
    return dm.whole_time(lambda full: _cnn2d(params, cfg, full), received)


def _cnn2d(params, cfg, received):
    dt = torch_dtype(cfg.dtype)
    _, stack = _stack2d(cfg)
    s, b = cfg.img_size, received.shape[0]
    h = stack(params['dec'], received.reshape(b, s, s, cfg.code_rate_n), compute_dtype=dt)
    x = stack(params['out'], h, compute_dtype=dt)
    return torch.sigmoid(x).reshape(b, cfg.block_len, cfg.code_rate_k)


DEC_REGISTRY = {
    'TurboAE_rate3_cnn': (largecnn_init, largecnn_apply),
    'TurboAE_rate3_cnn_dense': (largecnn_init, largecnn_apply),
    'TurboAE_rate3_rnn': (largernn_init, largernn_apply),
    'TurboAE_rate3_cnn_2inter': (plain_cnn_init, largecnn2int_apply),
    'TurboAE_rate2_rnn': (largernn_rate2_init, largernn_rate2_apply),
    'TurboAE_rate2_cnn': (plain_cnn_init, largecnn_rate2_apply),
    'nbcjr_rate3': (nbcjr_init, nbcjr_apply),
    'rate3_cnn': (cnn_rate3_init, cnn_rate3_apply),
    'TurboAE_rate3_cnn2d': (largecnn2d_init, largecnn2d_apply),
    'TurboAE_rate3_cnn2d_dense': (largecnn2d_init, largecnn2d_apply),
    'rate3_cnn2d': (cnn2d_init, cnn2d_apply),
    'turboae_2int': (plain_cnn_init, largecnn2int_apply),
}


def make_decoder(cfg):
    """(init, apply) of cfg.decoder (JAX decoders.py:605-608)."""
    if cfg.decoder not in DEC_REGISTRY:
        raise ValueError(f'unknown decoder {cfg.decoder}')
    return DEC_REGISTRY[cfg.decoder]
