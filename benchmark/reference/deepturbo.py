"""DeepTurbo, rate 1/3: the classical RSC (7, 5) turbo encoder and a learned
iterative CNN decoder of dense stacks (Jiang, Kim, Asnani, Kannan, Oh and
Viswanath, "DeepTurbo: Deep Turbo Decoder", arXiv:1903.02295;
yihanjiang/turboae `encoders.py` ENC_TurboCode (:758-801), `decoders.py`
DEC_LargeCNN with DenseSameShapeConv1d, which that repository picks for
every encoder but TurboAE_rate3_cnn (:172-176)), in plain PyTorch.

The architecture, as the reference repository defines it:
  - encoder: no parameters. Bits u_t in {0, 1}; one recursive systematic
    convolutional code of memory 2, feedback polynomial 7 (1 + D + D^2) and
    feed-forward 5 (1 + D^2), from state 0:
        a_t = u_t xor a_{t-1} xor a_{t-2},    parity_t = a_t xor a_{t-2};
    the code is [u, parity(u), parity(u permuted by p1)], each bit c sent as
    2c - 1, with no power constraint;
  - channel: AWGN, received = code + noise;
  - decoder: num_iteration iterations of two half-decoders, each a dense
    stack of dec_num_layer Conv1d layers (kernel dec_kernel_size, ELU after
    each; layer i reads the running concatenation [x, out_0, ..., out_{i-1}]
    of 2 + num_iter_ft + i * dec_num_unit channels) and a Linear head with
    no activation. dec1 reads [r_sys, r_par1, prior], dec2 [r_sys permuted
    by p1, r_par2, dec1's extrinsic permuted by p1]; each subtracts its
    prior (extrinsic information); dec2's output, permuted back by p1's
    inverse, is the next prior. The last iteration's dec2 head emits one
    channel, with no subtraction; the output is sigmoid of it permuted back.

Departures, as the measured program has them too:
  - the termination tail is dropped: a terminated turbo code drives the
    first encoder back to state 0 with M = 2 tail bits and sends them. The
    reference repository's turbo_encode (commpy's interleaver semantics)
    permutes the first L entries of the length-(L + M) systematic stream by
    the length-L interleaver, which is the message permuted by p1, and keeps
    the first L positions of each stream; the second encoder is not
    terminated either;
  - the decisions are torch.round of the output (0.5 rounds to 0).

Tensors are channels last, (B, L, C). Params are nested dicts in PyTorch's
layout, the program's own: a conv layer {'w': (Cout, Cin, K), 'b': (Cout,)},
a head {'w': (out, in), 'b': (out,)}; the encoder {} and the decoder
{'iters': [{'dec1_cnn', 'dec2_cnn': [layers], 'dec1_lin', 'dec2_lin'}, ...]}.

The interface of every reference module (`turboae_cnn.py` says what each
function takes): `load`, `perms`, `encode`, `decode`, `forward_flops`.
`precision` is 'f32' or 'fp8' (the control: every conv and head operand
rounded to float8 e4m3 with a per-tensor scale, the products summed in
f32). Set TF32 off before calling: `common.no_tf32()`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import perms, quantizer
from .msgpack import load as read_msgpack
from .turboae_cnn import _conv, _get, _lin

__all__ = ['load', 'perms', 'encode', 'decode', 'forward_flops']


# -------------------------------------------------------------- checkpoint
# A flax checkpoint's params (the JAX layout): the encoder {}, a conv layer
# {'w': (K, Cin, Cout), 'b'}, a head {'w': (in, out), 'b'}, lists as dicts
# keyed '0', '1', ... (or as lists), and the decoder's iterations as
# {'scan': <the first n - 1 iterations stacked on a leading axis>, 'final':
# <the last>}.
def _tensor(a, shape, where: str, device) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.ndim == 3:            # conv (K, Cin, Cout) -> (Cout, Cin, K)
        a = a.transpose(2, 1, 0)
    elif a.ndim == 2:          # head (in, out) -> (out, in)
        a = a.T
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f'{where}: shape {tuple(a.shape)}, expected {tuple(shape)}')
    return torch.tensor(np.ascontiguousarray(a), device=device)


def load(path: str, arch: dict, device) -> dict:
    """The reference tree of the checkpoint's 'params', f32 on `device`:
    2 * num_iteration dense stacks, layer i's weight (D, 2 + num_iter_ft +
    i * D, K), and their heads."""
    params = read_msgpack(path)['params']
    if params.get('enc'):
        raise ValueError(f'{path}: DeepTurbo\'s encoder has no parameters')
    D, K, nl = arch['dec_num_unit'], arch['dec_kernel_size'], arch['dec_num_layer']
    ft, n_iter = arch['num_iter_ft'], arch['num_iteration']
    n_in = 2 + ft
    iters = []
    for it in range(n_iter):
        last = it == n_iter - 1
        src = params['dec']['final' if last else 'scan']

        def leaf(node, shape, where):
            return _tensor(node if last else np.asarray(node)[it], shape, f'{where} of {it}',
                           device)
        w = {}
        for s in ('dec1_cnn', 'dec2_cnn'):
            w[s] = [{'w': leaf(_get(src[s], i)['w'], (D, n_in + i * D, K), f'{s}[{i}].w'),
                     'b': leaf(_get(src[s], i)['b'], (D,), f'{s}[{i}].b')} for i in range(nl)]
        for s, out in (('dec1_lin', ft), ('dec2_lin', 1 if last else ft)):
            w[s] = {'w': leaf(src[s]['w'], (out, D), f'{s}.w'),
                    'b': leaf(src[s]['b'], (out,), f'{s}.b')}
        iters.append(w)
    return {'enc': {}, 'dec': {'iters': iters}}


# ----------------------------------------------------------------- encoder
def _rsc_parity(u: torch.Tensor) -> torch.Tensor:
    """(B, L) int64 bits -> (B, L) parity of the RSC (7, 5) code from state
    0, position by position, every row at once."""
    a1 = a2 = torch.zeros_like(u[:, 0])
    out = []
    for t in range(u.shape[1]):
        a = u[:, t] ^ a1 ^ a2
        out.append(a ^ a2)
        a1, a2 = a, a1
    return torch.stack(out, dim=1)


def encode(params, bits: torch.Tensor, pm, arch: dict, precision: str = 'f32'
           ) -> torch.Tensor:
    """(B, L, 1) bits -> (B, L, 3) f32 code [sys, par1, par2] in {-1, 1};
    exact, so `precision` rounds nothing here."""
    u = bits[:, :, 0].to(torch.int64)
    code = torch.stack([u, _rsc_parity(u), _rsc_parity(u[:, pm['p1']])], dim=2)
    return 2.0 * code.to(torch.float32) - 1.0


# ----------------------------------------------------------------- decoder
def _dense(layers, x, q):
    inp = x
    out = F.elu(_conv(layers[0], inp, q))
    for p in layers[1:]:
        inp = torch.cat([inp, out], dim=2)
        out = F.elu(_conv(p, inp, q))
    return out


def decode(params, received: torch.Tensor, pm, arch: dict, precision: str = 'f32'
           ) -> torch.Tensor:
    """(B, L, 3) received -> (B, L, 1) bit estimates in (0, 1)."""
    q = quantizer(precision)
    p, inv = pm['p1'], pm['p1_inv']
    r_sys, r_par1, r_par2 = received[:, :, 0:1], received[:, :, 1:2], received[:, :, 2:3]
    r_sys_int = r_sys[:, p]
    b, l, _ = received.shape
    prior = torch.zeros((b, l, arch['num_iter_ft']), dtype=received.dtype,
                        device=received.device)

    def half(w, s, x, sub=None):
        out = _lin(w[f'{s}_lin'], _dense(w[f'{s}_cnn'], x, q), q)
        return out if sub is None else out - sub

    *iters, final = params['dec']['iters']
    for w in iters:
        x1_int = half(w, 'dec1', torch.cat([r_sys, r_par1, prior], 2), prior)[:, p]
        prior = half(w, 'dec2', torch.cat([r_sys_int, r_par2, x1_int], 2), x1_int)[:, inv]
    x1_int = half(final, 'dec1', torch.cat([r_sys, r_par1, prior], 2), prior)[:, p]
    logit = half(final, 'dec2', torch.cat([r_sys_int, r_par2, x1_int], 2))
    return torch.sigmoid(logit[:, inv])


def forward(params, bits, noise, pm, arch: dict, precision: str = 'f32'):
    """Encoder -> AWGN -> decoder: the (B, L, 1) bit estimates."""
    return decode(params, encode(params, bits, pm, arch, precision) + noise, pm, arch,
                  precision)


# ------------------------------------------------------------------ FLOPs
def forward_flops(arch: dict, block_len: int) -> int:
    """FLOPs of one block's forward, counted as harness/yardstick.py says:
    the encoder has no products; the decoder's 2 * num_iteration dense
    stacks (layer i: 2 L K (2 + num_iter_ft + i D) D) and heads (D ->
    num_iter_ft, the last D -> 1). 1,243,120,000 at the configuration's
    widths and L = 100."""
    L = block_len
    D, K, nl = arch['dec_num_unit'], arch['dec_kernel_size'], arch['dec_num_layer']
    ft, n_iter = arch['num_iter_ft'], arch['num_iteration']
    stack = sum(2 * L * K * (2 + ft + i * D) * D for i in range(nl))
    heads = 2 * L * D * ft * (2 * n_iter - 1) + 2 * L * D * 1
    return 2 * n_iter * stack + heads
