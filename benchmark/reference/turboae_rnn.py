"""TurboAE-RNN, rate 1/3: the GRU encoder and the iterative GRU decoder (Jiang
et al., "Turbo Autoencoder", NeurIPS 2019, arXiv:1911.03038;
yihanjiang/turboae `encoders.py` ENC_interRNN (:231-298), `decoders.py`
DEC_LargeRNN (:16-149), `main.py` defaults), in plain PyTorch.

The architecture, as the reference repository defines it:
  - a bidirectional GRU layer of H units over (B, L, In) runs a forward and
    a reverse direction, each from h = 0, with torch's gate equations
        r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h,
    the reverse direction's outputs kept in input order; the layer's output
    is [fwd, bwd] (2H features), the next layer's input;
  - encoder: three branches, each a biGRU of enc_num_layer layers over the
    raw bits u in {0, 1} (no BPSK map) and a Linear head 2H -> 1 with
    enc_act; the third branch reads u permuted by the interleaver p1; the
    three outputs concatenated (B, L, 3) and whitened by the mean and the
    Bessel-corrected standard deviation of the whole batch (the power
    constraint);
  - channel: AWGN, received = code + noise;
  - decoder: num_iteration iterations of two half-decoders, each a 2-layer
    biGRU of dec_num_unit units and a Linear head 2H -> num_iter_ft with
    dec_act. dec1 reads [r_sys, r_par1, prior], dec2 [r_sys permuted by
    p1, r_par2, dec1's extrinsic permuted by p1]; with `extrinsic` each
    subtracts its prior; dec2's output, permuted back by p1's inverse, is
    the next prior. The last iteration's dec2 head emits one channel, with
    no subtraction; the output is sigmoid of it permuted back.

Departures from the published description, none of which changes the
function in exact arithmetic:
  - each direction's input projection x W_i + b_i is computed for every
    position at once before the loop over time;
  - the recurrence is a Python loop over positions with an f32 carry;
  - the decisions are torch.round of the output (0.5 rounds to 0), as the
    measured program has them.
No torch.nn.GRU or cuDNN call is made: the gate equations are written out.

Tensors are channels last, (B, L, C). Params are nested dicts in PyTorch's
layout: one direction of a GRU layer {'w_ih': (3H, In), 'w_hh': (3H, H),
'b_ih': (3H,), 'b_hh': (3H,)}, gates in the order r, z, n; a layer
{'fwd', 'bwd'}; a head {'w': (out, in), 'b': (out,)}; the encoder
{'b1' | 'b2' | 'b3': {'rnn': [layers], 'lin': head}}, the decoder
{'iters': [{'dec1_rnn', 'dec2_rnn', 'dec1_lin', 'dec2_lin'}, ...]}.

The interface of every reference module (`turboae_cnn.py` says what each
function takes): `load`, `perms`, `encode`, `decode`, `forward_flops`.
`precision` is 'f32' or 'fp8' (the control: every GRU input, hidden state
and weight and every head operand rounded to float8 e4m3 with a per-tensor
scale, the products summed in f32). Set TF32 off before calling:
`common.no_tf32()`.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from .common import perms, quantizer
from .msgpack import load as read_msgpack
from .turboae_cnn import _get, _lin

__all__ = ['load', 'perms', 'encode', 'decode', 'forward_flops']

_DIR = ('w_ih', 'w_hh', 'b_ih', 'b_hh')
_ACT = {'linear': lambda t: t, 'elu': F.elu}       # enc_act, dec_act
DEC_LAYERS = 2          # DEC_LargeRNN's GRUs have two layers (decoders.py:33-40)


# -------------------------------------------------------------- checkpoint
# A flax checkpoint's params (the JAX layout): one direction of a GRU layer
# {'w_ih': (In, 3H), 'w_hh': (H, 3H), 'b_ih', 'b_hh'}, a head {'w': (in,
# out), 'b'}, lists as dicts keyed '0', '1', ..., and the decoder's
# iterations as {'scan': <the first n - 1 iterations stacked on a leading
# axis>, 'final': <the last>}.
def _tensor(a, shape, where: str, device) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.ndim == 2:            # (in, out) -> (out, in)
        a = a.T
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f'{where}: shape {tuple(a.shape)}, expected {tuple(shape)}')
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _birnn(node, n_in: int, H: int, layers: int, leaf, where: str) -> List[dict]:
    out = []
    for i in range(layers):
        fan = n_in if i == 0 else 2 * H
        shapes = {'w_ih': (3 * H, fan), 'w_hh': (3 * H, H), 'b_ih': (3 * H,),
                  'b_hh': (3 * H,)}
        out.append({d: {k: leaf(_get(_get(node, i), d)[k], shapes[k], f'{where}[{i}].{d}.{k}')
                        for k in _DIR} for d in ('fwd', 'bwd')})
    return out


def load(path: str, arch: dict, device) -> dict:
    """The reference tree of the checkpoint's 'params', f32 on `device`."""
    params = read_msgpack(path)['params']
    U, nl = arch['enc_num_unit'], arch['enc_num_layer']
    D, ft, n_iter = arch['dec_num_unit'], arch['num_iter_ft'], arch['num_iteration']
    k = arch['code_rate_k']

    def enc_leaf(a, shape, where):
        return _tensor(a, shape, f'enc.{where}', device)
    enc = {}
    for b in ('b1', 'b2', 'b3'):
        node = params['enc'][b]
        enc[b] = {'rnn': _birnn(node['rnn'], k, U, nl, enc_leaf, f'{b}.rnn'),
                  'lin': {'w': enc_leaf(node['lin']['w'], (1, 2 * U), f'{b}.lin.w'),
                          'b': enc_leaf(node['lin']['b'], (1,), f'{b}.lin.b')}}
    iters = []
    for it in range(n_iter):
        last = it == n_iter - 1
        src = params['dec']['final' if last else 'scan']

        def leaf(node, shape, where):
            return _tensor(node if last else np.asarray(node)[it], shape,
                           f'dec.{where} of {it}', device)
        w = {s: _birnn(src[s], 2 + ft, D, DEC_LAYERS, leaf, s) for s in ('dec1_rnn', 'dec2_rnn')}
        for s, out in (('dec1_lin', ft), ('dec2_lin', 1 if last else ft)):
            w[s] = {'w': leaf(src[s]['w'], (out, 2 * D), f'{s}.w'),
                    'b': leaf(src[s]['b'], (out,), f'{s}.b')}
        iters.append(w)
    return {'enc': enc, 'dec': {'iters': iters}}


# --------------------------------------------------------------------- GRU
def _direction(p, x: torch.Tensor, reverse: bool, q) -> torch.Tensor:
    """One direction of a GRU layer over (B, L, In) -> (B, L, H), f32."""
    B, L, _ = x.shape
    H = p['w_hh'].shape[1]
    gi = torch.matmul(q(x), q(p['w_ih']).t()) + p['b_ih']          # (B, L, 3H)
    w_hh = q(p['w_hh']).t()
    h = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    out = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gh = torch.matmul(q(h), w_hh) + p['b_hh']
        i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * h
        out[t] = h
    return torch.stack(out, dim=1)


def bigru(layers, x: torch.Tensor, q=lambda t: t) -> torch.Tensor:
    """A bidirectional GRU stack: (B, L, In) -> (B, L, 2H)."""
    for layer in layers:
        x = torch.cat([_direction(layer['fwd'], x, False, q),
                       _direction(layer['bwd'], x, True, q)], dim=2)
    return x


# ----------------------------------------------------------- encode, decode
def encode(params, bits: torch.Tensor, pm, arch: dict, precision: str = 'f32'
           ) -> torch.Tensor:
    """(B, L, 1) bits -> (B, L, 3) power-constrained code."""
    q = quantizer(precision)
    act = _ACT[arch['enc_act']]
    outs = []
    for name, inp in (('b1', bits), ('b2', bits), ('b3', bits[:, pm['p1']])):
        br = params['enc'][name]
        outs.append(act(_lin(br['lin'], bigru(br['rnn'], inp, q), q)))
    code = torch.cat(outs, dim=2)
    mean = code.mean()
    std = torch.sqrt(((code - mean) ** 2).sum() / (code.numel() - 1))
    return (code - mean) / std


def decode(params, received: torch.Tensor, pm, arch: dict, precision: str = 'f32'
           ) -> torch.Tensor:
    """(B, L, 3) received -> (B, L, 1) bit estimates in (0, 1)."""
    q = quantizer(precision)
    act = _ACT[arch['dec_act']]
    p, inv = pm['p1'], pm['p1_inv']
    r_sys, r_par1, r_par2 = received[:, :, 0:1], received[:, :, 1:2], received[:, :, 2:3]
    r_sys_int = r_sys[:, p]
    b, l, _ = received.shape
    prior = torch.zeros((b, l, arch['num_iter_ft']), dtype=received.dtype,
                        device=received.device)

    def half(w, s, x, sub=None):
        out = act(_lin(w[f'{s}_lin'], bigru(w[f'{s}_rnn'], x, q), q))
        return out if sub is None or not arch['extrinsic'] else out - sub

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
def bigru_flops(L: int, n_in: int, H: int, layers: int) -> int:
    """Products of one biGRU stack over a block of L positions: a direction
    of layer i takes 2 L (In_i 3H + H 3H), In_0 = n_in, In_i = 2H after."""
    return sum(2 * 2 * L * ((n_in if i == 0 else 2 * H) * 3 * H + H * 3 * H)
               for i in range(layers))


def forward_flops(arch: dict, block_len: int) -> int:
    """FLOPs of one block's forward, counted as harness/yardstick.py says:
    the encoder's three biGRUs and heads (2H -> 1), the decoder's
    2 * num_iteration biGRUs and heads (2H -> num_iter_ft, the last 2H ->
    1). 732,800,000 at the configuration's widths and L = 100."""
    L = block_len
    U, nl, k = arch['enc_num_unit'], arch['enc_num_layer'], arch['code_rate_k']
    D, ft, n_iter = arch['dec_num_unit'], arch['num_iter_ft'], arch['num_iteration']
    enc = 3 * (bigru_flops(L, k, U, nl) + 2 * L * 2 * U)
    dec = 2 * n_iter * bigru_flops(L, 2 + ft, D, DEC_LAYERS)
    heads = 2 * L * 2 * D * ft * (2 * n_iter - 1) + 2 * L * 2 * D * 1
    return enc + dec + heads
