"""TurboAE-continuous, rate 1/3, CNN encoder and decoder (Jiang et al.,
NeurIPS 2019, arXiv:1911.03038; yihanjiang/turboae `encoders.py`
ENC_interCNN, `decoders.py` DEC_LargeCNN, `channels.py`, `main.py`), in
plain PyTorch.

The architecture, as the reference repository defines it at its defaults:
  - encoder: bits u in {0, 1}, x = 2u - 1; three branches, each a stack of
    enc_num_layer same-length Conv1d layers (kernel enc_kernel_size, ELU
    after each) and a Linear head to one channel with ELU; the third branch
    reads x permuted by the interleaver p1; the three outputs concatenated
    (B, L, 3) and whitened by the mean and the Bessel-corrected standard
    deviation of the whole batch (the power constraint);
  - channel: AWGN, received = code + noise;
  - decoder: num_iteration iterations of two half-decoders, each a stack of
    dec_num_layer Conv1d layers (ELU after each) and a Linear head with no
    activation. dec1 reads [r_sys, r_par1, prior], dec2 [r_sys permuted by
    p1, r_par2, dec1's extrinsic permuted by p1]; each subtracts its prior
    (extrinsic information); dec2's output, permuted back by p1's inverse,
    is the next prior. The last iteration's dec2 head emits one channel,
    with no subtraction; the output is sigmoid of it permuted back.

Departure, as the measured program has it too: the decisions are
torch.round of the output (0.5 rounds to 0).

Tensors are channels last, (B, L, C). Params are nested dicts in PyTorch's
layout: a conv layer {'w': (Cout, Cin, K), 'b': (Cout,)}, a head
{'w': (out, in), 'b': (out,)}; the encoder {'b1' | 'b2' | 'b3': {'cnn':
[layers], 'lin': head}}, the decoder {'iters': [{'dec1_cnn', 'dec2_cnn',
'dec1_lin', 'dec2_lin'}, ...]}.

The interface every reference module gives the harness: `load`, `perms`,
`encode` (the whole batch: the power constraint takes its statistics),
`decode` (any slice of rows) and `forward_flops`. `precision` is 'f32' (the
reference) or 'fp8' (the control: every conv and head operand, activations
and weights, rounded to float8 e4m3 with a per-tensor scale, the products
summed in f32). Set TF32 off before calling: `common.no_tf32()`.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import perms, quantizer
from .msgpack import load as read_msgpack

__all__ = ['load', 'perms', 'encode', 'decode', 'forward_flops']


# ------------------------------------------------------------------ params
def param_specs(arch: dict) -> List[Tuple[Tuple, Tuple[int, ...], int]]:
    """[(path, shape, fan_in)] of every leaf, in the order the tree holds
    them (encoder first; within a layer 'w' then 'b')."""
    U, K, nl = arch['enc_num_unit'], arch['enc_kernel_size'], arch['enc_num_layer']
    D, KD, nd = arch['dec_num_unit'], arch['dec_kernel_size'], arch['dec_num_layer']
    ft, n_iter = arch['num_iter_ft'], arch['num_iteration']
    k = arch['code_rate_k']
    out = []

    def conv(path, cin, cout, ks):
        out.append((path + ('w',), (cout, cin, ks), cin * ks))
        out.append((path + ('b',), (cout,), cin * ks))

    def lin(path, cin, cout):
        out.append((path + ('w',), (cout, cin), cin))
        out.append((path + ('b',), (cout,), cin))

    for b in ('b1', 'b2', 'b3'):
        for i in range(nl):
            conv(('enc', b, 'cnn', i), k if i == 0 else U, U, K)
        lin(('enc', b, 'lin'), U, 1)
    n_in = 2 + ft
    for it in range(n_iter):
        last = it == n_iter - 1
        for s in ('dec1_cnn', 'dec2_cnn'):
            for i in range(nd):
                conv(('dec', 'iters', it, s, i), n_in if i == 0 else D, D, KD)
        lin(('dec', 'iters', it, 'dec1_lin'), D, ft)
        lin(('dec', 'iters', it, 'dec2_lin'), D, 1 if last else ft)
    return out


def build_tree(arch: dict, leaves: List[torch.Tensor]) -> dict:
    """The param tree of `arch` whose leaves, in param_specs order, are `leaves`."""
    specs = param_specs(arch)
    if len(specs) != len(leaves):
        raise ValueError(f'{len(leaves)} leaves for {len(specs)} parameters')
    tree: dict = {}
    for (path, shape, _), t in zip(specs, leaves):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{path}: shape {tuple(t.shape)}, expected {shape}')
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            new = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                if key == len(node):        # list entries come in index order
                    node.append(new)
                node = node[key]
            else:
                node = node.setdefault(key, new)
        node[path[-1]] = t
    return tree


def leaves_of(tree, arch: dict) -> List[torch.Tensor]:
    """The leaves of a tree of this layout in param_specs order."""
    out = []
    for path, _, _ in param_specs(arch):
        node = tree
        for key in path:
            node = node[key]
        out.append(node)
    return out


# -------------------------------------------------------------- checkpoint
# A flax checkpoint's params (the JAX layout): a conv layer {'w': (K, Cin,
# Cout), 'b'}, a head {'w': (in, out), 'b'}, lists as dicts keyed '0', '1',
# ..., and the decoder's iterations as {'scan': <the first n - 1 iterations
# stacked on a leading axis>, 'final': <the last>}.
def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.ndim == 3:            # conv (K, Cin, Cout) -> (Cout, Cin, K)
        a = a.transpose(2, 1, 0)
    elif a.ndim == 2:          # head (in, out) -> (out, in)
        a = a.T
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _get(tree, key):
    if isinstance(tree, list):
        return tree[int(key)]
    return tree[key] if key in tree else tree[str(key)]


def load(path: str, arch: dict, device) -> dict:
    """The reference tree of the checkpoint's 'params', f32 on `device`."""
    params = read_msgpack(path)['params']
    n_iter = arch['num_iteration']
    leaves = []
    for spec_path, _, _ in param_specs(arch):
        if spec_path[0] == 'enc':
            node = params['enc']
            for key in spec_path[1:]:
                node = _get(node, key)
            leaves.append(_leaf(node, device))
            continue
        it, rest = spec_path[2], spec_path[3:]
        node = _get(params['dec'], 'final' if it == n_iter - 1 else 'scan')
        for key in rest:
            node = _get(node, key)
        a = np.asarray(node)
        leaves.append(_leaf(a if it == n_iter - 1 else a[it], device))
    return build_tree(arch, leaves)


# ---------------------------------------------------------------- forward
def _conv(p, x, q):
    w = p['w']
    y = F.conv1d(q(x).transpose(1, 2), q(w), padding=w.shape[2] // 2)
    return y.transpose(1, 2) + p['b']


def _stack(layers, x, q):
    for p in layers:
        x = F.elu(_conv(p, x, q))
    return x


def _lin(p, x, q):
    return torch.matmul(q(x), q(p['w']).t()) + p['b']


def encode(params, bits: torch.Tensor, pm, arch: dict, precision: str = 'f32'
           ) -> torch.Tensor:
    """(B, L, 1) bits -> (B, L, 3) power-constrained code."""
    q = quantizer(precision)
    x = 2.0 * bits - 1.0
    outs = []
    for name, inp in (('b1', x), ('b2', x), ('b3', x[:, pm['p1']])):
        br = params['enc'][name]
        outs.append(F.elu(_lin(br['lin'], _stack(br['cnn'], inp, q), q)))
    code = torch.cat(outs, dim=2)
    mean = code.mean()
    std = torch.sqrt(((code - mean) ** 2).sum() / (code.numel() - 1))
    return (code - mean) / std


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
    *iters, final = params['dec']['iters']
    for w in iters:
        x1 = _lin(w['dec1_lin'], _stack(w['dec1_cnn'], torch.cat([r_sys, r_par1, prior], 2), q),
                  q) - prior
        x1_int = x1[:, p]
        x2 = _lin(w['dec2_lin'], _stack(w['dec2_cnn'], torch.cat([r_sys_int, r_par2, x1_int], 2),
                                        q), q) - x1_int
        prior = x2[:, inv]
    x1 = _lin(final['dec1_lin'], _stack(final['dec1_cnn'], torch.cat([r_sys, r_par1, prior], 2),
                                        q), q) - prior
    x1_int = x1[:, p]
    logit = _lin(final['dec2_lin'], _stack(final['dec2_cnn'],
                                           torch.cat([r_sys_int, r_par2, x1_int], 2), q), q)
    return torch.sigmoid(logit[:, inv])


def forward(params, bits, noise, pm, arch: dict, precision: str = 'f32'):
    """Encoder -> AWGN -> decoder: the (B, L, 1) bit estimates."""
    return decode(params, encode(params, bits, pm, arch, precision) + noise, pm, arch,
                  precision)


# ------------------------------------------------------------------ FLOPs
def _conv_flops(L, K, cin, cout):
    return 2 * L * K * cin * cout


def forward_flops(arch: dict, block_len: int) -> int:
    """FLOPs of one block's forward, counted as harness/yardstick.py says:
    the encoder's three branches and the decoder's 2 * num_iteration
    half-decoders. The last iteration's dec2 head emits one channel (the
    program's utils/flops.py:analytic_flops, copied from JAX, counts it at
    num_iter_ft: 2 L U (num_iter_ft - 1) more a block)."""
    L = block_len
    U, K, nl = arch['enc_num_unit'], arch['enc_kernel_size'], arch['enc_num_layer']
    D, KD, nd = arch['dec_num_unit'], arch['dec_kernel_size'], arch['dec_num_layer']
    ft, n_iter, k = arch['num_iter_ft'], arch['num_iteration'], arch['code_rate_k']
    n_in = 2 + ft
    enc_first = 3 * _conv_flops(L, K, k, U)
    enc_rest = 3 * ((nl - 1) * _conv_flops(L, K, U, U) + 2 * L * U)
    dec_stack = _conv_flops(L, KD, n_in, D) + (nd - 1) * _conv_flops(L, KD, D, D)
    dec = 2 * n_iter * dec_stack + 2 * L * D * ft * (2 * n_iter - 1) + 2 * L * D * 1
    return enc_first + enc_rest + dec
