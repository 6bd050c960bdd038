"""LDPC codes: design files, construction and belief-propagation decoding
(JAX: classical/ldpc.py; reference commpy/channelcoding/ldpc.py).

Host: the port's own numpy copies of JAX's `get_ldpc_code_params` (the
Gallager design-file format, 1-indexed and tab-separated), the seeded
regular (dv, dc) `gallager_ldpc_design`, and `ldpc_bp_decode`, a vectorized
BP (SPA tanh product or MSA min-sum) of one codeword with the reference's
schedule and early termination. The reference's (96, 48) design files are
copied into designs/, so the port reads no file of the JAX package.

Device: `make_ldpc_decoder` (JAX :194-264) decodes (B, n) LLRs in batch on
their device with JAX's fixed iteration count, freezing each block's output
at its first parity satisfaction (the results of early termination).

LLR convention of the reference: a positive LLR is bit 0.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .trellis import device_tables

DESIGNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'designs')

MAX_POS_LLR = 38.0
MIN_NEG_LLR = -38.0


def get_ldpc_code_params(ldpc_design_filename: str) -> Dict:
    """Parse a Gallager design file (reference ldpc.py:14-85)."""
    with open(ldpc_design_filename) as f:
        n_vnodes, n_cnodes = (int(x) for x in f.readline().split())
        max_vnode_deg, max_cnode_deg = (int(x) for x in f.readline().split())
        vnode_deg_list = np.array(f.readline().split(), int)
        cnode_deg_list = np.array(f.readline().split(), int)
        vnode_adj = -np.ones((n_vnodes, max_vnode_deg), int)
        for v in range(n_vnodes):
            row = [int(x) - 1 for x in f.readline().split()]
            vnode_adj[v, :len(row)] = row
        cnode_adj = -np.ones((n_cnodes, max_cnode_deg), int)
        for c in range(n_cnodes):
            row = [int(x) - 1 for x in f.readline().split()]
            cnode_adj[c, :len(row)] = row
    return _build_params(n_vnodes, n_cnodes, vnode_deg_list, cnode_deg_list,
                         vnode_adj, cnode_adj)


def _build_params(n_vnodes, n_cnodes, vnode_deg_list, cnode_deg_list,
                  vnode_adj, cnode_adj) -> Dict:
    max_vnode_deg = vnode_adj.shape[1]
    max_cnode_deg = cnode_adj.shape[1]

    # slot maps: cnode_vnode_map[c, i] = which slot of vnode_adj[v] points
    # back to c (reference ldpc.py:49-60)
    cnode_vnode_map = -np.ones((n_cnodes, max_cnode_deg), int)
    vnode_cnode_map = -np.ones((n_vnodes, max_vnode_deg), int)
    for c in range(n_cnodes):
        for i in range(cnode_deg_list[c]):
            v = cnode_adj[c, i]
            cnode_vnode_map[c, i] = int(np.where(vnode_adj[v] == c)[0][0])
    for v in range(n_vnodes):
        for i in range(vnode_deg_list[v]):
            c = vnode_adj[v, i]
            vnode_cnode_map[v, i] = int(np.where(cnode_adj[c] == v)[0][0])

    pmat = np.zeros((n_cnodes, n_vnodes), int)
    for c in range(n_cnodes):
        pmat[c, cnode_adj[c, :cnode_deg_list[c]]] = 1

    return {
        'n_vnodes': n_vnodes, 'n_cnodes': n_cnodes,
        'max_vnode_deg': max_vnode_deg, 'max_cnode_deg': max_cnode_deg,
        'vnode_deg_list': vnode_deg_list, 'cnode_deg_list': cnode_deg_list,
        'vnode_adj_list': vnode_adj.flatten().astype(np.int32),
        'cnode_adj_list': cnode_adj.flatten().astype(np.int32),
        'vnode_cnode_map': vnode_cnode_map.flatten().astype(np.int32),
        'cnode_vnode_map': cnode_vnode_map.flatten().astype(np.int32),
        'pmat': pmat,
    }


def gallager_ldpc_design(n: int, dv: int, dc: int, seed: int = 0) -> Dict:
    """Regular (dv, dc) Gallager ensemble: n vnodes, n*dv/dc cnodes.

    Construction: dv permuted copies of a band structure; resamples on
    duplicate edges. Standalone replacement for the vendored design files.
    """
    assert (n * dv) % dc == 0
    m = n * dv // dc
    rng = np.random.RandomState(seed)
    while True:
        # socket permutation construction
        sockets = np.repeat(np.arange(m), dc)
        for _ in range(64):
            rng.shuffle(sockets)
            cnode_of_edge = sockets.reshape(n, dv)
            if all(len(set(cnode_of_edge[v])) == dv for v in range(n)):
                break
        else:
            continue
        vnode_adj = np.sort(cnode_of_edge, axis=1)
        counts = np.zeros(m, int)
        cnode_adj = -np.ones((m, dc), int)
        ok = True
        for v in range(n):
            for c in vnode_adj[v]:
                if counts[c] >= dc:
                    ok = False
                    break
                cnode_adj[c, counts[c]] = v
                counts[c] += 1
            if not ok:
                break
        if ok:
            break
    return _build_params(n, m, np.full(n, dv), np.full(m, dc),
                         vnode_adj, cnode_adj)


def _edge_messages(params):
    """Dense (padded) edge views used by the vectorized decoders."""
    n_v, n_c = params['n_vnodes'], params['n_cnodes']
    dv, dc = params['max_vnode_deg'], params['max_cnode_deg']
    v_adj = params['vnode_adj_list'].reshape(n_v, dv)
    c_adj = params['cnode_adj_list'].reshape(n_c, dc)
    v_map = params['vnode_cnode_map'].reshape(n_v, dv)
    c_map = params['cnode_vnode_map'].reshape(n_c, dc)
    v_mask = np.arange(dv)[None, :] < params['vnode_deg_list'][:, None]
    c_mask = np.arange(dc)[None, :] < params['cnode_deg_list'][:, None]
    return v_adj, c_adj, v_map, c_map, v_mask, c_mask


def ldpc_bp_decode(llr_vec: np.ndarray, ldpc_code_params: Dict,
                   decoder_algorithm: str = 'SPA', n_iters: int = 100):
    """Vectorized BP decode of ONE codeword (reference ldpc.py:130-237).

    Returns (dec_word, out_llrs)."""
    p = ldpc_code_params
    v_adj, c_adj, v_map, c_map, v_mask, c_mask = _edge_messages(p)
    llr = np.asarray(llr_vec, float)

    # vnode -> cnode messages, shape (n_vnodes, dv)
    v_msgs = np.where(v_mask, llr[:, None], 0.0)
    dec_word = np.zeros(p['n_vnodes'], int)
    out_llrs = llr.copy()

    for _ in range(n_iters):
        # gather incoming messages at each check node: (n_cnodes, dc)
        incoming = v_msgs[c_adj, c_map]
        if decoder_algorithm == 'SPA':
            t = np.tanh(incoming / 2.0)
            t = np.where(c_mask, t, 1.0)
            prod = np.prod(t, axis=1, keepdims=True)
            with np.errstate(divide='ignore', invalid='ignore'):
                ratio = np.clip(prod / np.where(t == 0, 1e-30, t), -0.9999999, 0.9999999)
            c_msgs = 2.0 * np.arctanh(ratio)
        elif decoder_algorithm == 'MSA':
            mag = np.where(c_mask, np.abs(incoming), np.inf)
            sgn = np.where(c_mask, np.sign(incoming), 1.0)
            sgn = np.where(sgn == 0, 1.0, sgn)
            total_sign = np.prod(sgn, axis=1, keepdims=True)
            # leave-one-out min: min and second-min
            order = np.argsort(mag, axis=1)
            min1 = np.take_along_axis(mag, order[:, :1], axis=1)
            min2 = np.take_along_axis(mag, order[:, 1:2], axis=1)
            is_min = np.arange(mag.shape[1])[None, :] == order[:, :1]
            loo_min = np.where(is_min, min2, min1)
            c_msgs = total_sign * sgn * loo_min
        else:
            raise NameError('Please input a valid decoder_algorithm string.')
        c_msgs = np.where(c_mask, c_msgs, 0.0)

        # variable node update
        incoming_v = c_msgs[v_adj, v_map]                  # (n_vnodes, dv)
        incoming_v = np.where(v_mask, incoming_v, 0.0)
        msg_sum = incoming_v.sum(axis=1)
        v_msgs = np.clip(llr[:, None] + msg_sum[:, None] - incoming_v,
                         MIN_NEG_LLR, MAX_POS_LLR)
        v_msgs = np.where(v_mask, v_msgs, 0.0)

        out_llrs = llr + msg_sum
        dec_word = (out_llrs <= 0).astype(int)

        # early termination on parity satisfaction
        parity = np.bitwise_xor.reduce(
            np.where(c_mask, dec_word[c_adj], 0), axis=1)
        if not parity.any():
            break

    return dec_word, out_llrs


def _fold(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce the last axis left to right, as XLA's reduce does on the CPU,
    in the same order on every device: a library reduction may pair the
    terms otherwise, and BP carries the last bit of a sum through its
    iterations into the decisions of frames that never converge."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = op(out, x[..., i])
    return out


def make_ldpc_decoder(ldpc_code_params: Dict, decoder_algorithm: str = 'SPA',
                      n_iters: int = 100):
    """fn(llr (B, n)) -> (bits (B, n) int32, llr (B, n) f32), on llr's device."""
    if decoder_algorithm not in ('SPA', 'MSA'):
        raise ValueError(f'unknown decoder algorithm {decoder_algorithm!r}')
    tables = device_tables(dict(zip(('v_adj', 'c_adj', 'v_map', 'c_map', 'v_mask', 'c_mask'),
                                    _edge_messages(ldpc_code_params))))

    def check_messages(incoming, c_mask):
        """(B, checks, dc) incoming variable messages -> check messages."""
        if decoder_algorithm == 'SPA':
            t = torch.where(c_mask, torch.tanh(incoming / 2.0), 1.0)
            prod = _fold(t, torch.mul)[..., None]
            ratio = torch.clamp(prod / torch.where(t == 0, 1e-30, t), -0.9999999, 0.9999999)
            return 2.0 * torch.atanh(ratio)
        mag = torch.where(c_mask, incoming.abs(), float('inf'))
        sgn = torch.where(c_mask, torch.sign(incoming), 1.0)
        sgn = torch.where(sgn == 0, 1.0, sgn)
        total_sign = sgn.prod(dim=2, keepdim=True)
        min1 = mag.min(dim=2, keepdim=True).values
        # the first minimum is the one left out, as JAX's argmin picks it
        eq = mag == min1
        is_min = eq & (eq.cumsum(dim=2) == 1)
        min2 = torch.where(is_min, float('inf'), mag).min(dim=2, keepdim=True).values
        return total_sign * sgn * torch.where(is_min, min2, min1)

    def decode(llr: torch.Tensor):
        t = tables(llr.device)
        llr = llr.float()
        v_mask, c_mask = t['v_mask'], t['c_mask']
        v_msgs = torch.where(v_mask, llr[:, :, None], 0.0)           # (B, n, dv)
        done = torch.zeros(llr.shape[0], dtype=torch.bool, device=llr.device)
        frozen_bits, frozen_llrs = (llr <= 0).to(torch.int32), llr
        for _ in range(n_iters):
            c_msgs = check_messages(v_msgs[:, t['c_adj'], t['c_map']], c_mask)
            c_msgs = torch.where(c_mask, c_msgs, 0.0)
            incoming_v = torch.where(v_mask, c_msgs[:, t['v_adj'], t['v_map']], 0.0)
            msg_sum = _fold(incoming_v, torch.add)
            new_v_msgs = torch.clamp(llr[:, :, None] + msg_sum[:, :, None] - incoming_v,
                                     MIN_NEG_LLR, MAX_POS_LLR)
            new_v_msgs = torch.where(v_mask, new_v_msgs, 0.0)
            out_llrs = llr + msg_sum
            bits = (out_llrs <= 0).to(torch.int32)
            parity = torch.where(c_mask, bits[:, t['c_adj']], 0).sum(dim=2) % 2
            ok = (parity == 0).all(dim=1)
            # freeze each block's output at its first parity satisfaction
            live = ~done
            frozen_bits = torch.where(live[:, None], bits, frozen_bits)
            frozen_llrs = torch.where(live[:, None], out_llrs, frozen_llrs)
            v_msgs = torch.where(done[:, None, None], v_msgs, new_v_msgs)
            done = done | ok
        return frozen_bits, frozen_llrs

    return decode
