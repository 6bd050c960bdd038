"""BCJR (MAP) decoding (JAX: classical/bcjr.py).

Host: `map_decode`, the probability-domain recursions with per-step
normalization (reference commpy/channelcoding/turbo.py:63-259), vectorized
over states; the port's own numpy copy of JAX's oracle.

Device: `make_map_decoder(trellis)` (JAX :90-163), the log-domain recursions
batched over blocks, a loop over time on the host. The branch metrics and
log priors of every step are computed before the loop, so its body holds
only the recursion. The forward step keeps JAX's formula and constants: one
max over all (state, input) terms of a block, exp, the sum into each next
state, log(sum + 1e-38) + max, renormalized; start states other than 0 at
-1e30, a uniform zero terminal beta. Every next state has exactly two
predecessors, so JAX's scatter-add is a gather over a (states, 2) table and
a sum of two terms, exact in either order, with no atomics.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .convcode import predecessors
from .trellis import Trellis, device_tables


def _gammas(trellis: Trellis, sys_symbols, non_sys_symbols, noise_variance,
            priors):
    """Branch probabilities gamma[t, s, u] (reference turbo.py:63-116).

    priors: (2, L) input prior probabilities.
    Returns (L, S, U) branch probs INCLUDING the prior factor NOT applied
    (the recursions apply priors separately, matching the reference).
    """
    obits = trellis.output_bits()            # (S, U, n) with n=2
    msg_bit = 2.0 * obits[:, :, 0] - 1.0     # (S, U)
    par_bit = 2.0 * obits[:, :, 1] - 1.0
    L = len(sys_symbols)
    x = sys_symbols[:, None, None] - msg_bit[None]       # (L, S, U)
    y = non_sys_symbols[:, None, None] - par_bit[None]
    return np.exp(-(x * x + y * y) / (2.0 * noise_variance))


def map_decode(sys_symbols, non_sys_symbols, trellis: Trellis,
               noise_variance, L_int, mode: str = 'decode'):
    """MAP decoder returning [L_ext, decoded_bits] (reference turbo.py:171-259).

    NOTE the reference's "L_ext" is actually the full a-posteriori LLR
    (L_int + log(app1/app0), turbo.py:153) — callers subtract L_int; kept.
    """
    S = trellis.number_states
    U = trellis.number_inputs
    nst = trellis.next_state_table
    L = len(sys_symbols)

    priors = np.empty((2, L))
    priors[0] = 1.0 / (1.0 + np.exp(L_int))
    priors[1] = 1.0 - priors[0]

    gamma = _gammas(trellis, np.asarray(sys_symbols, float),
                    np.asarray(non_sys_symbols, float), noise_variance, priors)

    # backward: beta[t, s], beta[L] = 1 (turbo.py:86-119)
    beta = np.zeros((L + 1, S))
    beta[L] = 1.0
    for t in range(L - 1, -1, -1):
        # beta[t, s] = sum_u beta[t+1, nst[s,u]] * gamma[t,s,u] * prior[u,t]
        b = beta[t + 1][nst] * gamma[t] * priors[:, t][None, :]
        beta[t] = b.sum(axis=1)
        beta[t] /= beta[t].sum()

    # forward + APP extraction (turbo.py:122-166)
    alpha = np.zeros(S)
    alpha[0] = 1.0
    L_ext = np.zeros(L)
    decoded = np.zeros(L, 'int')
    for t in range(L):
        contrib = alpha[:, None] * gamma[t]              # (S, U)
        app = (contrib * beta[t + 1][nst]).sum(axis=0)   # (U,)
        lappr = L_int[t] + np.log(app[1] / app[0])
        L_ext[t] = lappr
        if mode == 'decode':
            decoded[t] = 1 if lappr > 0 else 0
        new_alpha = np.zeros(S)
        np.add.at(new_alpha, nst.reshape(-1),
                  (contrib * priors[:, t][None, :]).reshape(-1))
        alpha = new_alpha / new_alpha.sum()

    return [L_ext, decoded]


NEG = -1e30                  # log alpha of the start states other than 0 (JAX bcjr.py:103)
FLOOR = 1e-38                # added before the log of the forward sum (JAX bcjr.py:154)


def forward_step(lalpha, lg, lp, lbeta_next, nst, pred_flat):
    """One forward step of the log-BCJR: (new log alpha (B, S), log APP (B, U)).

    lalpha (B, S); lg (B, S, U) log branch metrics; lp (B, U) log priors;
    lbeta_next (B, S) the backward metric one step later; nst (S, U) next
    states; pred_flat (S, 2) the flat (state * U + input) predecessors of
    each state. 1e-38 is an f32 subnormal: where a next state's sum is 0 (at
    t=0 every state but 0 starts at -1e30), its log is log(1e-38) + max on a
    device that keeps subnormals, as the card and PyTorch's CPU do; XLA on
    the CPU flushes it, and there the state is -inf. Either way such a state
    weighs e^-87 of the largest and moves no f32 LLR."""
    B = lalpha.shape[0]
    contrib = lalpha[:, :, None] + lg                                  # (B, S, U)
    app = torch.logsumexp(contrib + lbeta_next[:, nst], dim=1)         # (B, U)
    flat = (contrib + lp[:, None, :]).reshape(B, -1)
    m = flat.max(dim=-1, keepdim=True).values
    summed = torch.exp(flat - m)[:, pred_flat].sum(-1)                 # (B, S)
    new = torch.log(summed + FLOOR) + m
    return new - torch.logsumexp(new, dim=-1, keepdim=True), app


def make_map_decoder(trellis: Trellis) -> Callable:
    """fn(sys (B, L), par (B, L), noise_variance float, L_int (B, L)) ->
    L_post (B, L), the full a-posteriori LLRs (map_decode's first return),
    in f32 on the inputs' device."""
    pred_state, pred_input = predecessors(trellis)
    obits = trellis.output_bits()
    tables = device_tables({'nst': trellis.next_state_table,
                            'pred_flat': pred_state * trellis.number_inputs + pred_input,
                            'msg_sym': 2.0 * obits[:, :, 0] - 1.0,
                            'par_sym': 2.0 * obits[:, :, 1] - 1.0})
    S = trellis.number_states

    def decode(sys_symbols, non_sys_symbols, noise_variance, L_int):
        t = tables(sys_symbols.device)
        sys_symbols, non_sys_symbols, L_int = (x.float() for x in (sys_symbols, non_sys_symbols, L_int))
        B, L = sys_symbols.shape
        # in f32 as JAX's jit takes a Python float: 1 / (2 nv) rounded once
        inv2v = float(np.float32(1.0) / (np.float32(2.0) * np.float32(noise_variance)))
        # time-major, so that each step reads a contiguous slice
        x = sys_symbols.t()[:, :, None, None] - t['msg_sym']
        y = non_sys_symbols.t()[:, :, None, None] - t['par_sym']
        log_gamma = -(x * x + y * y) * inv2v                           # (L, B, S, U)
        L_int_t = L_int.t()
        zero = torch.zeros_like(L_int_t)
        # log P(u=0), log P(u=1): -softplus(+-L_int), with no threshold
        log_prior = torch.stack([-torch.logaddexp(L_int_t, zero),
                                 -torch.logaddexp(-L_int_t, zero)], dim=-1)  # (L, B, U)

        lbetas = [None] * L
        lbeta = sys_symbols.new_zeros((B, S))
        for step in range(L - 1, -1, -1):
            lbetas[step] = lbeta            # beta one step after `step`
            terms = lbeta[:, t['nst']] + log_gamma[step] + log_prior[step, :, None, :]
            lbeta = torch.logsumexp(terms, dim=-1)
            lbeta = lbeta - torch.logsumexp(lbeta, dim=-1, keepdim=True)

        lalpha = sys_symbols.new_full((B, S), NEG)
        lalpha[:, 0] = 0.0
        apps = []
        for step in range(L):
            lalpha, app = forward_step(lalpha, log_gamma[step], log_prior[step],
                                       lbetas[step], t['nst'], t['pred_flat'])
            apps.append(app)
        apps = torch.stack(apps, dim=1)                                 # (B, L, U)
        return L_int + apps[:, :, 1] - apps[:, :, 0]

    return decode
