"""The table-driven convolutional encoder on the device
(JAX: classical/convcode.py:232-288).

`make_encoder(trellis, code_type)` returns a function of (B, L) int bits to
(B, (L+M)*n) int64 code bits, on the bits' device. Its tables are small
int64 tensors; each of the L steps gathers the batch's outputs and next
states from them, a loop of L steps on the host. Code type 'default' feeds
M zeros after the message; 'rsc' instead appends, per final state, the M
termination inputs that return the register toward 0 (the reversed state
bits, commpy conv_encode :404-413), precomputed on the host. JAX runs a
second scan only to find the final state; the first one's is the same.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .trellis import Trellis, dec2bitarray


def termination_tables(trellis: Trellis):
    """(term_inputs, term_states), each (states, M): from each final state
    the M inputs of the rsc termination and the states they leave from."""
    M, S = trellis.total_memory, trellis.number_states
    term_inputs = np.zeros((S, M), 'int')
    term_states = np.zeros((S, M), 'int')
    for s0 in range(S):
        s = s0
        tb = dec2bitarray(s0, M)[::-1]
        for i in range(M):
            term_inputs[s0, i] = tb[i]
            term_states[s0, i] = s
            s = trellis.next_state_table[s][tb[i]]
    return term_inputs, term_states


def make_encoder(trellis: Trellis, code_type: str = 'default') -> Callable:
    """msgs (B, L) int -> codes (B, (L+M)*n) int64, on msgs' device."""
    if code_type not in ('default', 'rsc'):
        raise ValueError(f'unknown code type {code_type!r}')
    M, n = trellis.total_memory, trellis.n
    host = {'nst': trellis.next_state_table, 'obits': trellis.output_bits()}
    if code_type == 'rsc':
        host['term_inputs'], host['term_states'] = termination_tables(trellis)
    cache: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def tables(device):
        if device not in cache:
            cache[device] = {k: torch.as_tensor(np.asarray(v, np.int64), device=device)
                             for k, v in host.items()}
        return cache[device]

    def encode(msgs: torch.Tensor) -> torch.Tensor:
        t = tables(msgs.device)
        B, L = msgs.shape
        inb = msgs.long()
        if code_type == 'default':
            inb = torch.cat([inb, inb.new_zeros((B, M))], dim=1)
        state = inb.new_zeros(B)
        outs = []
        for u in inb.unbind(1):
            outs.append(t['obits'][state, u])
            state = t['nst'][state, u]
        if code_type == 'rsc':
            ts, ti = t['term_states'][state], t['term_inputs'][state]     # (B, M)
            outs.extend(t['obits'][ts, ti].unbind(1))
        return torch.stack(outs, dim=1).reshape(B, -1)

    return encode
