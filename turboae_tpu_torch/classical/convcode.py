"""Convolutional encoding and Viterbi decoding (JAX: classical/convcode.py).

Host: `conv_encode`, `conv_encode_batch` and the windowed-traceback
`viterbi_decode`, the port's own numpy copies of the exact-semantics oracles
(reference commpy/channelcoding/convcode.py:340-659).

Device: `make_encoder(trellis, code_type)` returns a function of (B, L) int
bits to (B, (L+M)*n) int64 code bits, on the bits' device (JAX :232-288).
Its tables are small int64 tensors. The states run as a prefix composition
of the steps' state maps (each step's next state from every state, composed
by gathers in log2 L rounds), so a call is a few dozen device operations,
not a loop of L steps on the host; the outputs are then one gather. Code type
'default' feeds M zeros after the message; 'rsc' instead appends, per final
state, the M termination inputs that return the register toward 0 (the
reversed state bits, commpy conv_encode :404-413), precomputed on the host.
JAX runs a second scan only to find the final state; the first one's is the
same.

`make_viterbi(trellis, decoding_type)` (JAX :290-363) decodes (B, T, n)
received symbols to (B, T) int32 bits with full traceback from state 0: the
branch metrics of every step are computed before the loop, then T
add-compare-select steps, each renormalized by its minimum, and T traceback
steps, all on the received tensor's device.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .trellis import Trellis, dec2bitarray, device_tables


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


def predecessors(trellis: Trellis):
    """(pred_state, pred_input), each (states, 2): the two (state, input)
    pairs that lead into each state, in the order of (state, input)."""
    S = trellis.number_states
    preds = [[] for _ in range(S)]
    for ps in range(S):
        for u in range(trellis.number_inputs):
            preds[trellis.next_state_table[ps][u]].append((ps, u))
    return (np.array([[p[0] for p in preds[s]] for s in range(S)]),
            np.array([[p[1] for p in preds[s]] for s in range(S)]))


def conv_encode(message_bits: np.ndarray, trellis: Trellis,
                code_type: str = 'default',
                puncture_matrix: Optional[np.ndarray] = None) -> np.ndarray:
    """Table-driven encoder (reference convcode.py:340-421).

    code_type 'default': append M zero pad bits (plain termination).
    code_type 'rsc': trellis termination — after the message, feed the inputs
    that drive the (feedback) register back to zero, derived from the state
    bits reversed (convcode.py:404-413).
    """
    k, n = trellis.k, trellis.n
    M = trellis.total_memory
    msg = np.asarray(message_bits).astype(int)
    nmsg = msg.size

    if code_type == 'default':
        inbits = np.zeros(nmsg + M + M % k, 'int')
        inbits[:nmsg] = msg
        number_outbits = int(inbits.size * n / k)
    else:
        inbits = msg
        number_outbits = int((nmsg + M) * n / k)

    outbits = np.zeros(number_outbits, 'int')
    nst, out = trellis.next_state_table, trellis.output_table

    state = 0
    j = 0
    for i in range(inbits.size // k):
        u = int(inbits[i])
        outbits[j * n:(j + 1) * n] = dec2bitarray(out[state][u], n)
        state = nst[state][u]
        j += 1

    if code_type == 'rsc':
        term_bits = dec2bitarray(state, M)[::-1]
        for i in range(M):
            u = int(term_bits[i])
            outbits[j * n:(j + 1) * n] = dec2bitarray(out[state][u], n)
            state = nst[state][u]
            j += 1

    if puncture_matrix is not None:
        pm = np.asarray(puncture_matrix)
        keep = [i for i in range(number_outbits) if pm[0][i % pm.shape[1]] == 1]
        return outbits[keep]
    return outbits


def conv_encode_batch(messages: np.ndarray, trellis: Trellis,
                      code_type: str = 'default') -> np.ndarray:
    """Vectorized multi-block encoder: (B, L) -> (B, L_out*n).

    Same outputs as conv_encode per row, but the clock-cycle loop runs once
    over time with the batch dimension vectorized — the host-side analog of
    the device path, used by the classical benchmark CLIs.
    """
    msgs = np.asarray(messages).astype(int)
    B, L = msgs.shape
    M = trellis.total_memory
    n = trellis.n
    nst, out = trellis.next_state_table, trellis.output_table
    obits = trellis.output_bits()

    if code_type == 'default':
        pad = np.zeros((B, M), 'int')
        inb = np.concatenate([msgs, pad], axis=1)
        T = inb.shape[1]
        outbits = np.zeros((B, T, n), 'int')
        state = np.zeros(B, 'int')
        for t in range(T):
            u = inb[:, t]
            outbits[:, t, :] = obits[state, u]
            state = nst[state, u]
        return outbits.reshape(B, T * n)

    # rsc termination path
    T = L + M
    outbits = np.zeros((B, T, n), 'int')
    state = np.zeros(B, 'int')
    for t in range(L):
        u = msgs[:, t]
        outbits[:, t, :] = obits[state, u]
        state = nst[state, u]
    # termination inputs come from the reversed state bits of the state at the
    # START of termination; the register keeps evolving, so grab bit i of the
    # ORIGINAL per-row state each step (convcode.py:406-413 derives all term
    # bits from the pre-termination state at once)
    term_inputs, _ = termination_tables(trellis)
    start_state = state.copy()
    for i in range(M):
        u = term_inputs[start_state, i]
        outbits[:, L + i, :] = obits[state, u]
        state = nst[state, u]
    return outbits.reshape(B, T * n)


def _branch_metrics(r_codeword, obits_pm, decoding_type):
    """Metric of received word vs each (prev_state, input) ideal codeword.

    obits_pm: (P, n) ideal codewords (bits). Returns (P,) metrics."""
    if decoding_type == 'hard':
        return np.sum(np.asarray(r_codeword).astype(int) ^ obits_pm, axis=1)
    syms = 2 * obits_pm - 1
    d = np.asarray(r_codeword, float)[None, :] - syms
    if decoding_type == 'unquantized':
        return np.sum(d * d, axis=1)
    if decoding_type == 'tdist3':
        return np.sum(np.log(1 + d * d / 1.0), axis=1)
    if decoding_type == 'tdist5':
        return np.sum(np.log(1 + d * d / 4.0), axis=1)
    raise ValueError(decoding_type)


def viterbi_decode(coded_bits: np.ndarray, trellis: Trellis,
                   tb_depth: Optional[int] = None,
                   decoding_type: str = 'hard') -> np.ndarray:
    """Viterbi with FULL traceback (host oracle).

    Interface-compatible with the reference (convcode.py:540-659): input of
    length (L+M)*n/k including termination, returns L decoded bits (the
    reference returns the message portion after trimming; round-trip tests
    compare decoded[:-M] with the message).

    Full traceback is used instead of the reference's windowed ring buffer —
    it is the ML-optimal special case (tb_depth = sequence length) and
    reproduces or improves every reference BER figure.
    """
    k, n = trellis.k, trellis.n
    S = trellis.number_states
    coded = np.asarray(coded_bits)
    L = int(len(coded) * k / n)
    T = L  # includes termination symbols already

    obits = trellis.output_bits()

    pred_state, pred_input = predecessors(trellis)      # (S, P)

    INF = 1e9
    pm = np.full(S, INF)
    pm[0] = 0.0
    bp_state = np.zeros((T, S), 'int')
    bp_input = np.zeros((T, S), 'int')
    pms = np.zeros((T + 1, S))  # path metrics after each step (for windowed tb)
    pms[0] = pm

    for t in range(T):
        r = coded[t * n:(t + 1) * n]
        if len(r) < n:
            pad = np.zeros(n)
            pad[:len(r)] = r
            r = pad
        new_pm = np.full(S, INF)
        for s in range(S):
            cand_metrics = pm[pred_state[s]] + _branch_metrics(
                r, obits[pred_state[s], pred_input[s]], decoding_type)
            best = int(np.argmin(cand_metrics))
            new_pm[s] = cand_metrics[best]
            bp_state[t, s] = pred_state[s][best]
            bp_input[t, s] = pred_input[s][best]
        pm = new_pm
        pms[t + 1] = pm

    if tb_depth is not None and 0 < tb_depth < T:
        # low-latency windowed traceback (reference conv_codes_llcode.py):
        # the bit at time t is decided by tracing back tb_depth steps from
        # the best state at time t+tb_depth (state 0 once the window reaches
        # the terminated end)
        decoded = np.zeros(T, 'int')
        for t in range(T):
            end = min(t + tb_depth, T)
            state = 0 if end == T else int(np.argmin(pms[end]))
            for tt in range(end - 1, t - 1, -1):
                bit = bp_input[tt, state]
                state = bp_state[tt, state]
            decoded[t] = bit
        return decoded[:L]

    # force back to state 0 at the end like the reference (convcode.py:653-655)
    state = 0
    decoded = np.zeros(T, 'int')
    for t in range(T - 1, -1, -1):
        decoded[t] = bp_input[t, state]
        state = bp_state[t, state]
    return decoded[:L]


def make_encoder(trellis: Trellis, code_type: str = 'default') -> Callable:
    """msgs (B, L) int -> codes (B, (L+M)*n) int64, on msgs' device."""
    if code_type not in ('default', 'rsc'):
        raise ValueError(f'unknown code type {code_type!r}')
    M, n = trellis.total_memory, trellis.n
    host = {'nst_by_input': np.ascontiguousarray(trellis.next_state_table.T),   # (inputs, S)
            'obits': trellis.output_bits()}
    if code_type == 'rsc':
        host['term_inputs'], host['term_states'] = termination_tables(trellis)
    tables = device_tables(host)

    def encode(msgs: torch.Tensor) -> torch.Tensor:
        t = tables(msgs.device)
        B, L = msgs.shape
        inb = msgs.long()
        if code_type == 'default':
            inb = torch.cat([inb, inb.new_zeros((B, M))], dim=1)
        T = inb.shape[1]
        # f[:, j, s]: the state after inputs i..j from state s, i = j - 2d + 1
        # after the round of d (Hillis-Steele); at the end, after inputs 0..j
        f = t['nst_by_input'][inb]                                   # (B, T, S)
        d = 1
        while d < T:
            f = torch.cat([f[:, :d], torch.gather(f[:, d:], 2, f[:, :-d])], dim=1)
            d *= 2
        state = torch.cat([inb.new_zeros((B, 1)), f[:, :-1, 0]], dim=1)[:, :T]   # before input j
        outs = t['obits'][state, inb]                                # (B, T, n)
        if code_type == 'rsc':
            final = f[:, -1, 0] if T else inb.new_zeros(B)
            ts, ti = t['term_states'][final], t['term_inputs'][final]     # (B, M)
            outs = torch.cat([outs, t['obits'][ts, ti]], dim=1)
        return outs.reshape(B, -1)

    return encode


DECODING_TYPES = ('hard', 'unquantized', 'tdist3', 'tdist5')


def make_viterbi(trellis: Trellis, decoding_type: str = 'unquantized') -> Callable:
    """received (B, T, n) float -> decoded (B, T) int32, on received's device.

    Hard decoding counts the code bits that differ from int(received)
    (truncation, as JAX's astype); the soft metrics sum d*d, log1p(d*d) or
    log1p(d*d/4) over the n symbols, d = received - (2*bit - 1). Path
    metrics start at 0 in state 0 and 1e9 elsewhere. Of a state's two
    predecessors the second wins only if its metric is strictly smaller,
    which is JAX's argmin keeping the first on a tie."""
    if decoding_type not in DECODING_TYPES:
        raise ValueError(f'unknown decoding type {decoding_type!r}')
    pred_state, pred_input = predecessors(trellis)
    tables = device_tables({'pred_state': pred_state, 'pred_input': pred_input,
                            'ideal': trellis.output_bits()[pred_state, pred_input]})  # (S, P, n)

    def branch_metrics(received, ideal):
        """(B, T, n) -> (B, T, S, P) f32."""
        r = received[:, :, None, None, :]
        if decoding_type == 'hard':
            return (r.to(torch.int32) != ideal).sum(-1).float()
        d = r - (2.0 * ideal - 1.0)
        if decoding_type == 'unquantized':
            return (d * d).sum(-1)
        if decoding_type == 'tdist3':
            return torch.log1p(d * d).sum(-1)
        return torch.log1p(d * d / 4.0).sum(-1)

    def decode(received: torch.Tensor) -> torch.Tensor:
        t = tables(received.device)
        B, T, _ = received.shape
        bm = branch_metrics(received.float(), t['ideal'])
        pm = torch.full((B, t['pred_state'].shape[0]), 1e9, device=received.device)
        pm[:, 0] = 0.0
        second = []
        for step in range(T):
            metrics = pm[:, t['pred_state']] + bm[:, step]          # (B, S, P)
            take = metrics[..., 1] < metrics[..., 0]
            pm = torch.where(take, metrics[..., 1], metrics[..., 0])
            pm = pm - pm.min(dim=-1, keepdim=True).values
            second.append(take)
        state = torch.zeros(B, dtype=torch.long, device=received.device)
        bits = []
        for take in reversed(second):
            j = take.gather(1, state[:, None])[:, 0].long()
            bits.append(t['pred_input'][state, j])
            state = t['pred_state'][state, j]
        return torch.stack(bits[::-1], dim=1).to(torch.int32)

    return decode
