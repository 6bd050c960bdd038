"""Classical turbo encoding and decoding (JAX: classical/turbo.py; reference
commpy/channelcoding/turbo.py:15-518).

Host: the port's own numpy copies of JAX's oracles. Two RSC encoders in
parallel, the second on the interleaved systematic stream, parity only,
termination trimmed; the standard iterative decoder and the benchmark's
`hazzys` variants, which subtract the weighted systematic LLR 2*y_s/sigma^2
from each extrinsic and decide from L_ext_1 + L_int_1 + weighted_sys
(`hazzys_g` also damps each extrinsic by 0.9*exp(-0.01*|L|)).

Device: `make_turbo_decoder` (JAX :140-195) iterates the batched log-BCJR
of bcjr.make_map_decoder with the interleaver as index tensors, and
`make_turbo_mc` (JAX :198-242) draws bits, turbo-encodes with
`make_turbo_encoder` (DeepTurbo's encoder too), adds BPSK and AWGN, decodes and counts errors, all on
the generator's device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.interleave import invert_perm
from .bcjr import make_map_decoder, map_decode
from .convcode import conv_encode, conv_encode_batch, make_encoder
from .trellis import Trellis, device_tables


def turbo_encode(msg_bits, trellis1: Trellis, trellis2: Trellis, interleaver):
    """[sys, par1, par2] streams (reference turbo.py:15-60)."""
    stream = conv_encode(msg_bits, trellis1, 'rsc')
    sys_stream = stream[::2]
    non_sys_stream_1 = stream[1::2]

    interlv_msg_bits = interleaver.interlv(sys_stream)
    non_sys_stream_2 = conv_encode(interlv_msg_bits, trellis2, 'rsc',
                                   puncture_matrix=np.array([[0, 1]]))

    M = trellis1.total_memory
    return [sys_stream[:-M], non_sys_stream_1[:-M], non_sys_stream_2[:-M]]


def turbo_encode_batch(msgs: np.ndarray, trellis: Trellis, p_array) -> np.ndarray:
    """Vectorized turbo encoder: (B, L) -> (B, L, 3) [sys, par1, par2].

    Matches turbo_encode per row. Note stream 2 re-encodes the interleaved
    *systematic output* (== message bits for these feedback codes since
    g[0][0]==feedback makes output 0 systematic)."""
    B, L = msgs.shape
    M = trellis.total_memory
    p_array = np.asarray(p_array)
    s1 = conv_encode_batch(msgs, trellis, 'rsc').reshape(B, L + M, 2)
    sys_full = s1[:, :, 0]
    par1 = s1[:, :, 1]
    # The reference interleaves the length-(L+M) sys stream with a length-L
    # p_array (turbo.py:52 with RandInterlv(block_len, 0)), i.e. fancy-indexing
    # that permutes the first L entries and DROPS the termination tail:
    inter = sys_full[:, p_array]
    s2 = conv_encode_batch(inter, trellis, 'rsc').reshape(B, L + M, 2)
    par2 = s2[:, :, 1]
    return np.stack([sys_full[:, :L], par1[:, :L], par2[:, :L]], axis=2)


def turbo_decode(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                 trellis: Trellis, noise_variance, number_iterations,
                 interleaver, L_int=None):
    """Standard iterative turbo decoder (reference turbo.py:262-341)."""
    if L_int is None:
        L_int = np.zeros(len(sys_symbols))
    L_int_1 = L_int
    sys_symbols_i = interleaver.interlv(sys_symbols)

    for it in range(number_iterations):
        L_ext_1, _ = map_decode(sys_symbols, non_sys_symbols_1, trellis,
                                noise_variance, L_int_1, 'compute')
        L_ext_1 = L_ext_1 - L_int_1
        L_int_2 = interleaver.interlv(L_ext_1)
        mode = 'decode' if it == number_iterations - 1 else 'compute'
        L_2, decoded_bits = map_decode(sys_symbols_i, non_sys_symbols_2,
                                       trellis, noise_variance, L_int_2, mode)
        L_ext_2 = L_2 - L_int_2
        L_int_1 = interleaver.deinterlv(L_ext_2)

    return interleaver.deinterlv(decoded_bits)


def hazzys_turbo_decode(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                        trellis: Trellis, noise_variance, number_iterations,
                        interleaver, L_int=None):
    """The benchmark's variant (reference turbo.py:346-428): subtracts the
    weighted systematic LLR 2*y_s/sigma^2 from each extrinsic, decides from
    L_ext_1 + L_int_1 + weighted_sys."""
    if L_int is None:
        L_int = np.zeros(len(sys_symbols))
    L_int_1 = L_int
    sys_symbols_i = interleaver.interlv(sys_symbols)
    weighted_sys = 2.0 * np.asarray(sys_symbols) / noise_variance

    for _ in range(number_iterations):
        L_ext_1, _ = map_decode(sys_symbols, non_sys_symbols_1, trellis,
                                noise_variance, L_int_1, 'compute')
        L_ext_1 = L_ext_1 - L_int_1 - weighted_sys
        L_int_2 = interleaver.interlv(L_ext_1)

        L_2, _ = map_decode(sys_symbols_i, non_sys_symbols_2, trellis,
                            noise_variance, L_int_2, 'compute')
        L_ext_2 = L_2 - L_int_2
        L_int_1 = interleaver.deinterlv(L_ext_2) - weighted_sys

    return (L_ext_1 + L_int_1 + weighted_sys > 0).astype(int)


def hazzys_g_turbo_decode(sys_symbols, non_sys_symbols_1, non_sys_symbols_2,
                          trellis: Trellis, noise_variance, number_iterations,
                          interleaver, L_int=None):
    """Damped hazzys variant (reference turbo.py:433-518): each extrinsic is
    attenuated by 0.9*exp(-0.01*|L|) before being passed on; decision from the
    *damped* L_ext_1 + L_int_1 + weighted_sys."""
    if L_int is None:
        L_int = np.zeros(len(sys_symbols))
    L_int_1 = L_int
    sys_symbols_i = interleaver.interlv(sys_symbols)
    weighted_sys = 2.0 * np.asarray(sys_symbols) / noise_variance

    for _ in range(number_iterations):
        L_ext_1, _ = map_decode(sys_symbols, non_sys_symbols_1, trellis,
                                noise_variance, L_int_1, 'compute')
        L_ext_1 = L_ext_1 - L_int_1 - weighted_sys
        L_ext_1 = L_ext_1 * 0.9 * np.exp(-0.01 * np.abs(L_ext_1))
        L_int_2 = interleaver.interlv(L_ext_1)

        L_2, _ = map_decode(sys_symbols_i, non_sys_symbols_2, trellis,
                            noise_variance, L_int_2, 'compute')
        L_ext_2 = L_2 - L_int_2
        L_ext_2 = L_ext_2 * 0.9 * np.exp(-0.01 * np.abs(L_ext_2))
        L_int_1 = interleaver.deinterlv(L_ext_2) - weighted_sys

    return (L_ext_1 + L_int_1 + weighted_sys > 0).astype(int)


VARIANTS = ('hazzys', 'hazzys_g', 'standard')


def make_turbo_encoder(trellis: Trellis) -> Callable:
    """fn(msgs (B, L) int, p (L,) int64 index tensor) -> (B, L, 3) int64 code
    bits [sys, par1, par2] on msgs' device: turbo_encode_batch with two
    passes of make_encoder(trellis, 'rsc'). The second encoder reads the
    length-(L+M) systematic stream gathered by the length-L permutation, so
    the termination tail is dropped (commpy interlv semantics)."""
    enc = make_encoder(trellis, 'rsc')
    M = trellis.total_memory

    def encode(msgs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        B, L = msgs.shape
        s1 = enc(msgs).reshape(B, L + M, 2)
        sys_full = s1[:, :, 0]
        s2 = enc(sys_full[:, p]).reshape(B, L + M, 2)
        return torch.stack([sys_full[:, :L], s1[:, :L, 1], s2[:, :L, 1]], dim=2)

    return encode


def _f32(x) -> float:
    """A Python float rounded to f32, as JAX's jit takes one."""
    return float(np.float32(x))


def make_turbo_decoder(trellis: Trellis, p_array, number_iterations: int,
                       variant: str = 'hazzys') -> Callable:
    """fn(sys (B, L), par1 (B, L), par2 (B, L), noise_variance float) ->
    bits (B, L) int32, on the inputs' device. 'hazzys' is
    hazzys_turbo_decode, 'hazzys_g' hazzys_g_turbo_decode, 'standard'
    turbo_decode, whose decision is the last iteration's decoder-2 posterior
    deinterleaved, carried out of the loop and not recomputed.

    fn.llr(...) takes the same arguments and returns the (B, L) f32 statistic
    that the bits are the sign of."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown turbo variant {variant!r}')
    map_dec = make_map_decoder(trellis)
    tables = device_tables({'p': p_array, 'inv': invert_perm(p_array)})
    hazzys = variant != 'standard'

    def damp(x):
        return x * 0.9 * torch.exp(-0.01 * x.abs())

    def llr(sys_symbols, par1, par2, noise_variance):
        t = tables(sys_symbols.device)
        p, inv = t['p'], t['inv']
        sys_symbols, par1, par2 = (x.float() for x in (sys_symbols, par1, par2))
        nv = _f32(noise_variance)
        sys_i = sys_symbols[:, p]
        weighted_sys = 2.0 * sys_symbols / nv
        L_int_1 = torch.zeros_like(sys_symbols)
        L_ext_1 = L_post_2 = L_int_1          # JAX's initial carry
        for _ in range(number_iterations):
            L_ext_1 = map_dec(sys_symbols, par1, nv, L_int_1) - L_int_1
            if hazzys:
                L_ext_1 = L_ext_1 - weighted_sys
            if variant == 'hazzys_g':
                L_ext_1 = damp(L_ext_1)
            L_int_2 = L_ext_1[:, p]
            L_post_2 = map_dec(sys_i, par2, nv, L_int_2)
            L_ext_2 = L_post_2 - L_int_2
            if variant == 'hazzys_g':
                L_ext_2 = damp(L_ext_2)
            L_int_1 = L_ext_2[:, inv]
            if hazzys:
                L_int_1 = L_int_1 - weighted_sys
        if hazzys:
            return L_ext_1 + L_int_1 + weighted_sys
        return L_post_2[:, inv]

    def decode(sys_symbols, par1, par2, noise_variance):
        return (llr(sys_symbols, par1, par2, noise_variance) > 0).to(torch.int32)

    decode.llr = llr
    return decode


def make_turbo_mc(trellis: Trellis, p_array, number_iterations: int,
                  variant: str = 'hazzys', batch: int = 4096) -> Callable:
    """fn(generator, sigma) -> (bit_errors, block_errors), int64 scalars on
    the generator's device: `batch` blocks of uniform bits turbo-encoded,
    sent as BPSK over AWGN of standard deviation sigma and decoded. The
    bits and the noise come from `generator` (a torch.Generator on the
    device), so a seeded generator repeats a run on the same device."""
    encode = make_turbo_encoder(trellis)
    dec = make_turbo_decoder(trellis, p_array, number_iterations, variant)
    L = len(p_array)
    tables = device_tables({'p': p_array})

    def step(generator: torch.Generator, sigma: float):
        dev = generator.device
        msgs = torch.randint(0, 2, (batch, L), generator=generator, device=dev)
        codes = encode(msgs, tables(dev)['p']).float()
        sigma = _f32(sigma)
        rx = 2.0 * codes - 1.0 + sigma * torch.randn(codes.shape, generator=generator, device=dev)
        bits = dec(rx[:, :, 0], rx[:, :, 1], rx[:, :, 2], _f32(np.float32(sigma) ** 2))
        err = bits != msgs
        return err.sum(), (err.sum(dim=1) > 0).sum()

    return step
