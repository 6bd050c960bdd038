"""Encoder -> channel -> decoder (JAX: models/channel_ae.py:23-72), and the
joint coding+modulation AE, encoder -> modulator -> AWGN -> demodulator ->
decoder (JAX :75-101).

`forward_ae(training=True)` is differentiable end to end: the power
constraint and its STE, the interleavers (index gathers) and the fused
decoder stacks (whose backward recomputes the unfused f32 stack) all carry
gradients to both halves of the params.

`generator` drives the fading channel's gain and then, in training, the
decoder's dropout (DEC_LargeRNN with cfg.dropout > 0), in that order: the
JAX forward splits its key between the same two (channel_ae.py:53-72).
Channels other than fading and decoders without dropout draw nothing."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from numpy.random import mtrand

from ..channels.apply import apply_channel
from ..ops.interleave import invert_perm
from ..ops.ste import rx_quantize
from ..utils.logging import span
from .decoders import make_decoder
from .encoders import make_encoder
from .modulation import demod_apply, demod_init, mod_apply, mod_init


def init_ae(gen: torch.Generator, cfg, device='cpu'):
    """{'enc': ..., 'dec': ...} at PyTorch's default init (JAX channel_ae.py:45-49),
    drawn from `gen` (a CPU generator), encoder first. A fixed encoder's
    half is empty ({})."""
    enc_init, _ = make_encoder(cfg)
    dec_init, _ = make_decoder(cfg)
    return {'enc': enc_init(gen, cfg, device), 'dec': dec_init(gen, cfg, device)}


def make_perms(cfg, device, block_len: Optional[int] = None,
               seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Interleaver permutations as the reference builds them (JAX
    channel_ae.py:24-43), at cfg.block_len or the block_len given.

    p1 and p2 are CONSECUTIVE draws from one MT19937 RandomState(seed), not
    the first draws of two seeds; seed defaults to 0 (the reference's
    is_same_interleaver), and variable block lengths draw one per length.
    Also holds their inverses p1_inv and p2_inv.
    """
    L = block_len or cfg.block_len
    if cfg.is_interleave == 0:
        p1 = p2 = np.arange(L)
    else:
        rand_gen = mtrand.RandomState(0 if seed is None else seed)
        p1 = rand_gen.permutation(np.arange(L))
        p2 = rand_gen.permutation(np.arange(L))
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return {'p1': as_t(p1), 'p2': as_t(p2), 'p1_inv': as_t(invert_perm(p1)),
            'p2_inv': as_t(invert_perm(p2))}


def forward_ae(params, cfg, bits, fwd_noise, perms, training: bool = True,
               stats=None, generator: Optional[torch.Generator] = None):
    """Returns (bit_estimates, codes, stats). Its phases are the spans
    `encode` (the power constraint included), `channel` and `decode`."""
    _, enc_apply = make_encoder(cfg)
    _, dec_apply = make_decoder(cfg)
    with span('encode'):
        codes, stats = enc_apply(params['enc'], cfg, bits, perms, training=training,
                                 stats=stats)
    with span('channel'):
        received = apply_channel(codes, fwd_noise, cfg.channel, generator)
        if cfg.rec_quantize:
            # the reference passes rec_quantize_level as BOTH limit and level
            received = rx_quantize(received, cfg.rec_quantize_level, cfg.rec_quantize_level)
    with span('decode'):
        out = dec_apply(params['dec'], cfg, received, perms, training=training,
                        generator=generator)
    return out, codes, stats


def init_mod_ae(gen: torch.Generator, cfg, device='cpu'):
    """{'enc', 'dec', 'mod', 'demod'}, drawn from `gen` in that order (JAX
    channel_ae.py:75-81)."""
    return {**init_ae(gen, cfg, device), 'mod': mod_init(gen, cfg, device),
            'demod': demod_init(gen, cfg, device)}


def forward_mod_ae(params, cfg, bits, fwd_noise, perms, training: bool = True,
                   stats=None, generator: Optional[torch.Generator] = None):
    """Returns (bit_estimates, symbols, stats). fwd_noise is (B, L * n /
    mod_rate, 2), added to the symbols: the AWGN family only, as in JAX
    (channel_ae.py:84-101)."""
    _, enc_apply = make_encoder(cfg)
    _, dec_apply = make_decoder(cfg)
    codes, stats = enc_apply(params['enc'], cfg, bits, perms, training=training, stats=stats)
    symbols = mod_apply(params['mod'], cfg, codes)
    received = symbols + fwd_noise
    if cfg.rec_quantize:
        received = rx_quantize(received, cfg.rec_quantize_level, cfg.rec_quantize_level)
    x_rec = demod_apply(params['demod'], cfg, received)
    out = dec_apply(params['dec'], cfg, x_rec, perms, training=training, generator=generator)
    return out, symbols, stats
