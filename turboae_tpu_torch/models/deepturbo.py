"""DeepTurbo's encoder: the fixed classical turbo encoder on the device
(JAX: models/deepturbo.py:28-48; reference ENC_TurboCode, encoders.py:758-801).

Encoder keys 'Turbo_rate3_757' (M=2, G=[7,5], fb=7) and 'Turbo_rate3_lte'
(M=3, G=[13,11], fb=13). The encoder has no params. Its codes are BPSK
2c - 1 in f32 with no power constraint (encoders.py:767); `stats` passes
through.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..classical.convcode import make_encoder
from ..classical.trellis import turbo757_trellis, turbo_lte_trellis


@lru_cache(maxsize=4)
def _cached_encoder(kind: str):
    trellis = turbo_lte_trellis() if kind == 'lte' else turbo757_trellis()
    return make_encoder(trellis, 'rsc'), trellis.total_memory


def turbo_enc_init(gen: torch.Generator, cfg, device='cpu'):
    return {}


def turbo_enc_apply(params, cfg, x, perms, training=True, stats=None):
    """x (B, L, k) bits -> ((B, L, 3) codes [sys, par1, par2], stats)."""
    enc, M = _cached_encoder('lte' if cfg.encoder == 'Turbo_rate3_lte' else '757')
    B, L, _ = x.shape
    msgs = torch.round(x[:, :, 0]).long()
    s1 = enc(msgs).reshape(B, L + M, 2)
    sys_full = s1[:, :, 0]
    # the second encoder reads the length-(L+M) systematic stream gathered
    # by the length-L permutation: the tail is dropped (classical/turbo.py)
    s2 = enc(sys_full[:, perms['p1']]).reshape(B, L + M, 2)
    codes = torch.stack([sys_full[:, :L], s1[:, :L, 1], s2[:, :L, 1]], dim=2).float()
    return 2.0 * codes - 1.0, stats
