"""DeepTurbo's encoder: the fixed classical turbo encoder on the device
(JAX: models/deepturbo.py:28-48; reference ENC_TurboCode, encoders.py:758-801).

Encoder keys 'Turbo_rate3_757' (M=2, G=[7,5], fb=7) and 'Turbo_rate3_lte'
(M=3, G=[13,11], fb=13). The encoder has no params. Its codes are BPSK
2c - 1 in f32 with no power constraint (encoders.py:767); `stats` passes
through. Under a mesh that shards time the trellis runs on the whole block
(dist/mesh.py:whole_time).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from ..classical.trellis import turbo757_trellis, turbo_lte_trellis
from ..classical.turbo import make_turbo_encoder
from ..dist import mesh as dm
from ..utils.logging import span


@lru_cache(maxsize=4)
def _cached_encoder(kind: str):
    return make_turbo_encoder(turbo_lte_trellis() if kind == 'lte' else turbo757_trellis())


def turbo_enc_init(gen: torch.Generator, cfg, device='cpu'):
    return {}


def turbo_enc_apply(params, cfg, x, perms, training=True, stats=None):
    """x (B, L, k) bits -> ((B, L, 3) codes [sys, par1, par2], stats). The
    trellis encoder's call is the span `trellis`."""
    encode = _cached_encoder('lte' if cfg.encoder == 'Turbo_rate3_lte' else '757')
    with span('trellis'):
        codes = dm.whole_time(
            lambda full: encode(torch.round(full[:, :, 0]).long(), perms['p1']).float(), x)
    return 2.0 * codes - 1.0, stats
