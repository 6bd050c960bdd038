"""What the benchmark hands to the program and to the reference alike: each
unit's bits and noise, drawn on the device from --seed.

Every unit (a sweep batch) has a generator seeded from
(--seed, unit index), so any unit's inputs can be drawn again after the
window for the reference, and every seed gives the same sizes and the same
SNR schedule: only the draws differ.
"""
from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def unit_seed(seed: int, unit: int) -> int:
    """A 63-bit seed of (seed, unit), distinct for distinct pairs in practice."""
    x = (int(seed) * _MIX + int(unit) * 0xBF58476D1CE4E5B9 + 0x94D049BB133111EB) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & ((1 << 64) - 1)
    x ^= x >> 29
    return x & _MASK


def sigma(snr_db: float) -> float:
    return 10.0 ** (-snr_db / 20.0)


def draw(gen: torch.Generator, seed: int, unit: int, batch: int, block_len: int,
         snr_db, device):
    """(bits (B, L, 1) in {0, 1}, noise (B, L, 3)) of a unit at one SNR."""
    gen.manual_seed(unit_seed(seed, unit))
    bits = (torch.rand((batch, block_len, 1), generator=gen, device=device) < 0.5).float()
    noise = torch.randn((batch, block_len, 3), generator=gen, device=device)
    return bits, sigma(float(snr_db)) * noise


def program_config(arch: dict, **overrides):
    """The program's Config of a cell: the configuration file's keys that
    are Config fields, then the traffic's settings."""
    import dataclasses

    from turboae_tpu_torch.config import Config
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{**{k: v for k, v in arch.items() if k in fields}, **overrides, 'seed': 0})


def snr_grid(start: float, end: float, points: int):
    return [start + i * (end - start) / (points - 1) for i in range(points)] if points > 1 \
        else [start]

