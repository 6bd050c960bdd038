"""The encoder's block power constraint (JAX: ops/power.py:42-80).

Whitens the whole code tensor with its global mean and Bessel-corrected
(ddof=1) standard deviation, optionally STE-binarizes, optionally truncates.
Under a mesh (dist/mesh.py) the statistics are those of the global batch, in
two passes with an all-reduce after each (JAX :7-11: the reference's
DataParallel took them per replica); the running NormStats see them too.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..dist import mesh as dm
from .ste import ste_quantize


class NormStats(NamedTuple):
    """Running mean/std for precomputed normalization (reference
    encoders.py:76-84, 110-114): under cfg.precompute_norm_stats,
    Trainer.precompute_norm_stats seeds them and Trainer.test threads them
    through every test batch; 0-d f32 tensors on the device."""
    mean: torch.Tensor
    std: torch.Tensor
    count: torch.Tensor


def init_norm_stats(device='cpu') -> NormStats:
    """mean 0, std 1, count 0 (JAX ops/power.py:31-32)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return NormStats(z, torch.ones((), dtype=torch.float32, device=device), z.clone())


def mean_std(x: torch.Tensor):
    """The mean and the Bessel-corrected std of the global batch."""
    m = dm.mean(x)
    return m, torch.sqrt(dm.batch_sum((x - m) ** 2) / (dm.batch_count(x) - 1))


def power_constraint(x: torch.Tensor, cfg, training: bool = True,
                     stats: Optional[NormStats] = None):
    """Returns (codes, stats)."""
    if cfg.no_code_norm:
        return x, stats

    this_mean, this_std = mean_std(x)
    if cfg.precompute_norm_stats and stats is not None:
        cnt = stats.count + 1.0
        new_mean = (stats.mean * (cnt - 1.0) + this_mean) / cnt
        new_std = (stats.std * (cnt - 1.0) + this_std) / cnt
        x_norm = (x - new_mean) / new_std
        stats = NormStats(new_mean, new_std, cnt)
    else:
        x_norm = (x - this_mean) / this_std

    # train_channel_mode is read whatever `training` is (JAX :64-72): an
    # STE-trained encoder sends binarized codes at evaluation too;
    # test_channel_mode overrides it only when set away from its default.
    mode = cfg.train_channel_mode
    if not training and cfg.test_channel_mode != 'block_norm':
        mode = cfg.test_channel_mode
    if mode == 'block_norm_ste':
        x_norm = ste_quantize(x_norm, cfg.enc_value_limit, cfg.enc_quantize_level,
                              cfg.enc_grad_limit, cfg.enc_clipping)

    if cfg.enc_truncate_limit > 0:
        x_norm = torch.clamp(x_norm, -cfg.enc_truncate_limit, cfg.enc_truncate_limit)
    return x_norm, stats
