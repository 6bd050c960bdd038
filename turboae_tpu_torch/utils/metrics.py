"""Metrics: BER / BLER / positional BER / code power / SNR conversions
(JAX: turboae_tpu/utils/metrics.py; reference utils.py:6-76).

Decisions are the rounded probabilities. The sweep's error counts are exact
integers computed on the device (JAX train/trainer.py:417-424); the rate
helpers return f32 device scalars or vectors, as Trainer.test averages them.
Under a mesh (dist/mesh.py) the counts and the rates are those of the global
batch, on every rank alike. Under a mesh that shards time a rank holds its
positions of every block: the positional counts and rates are gathered along
time, and a block's error is an OR over the ranks (its per-rank error counts
all-reduced, then > 0).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..dist import mesh as dm


def snr_db2sigma(snr_db: float) -> float:
    """sigma = 10^(-snr/20) (JAX utils/metrics.py:64-67)."""
    return 10 ** (-snr_db / 20.0)


def snr_sigma2db(sigma: float) -> float:
    """snr = -20 log10(sigma) (JAX utils/metrics.py:71-75)."""
    return -20.0 * math.log10(sigma)


def f32_mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Mean as XLA computes it, the f32 sum times the f32 reciprocal of the
    count, so the port's rates equal the JAX package's bit for bit where the
    sums are exact (error counts). `dim`: None (all), an axis or a tuple."""
    if dim is None:
        return x.sum() * float(np.float32(1.0) / np.float32(x.numel()))
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n = math.prod(x.shape[d] for d in dims)
    return x.sum(dim=dims, keepdim=keepdim) * float(np.float32(1.0) / np.float32(n))


def _decisions(y_true: torch.Tensor, y_pred: torch.Tensor):
    """(rounded bits, rounded estimates), each (B, L*k)."""
    return (torch.round(y_true.reshape(y_true.shape[0], -1)),
            torch.round(y_pred.float().reshape(y_pred.shape[0], -1)))


def error_counts(bits: torch.Tensor, out: torch.Tensor):
    """Bit, block and positional error counts of one batch.

    bits, out: (B, L, k). Returns (bit_errors, block_errors, pos_errors) as
    int64 tensors on the input's device; pos_errors has length L*k.
    """
    t, p = _decisions(bits, out)
    err = t != p
    if dm.time_sharded():
        pos = dm.gather_time(err.sum(dim=0), dim=0)
        return pos.sum(), (dm.all_reduce(err.sum(dim=1)) > 0).sum(), pos
    counts = dm.all_reduce(torch.cat([err.sum(dim=0), err.any(dim=1).sum().reshape(1)]))
    pos = counts[:-1]
    return pos.sum(), counts[-1], pos


def wilson_ci(errors: int, n: int, z: float = 1.96):
    """95% Wilson interval from an exact error count (scripts/eval_flagship.py:24-34)."""
    if n == 0:
        return [0.0, 1.0]
    p_hat = errors / n
    denom = 1 + z * z / n
    center = (p_hat + z * z / (2 * n)) / denom
    half = z * math.sqrt(max(p_hat * (1 - p_hat) / n, 0)
                         + z * z / (4 * n * n)) / denom
    return [max(center - half, 0.0), center + half]


def two_proportion_z(e1: int, n1: int, e2: int, n2: int) -> float:
    """Pooled two-proportion z statistic of e1/n1 against e2/n2."""
    p = (e1 + e2) / (n1 + n2)
    se = math.sqrt(max(p * (1 - p) * (1 / n1 + 1 / n2), 1e-300))
    return (e1 / n1 - e2 / n2) / se


def errors_ber(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Mean disagreement of the rounded bits, a scalar tensor (JAX utils/metrics.py:13-17)."""
    t, p = _decisions(y_true, y_pred)
    return dm.batch_mean((t != p).float())


def errors_ber_pos(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Positional BER: the error rate of each position over the batch
    (JAX utils/metrics.py:41-45)."""
    t, p = _decisions(y_true, y_pred)
    return dm.gather_time(dm.batch_mean((t != p).float(), dim=0), dim=0)


def errors_ber_punctured(y_true: torch.Tensor, y_pred: torch.Tensor,
                         punc_mask: torch.Tensor) -> torch.Tensor:
    """BER with the punctured positions (mask 0) zeroed, then averaged over
    all positions, zeros included (JAX utils/metrics.py:20-30)."""
    return f32_mean(errors_ber_pos(y_true, y_pred) * punc_mask)


def errors_ber_list(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-block BER (JAX utils/metrics.py:33-38)."""
    t, p = _decisions(y_true, y_pred)
    return (t != p).sum(dim=1).float() / y_true.shape[1]


def code_power(codes: torch.Tensor) -> torch.Tensor:
    """Per-position mean |code|^2, over channels then batch (JAX utils/metrics.py:48-51)."""
    return dm.gather_time(dm.batch_mean(f32_mean(codes.float().abs() ** 2, dim=2), dim=0),
                          dim=0)


def errors_bler(y_true: torch.Tensor, y_pred: torch.Tensor,
                punc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of blocks with at least one bit error outside the punctured
    positions (JAX utils/metrics.py:54-61)."""
    t, p = _decisions(y_true, y_pred)
    err = (t - p).abs()
    if punc_mask is not None:
        s, e = dm.time_slice(err.shape[1])
        err = err * punc_mask[None, s:e]
    per_block = err.sum(dim=1)
    if dm.time_sharded():
        per_block = dm.all_reduce(per_block)
    return dm.batch_mean((per_block > 0).float())
