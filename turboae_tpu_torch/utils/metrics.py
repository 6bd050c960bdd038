"""Metrics of the evaluation sweep (JAX: turboae_tpu/utils/metrics.py).

Error counts are exact integers computed on the device: decisions are the
rounded probabilities, as in the JAX sweep (train/trainer.py:417-424).
"""
from __future__ import annotations

import math

import torch


def snr_db2sigma(snr_db: float) -> float:
    """sigma = 10^(-snr/20) (JAX utils/metrics.py:64-67)."""
    return 10 ** (-snr_db / 20.0)


def error_counts(bits: torch.Tensor, out: torch.Tensor):
    """Bit, block and positional error counts of one batch.

    bits, out: (B, L, k). Returns (bit_errors, block_errors, pos_errors) as
    int64 tensors on the input's device; pos_errors has length L*k.
    """
    t = torch.round(bits.reshape(bits.shape[0], -1))
    p = torch.round(out.float().reshape(out.shape[0], -1))
    err = t != p
    pos = err.sum(dim=0)
    return pos.sum(), err.any(dim=1).sum(), pos


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


def errors_ber(bits: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Mean disagreement of the rounded bits, a scalar tensor (JAX utils/metrics.py:13-17)."""
    t = torch.round(bits.reshape(bits.shape[0], -1))
    p = torch.round(out.float().reshape(out.shape[0], -1))
    return (t != p).float().mean()
