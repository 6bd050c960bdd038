"""What every plain reference shares: TF32 off, the fp8 e4m3 rounding of the
control, the reference repository's fixed interleaver (numpy's MT19937) and
the hard decisions' error counts."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

FP8_MAX = 448.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------ interleaver
def perms(block_len: int, device) -> Dict[str, torch.Tensor]:
    """p1 and its inverse: the first permutation MT19937 seeded 0 draws (the
    reference's fixed interleaver; p2, the second draw, is not used by the
    architectures here)."""
    p1 = np.random.RandomState(0).permutation(np.arange(block_len))
    inv = np.empty_like(p1)
    inv[p1] = np.arange(block_len)
    as_t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
    return {'p1': as_t(p1), 'p1_inv': as_t(inv)}


# -------------------------------------------------------------- precision
def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def quantizer(precision: str):
    """The rounding of every conv and head operand: none for 'f32' (the
    reference), float8 e4m3 with a per-tensor scale for 'fp8' (the
    control; the products are summed in f32)."""
    if precision == 'f32':
        return lambda t: t
    if precision == 'fp8':
        return _fp8
    raise ValueError(f'precision must be f32 or fp8, got {precision!r}')


def error_counts(bits: torch.Tensor, out: torch.Tensor) -> Tuple[int, int]:
    """(bit errors, block errors) of hard decisions round(out)."""
    err = torch.round(out.reshape(out.shape[0], -1)) != bits.reshape(bits.shape[0], -1)
    return int(err.sum()), int(err.any(dim=1).sum())
