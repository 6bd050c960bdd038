"""Training loss (JAX: train/losses.py:8-25), BCE only.

BCE clips the output to [eps, 1 - eps] with eps = 1e-7 (1e-10 would round
1 - eps to 1.0 in f32) and clamps each log at -100, which bounds the loss and
its gradient when the decoder saturates. F.binary_cross_entropy clamps the
logs but does not clip, so its gradient differs at saturated outputs; it is
not used. The other losses of the JAX menu are not ported yet (M8).
"""
from __future__ import annotations

import torch

EPS = 1e-7


def bce_elementwise(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    o = torch.clamp(output, EPS, 1.0 - EPS)
    log_o = torch.clamp(torch.log(o), min=-100.0)
    log_1mo = torch.clamp(torch.log(1.0 - o), min=-100.0)
    return -(target * log_o + (1.0 - target) * log_1mo)


def customized_loss(output: torch.Tensor, target: torch.Tensor, cfg) -> torch.Tensor:
    """cfg.loss of the decoder's output against the bits, a scalar."""
    output = torch.clamp(output, 0.0, 1.0)
    if cfg.loss == 'bce':
        return torch.mean(bce_elementwise(output, target))
    raise NotImplementedError(f'loss {cfg.loss!r} is not ported yet (ROADMAP M8)')
