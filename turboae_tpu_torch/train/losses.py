"""The loss menu (JAX: train/losses.py:8-67, reference loss.py:30-109).

BCE clips the output to [eps, 1 - eps] with eps = 1e-7 (1e-10 would round
1 - eps to 1.0 in f32) and clamps each log at -100, which bounds the loss and
its gradient when the decoder saturates. F.binary_cross_entropy clamps the
logs but does not clip, so its gradient differs at saturated outputs; it is
not used.

The other losses, each as the JAX package computes it:
  soft_ber   mean((1 - o)^x * o^(1 - x));
  bce_rl     ber_lambda * mean((ber - mean(ber)) * bce) + bce_lambda * mean(bce),
             ber the hard decision errors;
  enc_rl     mean(ber * |code|), ber detached: the gradient reaches the
             encoder through the code only;
  bce_block  the mean over blocks of each block's largest BCE;
  focal      mean(focal_alpha * (1 - exp(-bce))^focal_gamma * bce);
  mse        mean((logit(o) - x)^2), o clipped at both tails;
  maxBCE     mean(bce) + lambda_maxBCE * max over positions of the
             batch-mean BCE;
  sortBCE    mean(bce) + lambda_maxBCE * the sum of the 5 largest of those
             positional means (torch.topk, JAX lax.top_k: PARITY.md "Known
             deltas").

Under a mesh (dist/mesh.py) each rank returns its share of the loss, and the
shares sum to the loss of the global batch: a batch mean becomes the rank's
mean over the world size, bce_rl's mean(ber) and the positional means of
maxBCE and sortBCE are global statistics, and the max or top 5 that every
rank takes of them counts once in the sum of the shares. Under a mesh that
shards time a rank holds its positions of every block: the positional means
are local, and the max or top 5 over positions, like bce_block's max over a
block, is taken of their gather along time (dist/mesh.py:gather_time).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..dist import mesh as dm

EPS = 1e-7


def bce_elementwise(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    o = torch.clamp(output, EPS, 1.0 - EPS)
    log_o = torch.clamp(torch.log(o), min=-100.0)
    log_1mo = torch.clamp(torch.log(1.0 - o), min=-100.0)
    return -(target * log_o + (1.0 - target) * log_1mo)


def _hard_errors(output: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (torch.round(output) != torch.round(target)).float()


def _mean(t: torch.Tensor) -> torch.Tensor:
    """The rank's share of the global batch's mean (the mean itself with no
    mesh): each rank holds as many rows."""
    return dm.share(torch.mean(t))


def customized_loss(output: torch.Tensor, target: torch.Tensor, cfg,
                    code: Optional[torch.Tensor] = None) -> torch.Tensor:
    """cfg.loss of the decoder's output (B, L, k) against the bits, a
    scalar; `code` is the encoder's output, which enc_rl needs."""
    output = torch.clamp(output, 0.0, 1.0)
    name = cfg.loss
    if name == 'bce':
        return _mean(bce_elementwise(output, target))
    if name == 'soft_ber':
        return _mean(((1.0 - output) ** target) * (output ** (1.0 - target)))
    if name == 'bce_rl':
        bce = bce_elementwise(output, target)
        ber = _hard_errors(output, target)
        return (cfg.ber_lambda * _mean((ber - dm.mean(ber)) * bce)
                + cfg.bce_lambda * _mean(bce))
    if name == 'enc_rl':
        if code is None:
            raise ValueError('loss enc_rl needs the code')
        return _mean(_hard_errors(output, target).detach() * torch.abs(code))
    if name == 'bce_block':
        return _mean(torch.amax(dm.gather_time(bce_elementwise(output, target)), dim=1))
    if name == 'focal':
        bce = bce_elementwise(output, target)
        pt = torch.exp(-bce)
        return _mean(cfg.focal_alpha * (1 - pt) ** cfg.focal_gamma * bce)
    if name == 'mse':
        o = torch.clamp(output, EPS, 1.0 - EPS)
        return _mean((torch.log(o / (1.0 - o)) - target) ** 2)
    if name in ('maxBCE', 'sortBCE'):
        bce = bce_elementwise(output, target)
        pos_loss = dm.gather_time(dm.mean(bce, dim=0), dim=0)
        if name == 'maxBCE':
            extra = torch.mean(torch.amax(pos_loss, dim=0))
        else:
            extra = torch.sum(torch.topk(pos_loss.reshape(-1), 5).values)
        return _mean(bce) + cfg.lambda_maxBCE * dm.share(extra)
    raise ValueError(f'unknown loss {name}')
