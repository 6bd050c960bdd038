"""Training and validation of the flagship (JAX: train/trainer.py:54-313).

One optimizer step of a phase (`_train_step`):
  sample bits and noise on the device -> forward_ae(training=True) -> BCE ->
  gradients of that phase's params only -> that phase's optimizer.
The 'encoder' phase steps the encoder's params, 'decoder' the decoder's,
'joint' both with their own optimizers. The frozen half is marked as needing
no gradient for the step, so autograd builds no graph for it, computes no
gradient of it and its optimizer does not run; gradients are returned by
torch.autograd.grad and never accumulate in `.grad`, so none leaks into the
next phase. Params and optimizer state are updated in place.

Eager PyTorch runs each step as it is called; losses stay on the device and
`train_epoch` synchronises once, at its end.

Tracing: with `trainer.marks` set to a list, each step appends a recorded
CUDA event after each of its phases ('sampled', 'forward', 'backward',
'optimizer'), behind a 'start' event; cli/profile_train.py reads the device
time between them. With `marks` None (the default) nothing is recorded.

Bits come from torch.rand on the device, noise from channels/noise.py, both
from one torch.Generator seeded with cfg.seed; the init draws from a CPU
generator with the same seed. The streams differ from jax.random's, so runs
agree with the JAX trainer in distribution, not in value.

Not ported yet (ROADMAP M14): variable block lengths, k-same-code batches,
several steps per call and precomputed norm stats raise NotImplementedError.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from ..channels.noise import generate_noise
from ..models.channel_ae import forward_ae, init_ae, make_perms
from ..utils.device import resolve_device
from ..utils.metrics import errors_ber
from ..utils.tree import tree_leaves, tree_map
from .losses import customized_loss
from .optimizers import make_optimizer

_HALVES = {'encoder': ('enc',), 'decoder': ('dec',), 'joint': ('enc', 'dec')}


def _refuse_unported(cfg):
    for unported, name in ((cfg.is_variable_block_len, 'is_variable_block_len'),
                           (cfg.is_k_same_code, 'is_k_same_code'),
                           (cfg.steps_per_call > 1, 'steps_per_call > 1'),
                           (cfg.precompute_norm_stats, 'precompute_norm_stats')):
        if unported:
            raise NotImplementedError(f'{name} is not ported yet (ROADMAP M14)')


class Trainer:
    def __init__(self, cfg, device='cuda', params=None):
        """params: a port param tree to start from (copied), else a seeded init."""
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.perms = make_perms(cfg, self.device)
        if params is None:
            params = init_ae(torch.Generator().manual_seed(cfg.seed), cfg, self.device)
        else:
            params = tree_map(lambda t: t.detach().to(self.device, torch.float32, copy=True),
                              params)
        self.params = params
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._leaves = {h: tree_leaves(params[h]) for h in ('enc', 'dec')}
        self.opt = {'enc': make_optimizer(cfg, cfg.enc_lr, self._leaves['enc']),
                    'dec': make_optimizer(cfg, cfg.dec_lr, self._leaves['dec'])}
        self.marks: Optional[List[Tuple[str, torch.cuda.Event]]] = None

    def _mark(self, name: str):
        if self.marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    # -------------------------------------------------------------
    def _sample_batch(self, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh bits and training noise; the encoder phase draws its noise in
        the encoder's SNR range, the others in the decoder's."""
        cfg, g, dev = self.cfg, self.generator, self.device
        bits = (torch.rand((cfg.batch_size, cfg.block_len, cfg.code_rate_k),
                           generator=g, device=dev) < 0.5).float()
        if mode == 'encoder':
            lo, hi = cfg.train_enc_channel_low, cfg.train_enc_channel_high
        else:
            lo, hi = cfg.train_dec_channel_low, cfg.train_dec_channel_high
        noise = generate_noise((cfg.batch_size, cfg.block_len, cfg.code_rate_n), cfg,
                               g, dev, snr_low=lo, snr_high=hi)
        return bits, noise

    def _loss(self, bits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        out, _, _ = forward_ae(self.params, self.cfg, bits, noise, self.perms,
                               training=True)
        return customized_loss(torch.clamp(out, 0.0, 1.0), bits, self.cfg)

    def loss_and_grads(self, mode: str, bits: torch.Tensor, noise: torch.Tensor
                       ) -> Tuple[torch.Tensor, Dict[str, List[torch.Tensor]]]:
        """The loss and the gradients of the phase's params, {half: [grad per
        leaf in tree_leaves order]}."""
        halves = _HALVES[mode]
        for h, leaves in self._leaves.items():
            for p in leaves:
                p.requires_grad_(h in halves)
        try:
            loss = self._loss(bits, noise)
            self._mark('forward')
            trainable = [p for h in halves for p in self._leaves[h]]
            grads = torch.autograd.grad(loss, trainable)
            self._mark('backward')
        finally:
            for leaves in self._leaves.values():
                for p in leaves:
                    p.requires_grad_(False)
        out, i = {}, 0
        for h in halves:
            n = len(self._leaves[h])
            out[h] = list(grads[i:i + n])
            i += n
        return loss.detach(), out

    def _train_step(self, mode: str, bits: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One optimizer step of `mode` on a fresh batch (or the one given);
        returns the loss as a device scalar."""
        if mode not in _HALVES:
            raise ValueError(f'mode must be one of {tuple(_HALVES)}, got {mode!r}')
        self._mark('start')
        if bits is None:
            bits, noise = self._sample_batch(mode)
        self._mark('sampled')
        loss, grads = self.loss_and_grads(mode, bits, noise)
        for h, g in grads.items():
            self.opt[h].step(g)
        self._mark('optimizer')
        return loss

    def train_epoch(self, epoch: int, mode: str = 'encoder', verbose: bool = True) -> float:
        """One epoch = num_block // batch_size steps; the mean loss."""
        cfg = self.cfg
        num_batches = max(1, cfg.num_block // cfg.batch_size)
        start = time.time()
        losses = [self._train_step(mode) for _ in range(num_batches)]
        avg = float(torch.stack(losses).mean())
        if verbose:
            print(f'====> Epoch: {epoch} Average loss: {avg:.8f}  running time',
                  time.time() - start)
        return avg

    # -------------------------------------------------------------
    @torch.no_grad()
    def _val_step(self):
        cfg, g, dev = self.cfg, self.generator, self.device
        bits = (torch.rand((cfg.batch_size, cfg.block_len, cfg.code_rate_k),
                           generator=g, device=dev) < 0.5).float()
        noise = generate_noise((cfg.batch_size, cfg.block_len, cfg.code_rate_n), cfg, g,
                               dev, snr_low=cfg.train_enc_channel_low,
                               snr_high=cfg.train_enc_channel_low)
        out, _, _ = forward_ae(self.params, cfg, bits, noise, self.perms, training=False)
        out = torch.clamp(out, 0.0, 1.0)
        bce = customized_loss(out, bits, cfg.replace(loss='bce'))
        custom = customized_loss(out, bits, cfg)
        return bce, custom, errors_ber(bits, out)

    def validate(self, verbose: bool = True) -> Tuple[float, float]:
        """Validation at the encoder's training SNR; (bce, ber)."""
        cfg = self.cfg
        n = max(1, int(cfg.num_block / cfg.batch_size * cfg.test_ratio))
        acc = [self._val_step() for _ in range(n)]
        bce, custom, ber = (float(torch.stack([a[i] for a in acc]).mean()) for i in range(3))
        if verbose:
            print('====> Test set BCE loss', bce, 'Custom Loss', custom, 'with ber ', ber)
        return bce, ber
