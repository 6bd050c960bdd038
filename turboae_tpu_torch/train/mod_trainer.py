"""The joint coding+modulation AE's training and test (JAX:
train/mod_trainer.py; reference mod_trainer.py:23-251).

Four phases, each stepping its own params with its own optimizer and
learning rate (JAX :23-43): 'encoder' the encoder (enc_lr), 'decoder' the
decoder (dec_lr), 'mod' the modulator (mod_lr), 'demod' the demodulator
(demod_lr). One optimizer step of a phase (`_train_step`): bits, noise in
symbol space (B, L * n / mod_rate, 2) at the phase's training SNR range
(the encoder's for 'encoder', the decoder's for the other three, JAX
:59-72) -> forward_mod_ae -> outputs clipped to [0, 1] -> cfg.loss with the
symbols as its code (JAX :74-79) -> gradients of the phase's params only ->
that phase's optimizer.

Bits and noise come from one torch.Generator on the device seeded with
cfg.seed; the init draws from a CPU generator of the same seed. The streams
differ from jax.random's, so runs agree with the JAX trainer in
distribution. `test` sweeps cfg's SNR points with fresh noise at
sigma(snr) and averages the per-batch BER and BLER (JAX :114-147). The
caller decides TF32.

With `mesh` (dist/mesh.py) the draws are the global batch's and each rank
keeps its rows, as in train/trainer.py. The batch axis is sharded whatever
cfg.shard_axis says, as JAX's trainer constrains P('data') here
(ftae_trainer.py:53-57, mod_trainer.py:49-53); the loss and gradients and the rates
are those of the global batch.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import torch

from ..channels.noise import generate_noise, sample_noise, spec_from_cfg
from ..models.channel_ae import forward_mod_ae, init_mod_ae
from ..utils import metrics as M
from ..utils.tree import tree_leaves
from .checkpoint import groups
from .losses import customized_loss
from .optimizers import make_optimizer
from .trainer import TrainerBase, on_mesh

PHASE_LR = {'encoder': 'enc_lr', 'decoder': 'dec_lr', 'mod': 'mod_lr', 'demod': 'demod_lr'}


class ModTrainer(TrainerBase):
    def __init__(self, cfg, device='cuda', params=None, mesh=None):
        """params: a port modulation-AE param tree to start from (copied),
        else a seeded init; mesh: the data-parallel mesh (dist/mesh.py) or None."""
        super().__init__(cfg, device, params, init_mod_ae, mesh, 'batch')
        self._leaves = {ph: tree_leaves(g) for ph, g in groups(self._params).items()}
        self.opt = {ph: make_optimizer(cfg, getattr(cfg, lr), self._leaves[ph])
                    for ph, lr in PHASE_LR.items()}

    def _sym_shape(self):
        cfg = self.cfg
        return (cfg.batch_size, cfg.block_len * cfg.code_rate_n // cfg.mod_rate, 2)

    def _sample(self, phase: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bits, symbol-space training noise) of a step of `phase`."""
        cfg = self.cfg
        bits = self._bits()
        if phase == 'encoder':
            lo, hi, mode = cfg.train_enc_channel_low, cfg.train_enc_channel_high, 'encoder'
        else:
            lo, hi, mode = cfg.train_dec_channel_low, cfg.train_dec_channel_high, 'decoder'
        noise = generate_noise(self._sym_shape(), cfg, self.generator, self.device,
                               snr_low=lo, snr_high=hi, mode=mode)
        return bits, noise

    def loss_and_grads(self, phase: str, bits: torch.Tensor, noise: torch.Tensor
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The loss and the gradients of the phase's params, in tree_leaves
        order of its group (checkpoint.groups), of the global batch given."""
        bits, noise = self._rows(bits, noise)

        def loss():
            out, sym, _ = forward_mod_ae(self.params, self.cfg, bits, noise, self.perms,
                                         training=True, generator=self.generator)
            return customized_loss(torch.clamp(out, 0.0, 1.0), bits, self.cfg, code=sym)
        return self._group_loss_and_grads(phase, loss)

    def _train_step(self, phase: str, bits=None, noise=None) -> torch.Tensor:
        """One optimizer step of `phase` on a fresh batch (or the one given)."""
        if phase not in PHASE_LR:
            raise ValueError(f'phase must be one of {tuple(PHASE_LR)}, got {phase!r}')
        if bits is None:
            bits, noise = self._sample(phase)
        loss, grads = self.loss_and_grads(phase, bits, noise)
        self.opt[phase].step(grads)
        return loss

    def train_epoch(self, epoch: int, phase: str = 'decoder', verbose: bool = True) -> float:
        """num_block // batch_size steps; the mean loss, synchronised once."""
        n = max(1, self.cfg.num_block // self.cfg.batch_size)
        start = time.time()
        losses = [self._train_step(phase) for _ in range(n)]
        avg = float(torch.stack(losses).mean())
        if verbose:
            print(f'====> Epoch: {epoch} [{phase}] Average loss: {avg:.8f}  running time',
                  time.time() - start)
        return avg

    @torch.inference_mode()
    @on_mesh
    def _eval_batch(self, sigma: float):
        bits = self._bits()
        noise = sample_noise(self._sym_shape(), spec_from_cfg(self.cfg), sigma, self.generator,
                             self.device)
        bits, noise = self._rows(bits, noise)
        out, _, _ = forward_mod_ae(self.params, self.cfg, bits, noise, self.perms,
                                   training=False, generator=self.generator)
        return M.errors_ber(bits, out), M.errors_bler(bits, out)

    def test(self, verbose: bool = True):
        """(snrs, ber, bler) over cfg's SNR points, per-batch rates averaged."""
        cfg = self.cfg
        n = max(1, cfg.num_block // cfg.batch_size)
        interval = (cfg.snr_test_end - cfg.snr_test_start) / max(1, cfg.snr_points - 1)
        snrs = [cfg.snr_test_start + interval * i for i in range(cfg.snr_points)]
        bers, blers = [], []
        for snr in snrs:
            sigma = M.snr_db2sigma(snr)
            acc = [self._eval_batch(sigma) for _ in range(n)]
            bers.append(float(M.f32_mean(torch.stack([a[0] for a in acc]))))
            blers.append(float(M.f32_mean(torch.stack([a[1] for a in acc]))))
            if verbose:
                print('Test SNR', snr, 'with ber ', bers[-1], 'with bler', blers[-1])
        if verbose:
            print('final results on SNRs ', snrs)
            print('BER', bers)
            print('BLER', blers)
        return snrs, bers, blers
