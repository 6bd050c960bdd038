"""FTAE's training, sweep and test (JAX: train/ftae_trainer.py).

One optimizer step of a phase (`_train_step`): bits, forward noise at the
phase's training SNR range (the encoder's or the decoder's, with the
phase's static bec/bsc probabilities) and feedback noise at
fb_channel_low..fb_channel_high (drawn as the decoder phase draws), all
(B, L, 3) -> forward_ftae -> outputs clipped to [0, 1] -> cfg.loss with the
codes -> gradients of the phase's params only -> that phase's optimizer.
The 'encoder' phase steps the forward encoders fwd_enc1-3, the 'decoder'
phase the feedback encoders and the decoder (JAX :26-27), each with its
own optimizer (train/optimizers.py).

Bits and noise come from one torch.Generator on the device seeded with
cfg.seed, drawn in the order bits, forward noise, feedback noise; the init
draws from a CPU generator of the same seed. The streams differ from
jax.random's, so runs agree with the JAX trainer in distribution.

`sweep` counts exact bit and block errors at each point's sigma, the
feedback noise at its training range, as JAX's sweep does; `test` averages
per-batch BER and BLER (JAX :184-207). The caller decides TF32.

With `mesh` (dist/mesh.py) the draws are the global batch's and each rank
keeps its rows, as in train/trainer.py. The batch axis is sharded whatever
cfg.shard_axis says, as JAX's trainer constrains P('data') here
(ftae_trainer.py:53-57, mod_trainer.py:49-53); the loss and gradients, the counts
and the rates are those of the global batch.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

from ..channels.noise import generate_noise, sample_noise, spec_from_cfg
from ..models.ftae import forward_ftae, init_ftae
from ..utils import metrics as M
from ..utils.tree import tree_leaves
from .checkpoint import groups
from .losses import customized_loss
from .optimizers import make_optimizer
from .trainer import TrainerBase, on_mesh

_MODES = {'encoder': 'enc', 'decoder': 'dec'}


class FTAETrainer(TrainerBase):
    def __init__(self, cfg, device='cuda', params=None, mesh=None):
        """params: a port FTAE param tree to start from (copied), else a
        seeded init; mesh: the data-parallel mesh (dist/mesh.py) or None."""
        super().__init__(cfg, device, params, init_ftae, mesh, 'batch')
        self._leaves = {h: tree_leaves(g) for h, g in groups(self._params).items()}
        self.opt = {'enc': make_optimizer(cfg, cfg.enc_lr, self._leaves['enc']),
                    'dec': make_optimizer(cfg, cfg.dec_lr, self._leaves['dec'])}

    # -------------------------------------------------------------
    def _shape(self):
        return (self.cfg.batch_size, self.cfg.block_len, 3)

    def _fb_noise(self) -> torch.Tensor:
        cfg = self.cfg
        return generate_noise(self._shape(), cfg, self.generator, self.device,
                              snr_low=cfg.fb_channel_low, snr_high=cfg.fb_channel_high,
                              mode='decoder')

    def _sample(self, mode: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(bits, forward noise, feedback noise) of a training step (JAX :49-66)."""
        cfg = self.cfg
        bits = self._bits()
        if mode == 'encoder':
            lo, hi = cfg.train_enc_channel_low, cfg.train_enc_channel_high
        else:
            lo, hi = cfg.train_dec_channel_low, cfg.train_dec_channel_high
        fwd = generate_noise(self._shape(), cfg, self.generator, self.device,
                             snr_low=lo, snr_high=hi, mode=mode)
        return bits, fwd, self._fb_noise()

    def loss_and_grads(self, mode: str, bits, fwd_noise, fb_noise
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The loss and the gradients of the phase's params, in tree_leaves
        order of its group (checkpoint.groups), of the global batch given."""
        bits, fwd_noise, fb_noise = self._rows(bits, fwd_noise, fb_noise)

        def loss():
            out, codes = forward_ftae(self.params, self.cfg, bits, fwd_noise, fb_noise,
                                      self.perms)
            return customized_loss(torch.clamp(out, 0.0, 1.0), bits, self.cfg, code=codes)
        return self._group_loss_and_grads(_MODES[mode], loss)

    def _train_step(self, mode: str, bits=None, fwd_noise=None, fb_noise=None) -> torch.Tensor:
        """One optimizer step of `mode` on a fresh batch (or the one given)."""
        if mode not in _MODES:
            raise ValueError(f'mode must be one of {tuple(_MODES)}, got {mode!r}')
        if bits is None:
            bits, fwd_noise, fb_noise = self._sample(mode)
        loss, grads = self.loss_and_grads(mode, bits, fwd_noise, fb_noise)
        self.opt[_MODES[mode]].step(grads)
        return loss

    def train_epoch(self, epoch: int, mode: str = 'encoder', verbose: bool = True) -> float:
        """num_block // batch_size steps; the mean loss, synchronised once."""
        n = max(1, self.cfg.num_block // self.cfg.batch_size)
        start = time.time()
        losses = [self._train_step(mode) for _ in range(n)]
        avg = float(torch.stack(losses).mean())
        if verbose:
            print(f'====> Epoch: {epoch} Average loss: {avg:.8f}  running time',
                  time.time() - start)
        return avg

    # -------------------------------------------------------------
    @torch.inference_mode()
    @on_mesh
    def _eval_batch(self, sigma: float):
        """(this rank's bits, its outputs) of a fresh global batch."""
        bits = self._bits()
        fwd = sample_noise(self._shape(), spec_from_cfg(self.cfg), sigma, self.generator,
                           self.device)
        bits, fwd, fb = self._rows(bits, fwd, self._fb_noise())
        out, _ = forward_ftae(self.params, self.cfg, bits, fwd, fb, self.perms)
        return bits, out

    @torch.inference_mode()
    @on_mesh
    def sweep(self, snrs, num_block: Optional[int] = None, verbose: bool = True) -> dict:
        """Exact bit and block error counts at each SNR (JAX :138-181):
        num_block // batch_size batches a point, the forward channel at
        sigma(snr), the feedback channel at its training range."""
        cfg = self.cfg
        num_batches = max(1, (num_block or cfg.num_block) // cfg.batch_size)
        res = {'snr': list(snrs), 'ber': [], 'bler': [], 'bit_errors': [], 'blk_errors': [],
               'n_bits': num_batches * cfg.batch_size * cfg.block_len * cfg.code_rate_k,
               'n_blocks': num_batches * cfg.batch_size}
        for snr in snrs:
            sigma = M.snr_db2sigma(snr)
            bit_e = torch.zeros((), dtype=torch.int64, device=self.device)
            blk_e = torch.zeros((), dtype=torch.int64, device=self.device)
            for _ in range(num_batches):
                be, ke, _ = M.error_counts(*self._eval_batch(sigma))
                bit_e += be
                blk_e += ke
            bit_e, blk_e = int(bit_e), int(blk_e)
            res['ber'].append(bit_e / res['n_bits'])
            res['bler'].append(blk_e / res['n_blocks'])
            res['bit_errors'].append(bit_e)
            res['blk_errors'].append(blk_e)
            if verbose:
                print(f'Test SNR {snr} with ber {res["ber"][-1]:.6e} ({bit_e} bit errs) '
                      f'with bler {res["bler"][-1]:.6e} ({blk_e} blk errs)', flush=True)
        return res

    @on_mesh
    def test(self, verbose: bool = True):
        """(snrs, ber, bler) over cfg's SNR points, per-batch rates averaged."""
        cfg = self.cfg
        n = max(1, cfg.num_block // cfg.batch_size)
        interval = (cfg.snr_test_end - cfg.snr_test_start) / max(1, cfg.snr_points - 1)
        snrs = [cfg.snr_test_start + interval * i for i in range(cfg.snr_points)]
        bers, blers = [], []
        for snr in snrs:
            sigma = M.snr_db2sigma(snr)
            acc = [(M.errors_ber(b, o), M.errors_bler(b, o))
                   for b, o in (self._eval_batch(sigma) for _ in range(n))]
            bers.append(float(M.f32_mean(torch.stack([a[0] for a in acc]))))
            blers.append(float(M.f32_mean(torch.stack([a[1] for a in acc]))))
            if verbose:
                print('Test SNR', snr, 'with ber ', bers[-1], 'with bler', blers[-1])
        if verbose:
            print('final results on SNRs ', snrs)
            print('BER', bers)
            print('BLER', blers)
        return snrs, bers, blers

