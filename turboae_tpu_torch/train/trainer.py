"""Training, validation and test of the flagship (JAX: train/trainer.py:54-629).

One optimizer step of a phase (`_train_step`):
  sample bits and noise on the device -> forward_ae(training=True) ->
  cfg.loss (train/losses.py) -> gradients of that phase's params only ->
  that phase's optimizer.
The 'encoder' phase steps the encoder's params, 'decoder' the decoder's,
'joint' both with their own optimizers. The frozen half is marked as needing
no gradient for the step, so autograd builds no graph for it, computes no
gradient of it and its optimizer does not run; gradients are returned by
torch.autograd.grad and never accumulate in `.grad`, so none leaks into the
next phase. Params and optimizer state are updated in place. A half with
no params (DeepTurbo's fixed encoder) has nothing to differentiate: its
phase computes the loss and steps an optimizer that only counts.

Eager PyTorch runs each step as it is called; losses stay on the device and
`train_epoch` synchronises once, at its end.

Tracing: with `trainer.marks` set to a list, each step appends a recorded
CUDA event after each of its phases ('sampled', 'forward', 'backward',
'optimizer'), behind a 'start' event; cli/profile_train.py reads the device
time between them. With `marks` None (the default) nothing is recorded.

Bits come from torch.rand on the device, noise from channels/noise.py and
the fading gain from channels/apply.py, all from one torch.Generator seeded
with cfg.seed; the init draws from a CPU generator with the same seed. The
streams differ from jax.random's, so runs agree with the JAX trainer in
distribution, not in value.

`trainer.params = tree` and `trainer.opt_state = state` copy into the
trainer's own tensors, which its optimizers hold, so a loaded checkpoint
(train/checkpoint.py) is assigned as in the JAX training scripts.

The caller decides TF32: library code sets no global flag (the CLIs turn it
off, utils/device.py:no_tf32).

Not ported yet (ROADMAP M14): variable block lengths, k-same-code batches,
several steps per call and precomputed norm stats raise NotImplementedError.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..channels.noise import (check_legacy_noise_channel, generate_noise, point_sigma,
                              sample_noise, spec_from_cfg)
from ..models.channel_ae import forward_ae, init_ae, make_perms
from ..models.encoders import make_encoder
from ..utils import metrics as M
from ..utils.device import resolve_device
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


class TrainerBase:
    """What every trainer shares: the config, the device, the interleavers,
    the params (a seeded init from a CPU generator, or a copy of the tree
    given), the device generator seeded with cfg.seed, and the params and
    optimizer state assigned by copy. A subclass sets `self._leaves`
    ({group: tree_leaves of its params}) and `self.opt` ({group: optimizer})."""

    def __init__(self, cfg, device, params, init):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.perms = make_perms(cfg, self.device)
        if params is None:
            params = init(torch.Generator().manual_seed(cfg.seed), cfg, self.device)
        else:
            params = tree_map(lambda t: t.detach().to(self.device, torch.float32, copy=True),
                              params)
        self._params = params
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, tree):
        """Copy a port param tree of the same shapes into the trainer's params."""
        new = tree_leaves(tree)
        old = tree_leaves(self._params)
        if len(new) != len(old) or any(a.shape != b.shape for a, b in zip(old, new)):
            raise ValueError('the params do not match the trainer\'s config')
        with torch.no_grad():
            for a, b in zip(old, new):
                a.copy_(b)

    @property
    def opt_state(self) -> Dict[str, dict]:
        """{group: optimizer.state()}, as train/checkpoint.py writes it."""
        return {h: o.state() for h, o in self.opt.items()}

    @opt_state.setter
    def opt_state(self, state: Dict[str, dict]):
        for h, s in state.items():
            self.opt[h].load_state(s)

    def _bits(self) -> torch.Tensor:
        cfg = self.cfg
        return (torch.rand((cfg.batch_size, cfg.block_len, cfg.code_rate_k),
                           generator=self.generator, device=self.device) < 0.5).float()

    def _group_loss_and_grads(self, group: str, loss_fn) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """loss_fn()'s value and its gradients of `group`'s params only, in
        their tree_leaves order; the other groups build no graph."""
        for h, leaves in self._leaves.items():
            for p in leaves:
                p.requires_grad_(h == group)
        try:
            loss = loss_fn()
            grads = torch.autograd.grad(loss, self._leaves[group], materialize_grads=True)
        finally:
            for leaves in self._leaves.values():
                for p in leaves:
                    p.requires_grad_(False)
        return loss.detach(), list(grads)


class Trainer(TrainerBase):
    def __init__(self, cfg, device='cuda', params=None):
        """params: a port param tree to start from (copied), else a seeded init."""
        _refuse_unported(cfg)
        super().__init__(cfg, device, params, init_ae)
        self._leaves = {h: tree_leaves(self._params[h]) for h in ('enc', 'dec')}
        self.opt = {'enc': make_optimizer(cfg, cfg.enc_lr, self._leaves['enc']),
                    'dec': make_optimizer(cfg, cfg.dec_lr, self._leaves['dec'])}
        self.marks: Optional[List[Tuple[str, torch.cuda.Event]]] = None
        self.last_test: Optional[dict] = None

    def _mark(self, name: str):
        if self.marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    # -------------------------------------------------------------
    def _noise_shape(self):
        return (self.cfg.batch_size, self.cfg.block_len, self.cfg.code_rate_n)

    def _sample_batch(self, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh bits and training noise; the encoder phase draws its noise in
        the encoder's SNR range (and at bec_p/bsc_p), the others in the
        decoder's (and at bec_p_dec/bsc_p_dec)."""
        cfg = self.cfg
        bits = self._bits()
        if mode == 'encoder':
            lo, hi = cfg.train_enc_channel_low, cfg.train_enc_channel_high
        else:
            lo, hi = cfg.train_dec_channel_low, cfg.train_dec_channel_high
        noise = generate_noise(self._noise_shape(), cfg, self.generator, self.device,
                               snr_low=lo, snr_high=hi, mode=mode)
        return bits, noise

    def _loss(self, bits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        out, code, _ = forward_ae(self.params, self.cfg, bits, noise, self.perms,
                                  training=True, generator=self.generator)
        return customized_loss(torch.clamp(out, 0.0, 1.0), bits, self.cfg, code=code)

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
            if not trainable:
                grads = ()
            elif loss.requires_grad:
                # a param the loss does not reach gets a zero gradient, as in
                # JAX (the decoder under enc_rl)
                grads = torch.autograd.grad(loss, trainable, materialize_grads=True)
            else:
                grads = [torch.zeros_like(p) for p in trainable]
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
        cfg = self.cfg
        bits = self._bits()
        noise = generate_noise(self._noise_shape(), cfg, self.generator, self.device,
                               snr_low=cfg.train_enc_channel_low,
                               snr_high=cfg.train_enc_channel_low)
        out, code, _ = forward_ae(self.params, cfg, bits, noise, self.perms, training=False,
                                  generator=self.generator)
        out = torch.clamp(out, 0.0, 1.0)
        bce = customized_loss(out, bits, cfg.replace(loss='bce'), code=code)
        custom = customized_loss(out, bits, cfg, code=code)
        return bce, custom, M.errors_ber(bits, out)

    def validate(self, verbose: bool = True) -> Tuple[float, float]:
        """Validation at the encoder's training SNR; (bce, ber)."""
        cfg = self.cfg
        n = max(1, int(cfg.num_block / cfg.batch_size * cfg.test_ratio))
        acc = [self._val_step() for _ in range(n)]
        bce, custom, ber = (float(torch.stack([a[i] for a in acc]).mean()) for i in range(3))
        if verbose:
            print('====> Test set BCE loss', bce, 'Custom Loss', custom, 'with ber ', ber)
        return bce, ber

    # -------------------------------------------------------------
    def _test_batch(self, sigma, fixed_unit: Optional[torch.Tensor] = None):
        """Fresh bits and fresh test noise at sigma, or under legacy noise
        fixed_unit scaled by sigma."""
        bits = self._bits()
        if fixed_unit is not None:
            return bits, sigma * fixed_unit
        return bits, sample_noise(self._noise_shape(), spec_from_cfg(self.cfg), sigma,
                                  self.generator, self.device)

    @torch.inference_mode()
    def _eval_batch(self, bits, noise, punc_mask: Optional[torch.Tensor] = None):
        """One test batch (JAX _eval_step/_eval_fixed, :315-350): (ber, bler,
        positional ber, code power); with a puncture mask (JAX _eval_punc,
        :352-366): (punctured ber, punctured bler)."""
        out, codes, _ = forward_ae(self.params, self.cfg, bits, noise, self.perms,
                                   training=False, generator=self.generator)
        if punc_mask is None:
            return (M.errors_ber(bits, out), M.errors_bler(bits, out),
                    M.errors_ber_pos(bits, out), M.code_power(codes))
        return (M.errors_ber_punctured(bits, out, punc_mask),
                M.errors_bler(bits, out, punc_mask))

    @torch.inference_mode()
    def encoder_power(self, num_batches: int) -> float:
        """Mean over batches of the encoder output's std, Bessel-corrected
        (JAX :510-529, reference trainer.py:238-248)."""
        _, enc_apply = make_encoder(self.cfg)
        total = 0.0
        for _ in range(num_batches):
            codes, _ = enc_apply(self.params['enc'], self.cfg, self._bits(), self.perms,
                                 training=False)
            codes = codes.float()
            total += float(torch.sqrt(((codes - codes.mean()) ** 2).sum() / (codes.numel() - 1)))
        return total / num_batches

    def test(self, verbose: bool = True):
        """SNR sweep -> (snrs, ber, bler) (JAX :531-629, reference trainer.py:135-248).

        Fresh noise per batch at the point's sigma (the raw probability for
        bec/bsc/ge); the per-batch BER and BLER averaged over num_block //
        batch_size batches. A second, punctured pass at each point zeroes the
        num_ber_puncture positions of highest BER in the first. Under
        cfg.legacy_noise the first pass scales one unit noise realization,
        drawn once, by each point's sigma (the punctured pass draws fresh
        noise, as in JAX). The punctured results and, when verbose, the
        encoder power are kept in self.last_test."""
        cfg = self.cfg
        num_batches = max(1, cfg.num_block // cfg.batch_size)
        interval = (cfg.snr_test_end - cfg.snr_test_start) / max(1, cfg.snr_points - 1)
        snrs = [cfg.snr_test_start + interval * i for i in range(cfg.snr_points)]
        if verbose:
            print('SNRS', snrs)
        fixed_unit = None
        if cfg.legacy_noise:
            check_legacy_noise_channel(cfg.channel)
            fixed_unit = sample_noise(self._noise_shape(), spec_from_cfg(cfg), 1.0,
                                      self.generator, self.device)
        ber_res, bler_res, ber_res_punc, bler_res_punc = [], [], [], []
        for snr in snrs:
            sigma = point_sigma(cfg, snr)
            acc = [self._eval_batch(*self._test_batch(sigma, fixed_unit))
                   for _ in range(num_batches)]
            tb = float(M.f32_mean(torch.stack([a[0] for a in acc])))
            tbl = float(M.f32_mean(torch.stack([a[1] for a in acc])))
            pos_ber = sum(a[2] for a in acc).cpu().numpy() / num_batches
            if cfg.print_pos_power and verbose:
                print('code power', sum(a[3] for a in acc).cpu().numpy() / num_batches)
            res_pos_arg = pos_ber.argsort()[::-1].tolist()
            if cfg.print_pos_ber and verbose:
                print('positional ber', pos_ber)
                print('positional argmax', res_pos_arg)

            # punctured second pass (reference trainer.py:194-213)
            punc_mask = np.ones(cfg.block_len, np.float32)
            punc_mask[res_pos_arg[:cfg.num_ber_puncture]] = 0.0
            mask = torch.from_numpy(punc_mask).to(self.device)
            accp = [self._eval_batch(*self._test_batch(sigma), punc_mask=mask)
                    for _ in range(num_batches)]
            tbp = float(M.f32_mean(torch.stack([a[0] for a in accp])))
            tblp = float(M.f32_mean(torch.stack([a[1] for a in accp])))
            if verbose:
                print('Test SNR', snr, 'with ber ', tb, 'with bler', tbl)
                print('Punctured Test SNR', snr, 'with ber ', tbp, 'with bler', tblp)
            ber_res.append(tb)
            bler_res.append(tbl)
            ber_res_punc.append(tbp)
            bler_res_punc.append(tblp)
        self.last_test = {'snrs': snrs, 'ber': ber_res, 'bler': bler_res,
                          'ber_punc': ber_res_punc, 'bler_punc': bler_res_punc}
        if verbose:
            print('final results on SNRs ', snrs)
            print('BER', ber_res)
            print('BLER', bler_res)
            print('final results on punctured SNRs ', snrs)
            print('BER', ber_res_punc)
            print('BLER', bler_res_punc)
            enc_power = self.encoder_power(num_batches)
            print('encoder power is', enc_power)
            adj_snrs = [M.snr_sigma2db(M.snr_db2sigma(s) / enc_power) for s in snrs]
            print('adjusted SNR should be', adj_snrs)
            self.last_test.update(encoder_power=enc_power, adjusted_snrs=adj_snrs)
        return snrs, ber_res, bler_res
