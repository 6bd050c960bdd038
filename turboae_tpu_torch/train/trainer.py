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

The Config's training extras, as JAX's trainer honours them (:167-262):
  - is_variable_block_len: each step draws its length from `vbl_buckets`
    (np.random.RandomState(cfg.seed).choice) and runs at it; the first step
    of a (phase, length) draws that pair's interleaver seed from the same
    RandomState (randint(0, max(1, is_interleave))), as JAX draws one per
    compiled step. It takes precedence over the other two;
  - is_k_same_code: in the encoder phase one bits tensor serves k_same_code
    consecutive steps; noise and the fading gain are drawn every step;
  - steps_per_call n > 1: divmod(num_batches, n) groups of n steps, each one
    replay of a CUDA graph captured once per (phase, n), then the rest eagerly.
    The capture follows one eager warm-up step on a side stream whose every
    effect (params, optimizer state, generator) is put back, so the replays
    draw what n eager steps would draw. The trainer's generator is registered
    with each graph; the optimizers read their count-dependent values from
    rows staged on the device per replay (train/optimizers.py). A capture that
    fails raises. On the CPU the n steps run eagerly;
  - precompute_norm_stats: `test` first runs `precompute_norm_stats` and
    threads the running mean and std through every batch of both passes.

Data and sequence parallelism: with `mesh` (dist/mesh.py, one process a
rank) every draw is made at the global batch from the generator every rank
seeds alike, and each rank keeps its share along cfg.shard_axis: its blocks
('batch', JAX's P('data')) or its positions of every block ('time', JAX's
P(None, 'data'), trainer.py:95-106), whose length the data axis must divide.
The loss each rank differentiates is its share (train/losses.py) and the
statistics of the forward are global; the gradients and the loss are summed
over the data group in one all-reduce a step, before the optimizers step,
so every rank steps alike and reports what the 1-rank run with that seed
reports (the replicas of a 2-D mesh do the same arithmetic, bit for bit).
`loss_and_grads`, `_train_step` and `_eval_batch` take the global batch.
steps_per_call > 1 under a mesh is captured only under NCCL (gloo's
collectives cannot be captured).

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
"""
from __future__ import annotations

import functools
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..channels.noise import (check_legacy_noise_channel, generate_noise, point_sigma,
                              sample_noise, spec_from_cfg)
from ..dist import mesh as dm
from ..kernels import conv_stack as ks
from ..models.channel_ae import forward_ae, init_ae, make_perms
from ..models.encoders import make_encoder
from ..ops.power import init_norm_stats, mean_std
from ..utils import metrics as M
from ..utils.device import resolve_device
from ..utils.tree import tree_leaves, tree_map
from .losses import customized_loss
from .optimizers import make_optimizer

_HALVES = {'encoder': ('enc',), 'decoder': ('dec',), 'joint': ('enc', 'dec')}


def on_mesh(method):
    """Run a trainer method with the trainer's mesh in effect (dist/mesh.py)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with dm.active(self.mesh):
            return method(self, *args, **kwargs)
    return run


def vbl_buckets(cfg, n_buckets: int = 8) -> List[int]:
    """[block_len_low, block_len_high) cut into at most n_buckets lengths
    (JAX trainer.py:191-197)."""
    lo, hi = cfg.block_len_low, cfg.block_len_high
    return sorted(set(np.linspace(lo, hi - 1, n_buckets).astype(int).tolist()))


class TrainerBase:
    """What every trainer shares: the config, the device, the interleavers,
    the params (a seeded init from a CPU generator, or a copy of the tree
    given), the device generator seeded with cfg.seed, and the params and
    optimizer state assigned by copy, and the mesh, if any, sharding
    `shard_axis` (whose length it must divide). A subclass sets
    `self._leaves` ({group: tree_leaves of its params}) and `self.opt`
    ({group: optimizer})."""

    def __init__(self, cfg, device, params, init, mesh=None, shard_axis='batch'):
        mesh = dm.along(mesh, shard_axis)
        if mesh is not None:
            name, n = (('block_len', cfg.block_len) if shard_axis == 'time'
                       else ('batch_size', cfg.batch_size))
            if n % mesh.size:
                raise ValueError(f'{name} {n} does not split over {mesh.size} ranks')
        self.cfg = cfg
        self.mesh = mesh
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

    def _bits(self, cfg=None) -> torch.Tensor:
        cfg = cfg or self.cfg
        return (torch.rand((cfg.batch_size, cfg.block_len, cfg.code_rate_k),
                           generator=self.generator, device=self.device) < 0.5).float()

    def _rows(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """This rank's share of each global batch tensor along the mesh's axis."""
        return tuple(dm.shard_rows(t, self.mesh) for t in tensors)

    def _summed(self, loss: torch.Tensor, grads) -> torch.Tensor:
        """The loss and the gradients (in place) summed over the data group,
        in one all-reduce; the loss as it is with no mesh."""
        if self.mesh is None:
            return loss
        loss = loss.reshape(1).clone()
        dm.all_reduce_([*grads, loss], self.mesh)
        return loss[0]

    @on_mesh
    def _group_loss_and_grads(self, group: str, loss_fn) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """loss_fn()'s value and its gradients of `group`'s params only, in
        their tree_leaves order; the other groups build no graph. Under a mesh
        loss_fn gives this rank's share, and both come back summed over the
        ranks."""
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
        grads = list(grads)
        return self._summed(loss.detach(), grads), grads


class Trainer(TrainerBase):
    def __init__(self, cfg, device='cuda', params=None, mesh=None):
        """params: a port param tree to start from (copied), else a seeded
        init; mesh: the mesh (dist/mesh.py) or None, sharding
        cfg.shard_axis."""
        super().__init__(cfg, device, params, init_ae, mesh, cfg.shard_axis)
        self._leaves = {h: tree_leaves(self._params[h]) for h in ('enc', 'dec')}
        self.opt = {'enc': make_optimizer(cfg, cfg.enc_lr, self._leaves['enc']),
                    'dec': make_optimizer(cfg, cfg.dec_lr, self._leaves['dec'])}
        self.marks: Optional[List[Tuple[str, torch.cuda.Event]]] = None
        self.last_test: Optional[dict] = None
        self.norm_stats = None
        # variable block lengths and their interleaver seeds, drawn on the host
        self._np_rng = np.random.RandomState(cfg.seed)
        self.vbl_seeds: Dict[Tuple[str, int], int] = {}
        self._vbl: Dict[Tuple[str, int], tuple] = {}
        self._graphs: Dict[tuple, '_StepGraph'] = {}

    def _mark(self, name: str):
        if self.marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    # -------------------------------------------------------------
    def _noise_shape(self, cfg=None):
        cfg = cfg or self.cfg
        return (cfg.batch_size, cfg.block_len, cfg.code_rate_n)

    def _noise(self, mode: str, cfg=None) -> torch.Tensor:
        """Training noise; the encoder phase draws it in the encoder's SNR
        range (and at bec_p/bsc_p), the others in the decoder's (and at
        bec_p_dec/bsc_p_dec)."""
        cfg = cfg or self.cfg
        if mode == 'encoder':
            lo, hi = cfg.train_enc_channel_low, cfg.train_enc_channel_high
        else:
            lo, hi = cfg.train_dec_channel_low, cfg.train_dec_channel_high
        return generate_noise(self._noise_shape(cfg), cfg, self.generator, self.device,
                              snr_low=lo, snr_high=hi, mode=mode)

    def _vbl_step_cfg(self, mode: str, block_len: int):
        """(cfg at block_len, its perms); the first call for (mode, length)
        draws the interleaver seed (JAX trainer.py:200-222)."""
        key = (mode, block_len)
        if key not in self._vbl:
            seed = int(self._np_rng.randint(0, max(1, self.cfg.is_interleave)))
            cfg_l = self.cfg.replace(block_len=block_len)
            self.vbl_seeds[key] = seed
            self._vbl[key] = (cfg_l, make_perms(cfg_l, self.device, block_len, seed))
        return self._vbl[key]

    def _loss(self, bits: torch.Tensor, noise: torch.Tensor, cfg=None, perms=None
              ) -> torch.Tensor:
        cfg = cfg or self.cfg
        out, code, _ = forward_ae(self.params, cfg, bits, noise,
                                  self.perms if perms is None else perms,
                                  training=True, generator=self.generator)
        return customized_loss(torch.clamp(out, 0.0, 1.0), bits, cfg, code=code)

    @on_mesh
    def loss_and_grads(self, mode: str, bits: torch.Tensor, noise: torch.Tensor,
                       cfg=None, perms=None
                       ) -> Tuple[torch.Tensor, Dict[str, List[torch.Tensor]]]:
        """The loss and the gradients of the phase's params, {half: [grad per
        leaf in tree_leaves order]}, of the global batch (bits, noise); cfg
        and perms default to the trainer's."""
        halves = _HALVES[mode]
        bits, noise = self._rows(bits, noise)
        for h, leaves in self._leaves.items():
            for p in leaves:
                p.requires_grad_(h in halves)
        try:
            loss = self._loss(bits, noise, cfg, perms)
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
        grads = list(grads)
        loss = self._summed(loss.detach(), grads)
        out, i = {}, 0
        for h in halves:
            n = len(self._leaves[h])
            out[h] = grads[i:i + n]
            i += n
        return loss, out

    def _train_step(self, mode: str, bits: Optional[torch.Tensor] = None,
                    noise: Optional[torch.Tensor] = None,
                    block_len: Optional[int] = None) -> torch.Tensor:
        """One optimizer step of `mode`, at block_len's cfg and perms when
        given; what of the batch is not given is drawn fresh, bits first.
        Returns the loss as a device scalar."""
        if mode not in _HALVES:
            raise ValueError(f'mode must be one of {tuple(_HALVES)}, got {mode!r}')
        cfg, perms = self._vbl_step_cfg(mode, block_len) if block_len else (None, None)
        self._mark('start')
        if bits is None:
            bits = self._bits(cfg)
        if noise is None:
            noise = self._noise(mode, cfg)
        self._mark('sampled')
        loss, grads = self.loss_and_grads(mode, bits, noise, cfg, perms)
        for h, g in grads.items():
            self.opt[h].step(g)
        self._mark('optimizer')
        return loss

    def _train_steps(self, mode: str, n: int, groups: int) -> List[torch.Tensor]:
        """`groups` runs of n steps, each a (n,) tensor of losses: one replay
        of the (mode, n) CUDA graph each on the card, n eager steps on the CPU."""
        if self.mesh is not None and self.mesh.backend != 'nccl':
            raise RuntimeError(f'steps_per_call > 1 under a {self.mesh.backend} mesh: its '
                               'collectives cannot be captured in a CUDA graph (use NCCL, '
                               'or steps_per_call 1)')
        if self.device.type != 'cuda':
            return [torch.stack([self._train_step(mode) for _ in range(n)])
                    for _ in range(groups)]
        key = (mode, n, self.cfg)
        if key not in self._graphs:
            self._graphs[key] = _StepGraph(self, mode, n)
        return self._graphs[key].run(groups)

    def train_epoch(self, epoch: int, mode: str = 'encoder', verbose: bool = True) -> float:
        """One epoch = num_block // batch_size steps; the mean loss."""
        cfg = self.cfg
        num_batches = max(1, cfg.num_block // cfg.batch_size)
        start = time.time()
        if cfg.is_variable_block_len:
            buckets = vbl_buckets(cfg)
            losses = [self._train_step(mode, block_len=int(self._np_rng.choice(buckets)))
                      for _ in range(num_batches)]
        elif cfg.is_k_same_code and mode == 'encoder':
            losses = []
            for i in range(num_batches):
                if i % cfg.k_same_code == 0:
                    bits = self._bits()
                losses.append(self._train_step(mode, bits=bits))
        elif cfg.steps_per_call > 1:
            groups, rem = divmod(num_batches, cfg.steps_per_call)
            losses = self._train_steps(mode, cfg.steps_per_call, groups) if groups else []
            losses += [self._train_step(mode) for _ in range(rem)]
        else:
            losses = [self._train_step(mode) for _ in range(num_batches)]
        avg = float(torch.cat([l.reshape(-1) for l in losses]).mean())
        if verbose:
            print(f'====> Epoch: {epoch} Average loss: {avg:.8f}  running time',
                  time.time() - start)
        return avg

    # -------------------------------------------------------------
    @torch.no_grad()
    @on_mesh
    def _val_step(self):
        cfg = self.cfg
        bits = self._bits()
        noise = generate_noise(self._noise_shape(), cfg, self.generator, self.device,
                               snr_low=cfg.train_enc_channel_low,
                               snr_high=cfg.train_enc_channel_low)
        bits, noise = self._rows(bits, noise)
        out, code, _ = forward_ae(self.params, cfg, bits, noise, self.perms, training=False,
                                  generator=self.generator)
        out = torch.clamp(out, 0.0, 1.0)
        # the losses' shares, summed over the ranks
        bce, custom = dm.all_reduce(torch.stack([
            customized_loss(out, bits, cfg.replace(loss='bce'), code=code),
            customized_loss(out, bits, cfg, code=code)]))
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
    @on_mesh
    def _eval_batch(self, bits, noise, punc_mask: Optional[torch.Tensor] = None,
                    stats=None):
        """One test batch (JAX _eval_step/_eval_fixed, :315-350): ((ber, bler,
        positional ber, code power), stats); with a puncture mask (JAX
        _eval_punc, :352-366): ((punctured ber, punctured bler), stats).
        `stats`, the precomputed norm stats, come back updated by the batch.
        bits and noise are the global batch."""
        bits, noise = self._rows(bits, noise)
        out, codes, stats = forward_ae(self.params, self.cfg, bits, noise, self.perms,
                                       training=False, stats=stats, generator=self.generator)
        if punc_mask is None:
            return (M.errors_ber(bits, out), M.errors_bler(bits, out),
                    M.errors_ber_pos(bits, out), M.code_power(codes)), stats
        return (M.errors_ber_punctured(bits, out, punc_mask),
                M.errors_bler(bits, out, punc_mask)), stats

    @torch.inference_mode()
    @on_mesh
    def precompute_norm_stats(self):
        """The encoder over n = max(1, int(num_block / batch_size * test_ratio))
        batches of fresh bits, accumulating the running mean and std of its
        codes (JAX :484-508, reference trainer.py:146-153); kept, on the
        device, in self.norm_stats."""
        cfg = self.cfg
        _, enc_apply = make_encoder(cfg)
        stats = init_norm_stats(self.device)
        for _ in range(max(1, int(cfg.num_block / cfg.batch_size * cfg.test_ratio))):
            _, stats = enc_apply(self.params['enc'], cfg, *self._rows(self._bits()), self.perms,
                                 training=False, stats=stats)
        self.norm_stats = stats
        print('Pre-computed norm statistics mean ', float(stats.mean),
              'std ', float(stats.std))
        return stats

    @torch.inference_mode()
    @on_mesh
    def encoder_power(self, num_batches: int) -> float:
        """Mean over batches of the encoder output's std, Bessel-corrected
        (JAX :510-529, reference trainer.py:238-248)."""
        _, enc_apply = make_encoder(self.cfg)
        total = 0.0
        for _ in range(num_batches):
            codes, _ = enc_apply(self.params['enc'], self.cfg, *self._rows(self._bits()),
                                 self.perms, training=False)
            total += float(mean_std(codes.float())[1])
        return total / num_batches

    def test(self, verbose: bool = True):
        """SNR sweep -> (snrs, ber, bler) (JAX :531-629, reference trainer.py:135-248).

        Fresh noise per batch at the point's sigma (the raw probability for
        bec/bsc/ge); the per-batch BER and BLER averaged over num_block //
        batch_size batches. A second, punctured pass at each point zeroes the
        num_ber_puncture positions of highest BER in the first. Under
        cfg.legacy_noise the first pass scales one unit noise realization,
        drawn once, by each point's sigma (the punctured pass draws fresh
        noise, as in JAX). Under cfg.precompute_norm_stats the norm stats of
        `precompute_norm_stats` go on accumulating through every batch of
        both passes (reference encoders.py:110-114). The punctured results
        and, when verbose, the encoder power are kept in self.last_test."""
        cfg = self.cfg
        stats = self.precompute_norm_stats() if cfg.precompute_norm_stats else None
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
            acc = []
            for _ in range(num_batches):
                a, stats = self._eval_batch(*self._test_batch(sigma, fixed_unit), stats=stats)
                acc.append(a)
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
            accp = []
            for _ in range(num_batches):
                a, stats = self._eval_batch(*self._test_batch(sigma), punc_mask=mask,
                                            stats=stats)
                accp.append(a)
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


_KERNELS = (ks.conv_stack_bf16, ks.conv_stack_f32)


def _cloned(state):
    """An optimizer's state() with every tensor copied."""
    if isinstance(state, dict):
        return {k: _cloned(v) for k, v in state.items()}
    if isinstance(state, list):
        return [t.clone() for t in state]
    return state


class _StepGraph:
    """n optimizer steps of one phase, captured as one CUDA graph (JAX's
    _multi_step, trainer.py:167-189).

    The graph holds the addresses of the trainer's params and optimizer
    state, which every step updates in place, and of `staged`, whose row i
    holds step i's count-dependent optimizer values; `run` copies each
    replay's rows there first, and empties the wrappers' cache of packed
    weights (kernels/conv_stack.py:clear_packs), which a replay's writes
    would leave stale. A wrapper counts its kernel's launches when
    called, which under capture launches nothing: the launches of the
    capture are taken back and added once for every replay.

    A graph destroyed while another is being captured breaks that capture,
    and Python's cycle collector may run at any allocation: the graph holds
    no reference back to its trainer, so that it goes when the trainer
    goes, and the collector is run before a capture and paused during it."""

    def __init__(self, trainer: Trainer, mode: str, n: int):
        if trainer.marks is not None:
            raise RuntimeError('trainer.marks records CUDA events, which a captured graph '
                               'cannot hold: set marks to None with steps_per_call > 1')
        self.n, self.device = n, trainer.device
        self.opts = [trainer.opt[h] for h in _HALVES[mode]]
        self.cols = np.cumsum([0] + [o.staged(1).shape[1] for o in self.opts]).tolist()
        self.staged = torch.zeros((n, max(1, self.cols[-1])), dtype=torch.float32,
                                  device=self.device)
        self.losses = torch.zeros(n, dtype=torch.float32, device=self.device)
        self._warm_up(trainer, mode)
        before = [k.launches for k in _KERNELS]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(trainer.generator)
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph):
                for i in range(n):
                    for o, a, b in zip(self.opts, self.cols, self.cols[1:]):
                        o.slot = self.staged[i, a:b]
                    self.losses[i].copy_(trainer._train_step(mode))
        finally:
            gc.enable()
            for o in self.opts:     # the capture ran no step
                o.slot = None
                o.advance(-n)
            self.launches = [k.launches - b for k, b in zip(_KERNELS, before)]
            for k, b in zip(_KERNELS, before):
                k.launches = b

    def _warm_up(self, tr: Trainer, mode: str):
        """One eager step on a side stream, so that what a first step sets
        up (the kernels' build and load, library handles and workspaces)
        happens outside the capture; then every effect of it but its
        kernels' launches, which did run, is put back."""
        params = [p.clone() for leaves in tr._leaves.values() for p in leaves]
        states = [_cloned(o.state()) for o in self.opts]
        gen = tr.generator.get_state()
        cur = torch.cuda.current_stream(tr.device)
        side = torch.cuda.Stream(tr.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            tr._train_step(mode)
        cur.wait_stream(side)
        torch.cuda.synchronize(tr.device)
        with torch.no_grad():
            for p, q in zip((p for leaves in tr._leaves.values() for p in leaves), params):
                p.copy_(q)
        for o, st in zip(self.opts, states):
            o.load_state(st)
        tr.generator.set_state(gen)

    def run(self, groups: int) -> List[torch.Tensor]:
        """`groups` replays; the (n,) losses of each."""
        width = self.cols[-1]
        if width:
            rows = np.concatenate([o.staged(self.n * groups) for o in self.opts], axis=1)
            rows = torch.from_numpy(rows.reshape(groups, self.n, width)).pin_memory()
            rows = rows.to(self.device, non_blocking=True)
        # the replays write the params and bump no _version: packs kept of
        # them before (an evaluation in inference mode) would be stale
        ks.clear_packs()
        out = []
        for g in range(groups):
            if width:
                self.staged.copy_(rows[g])
            self.graph.replay()
            for o in self.opts:
                o.advance(self.n)
            for k, n in zip(_KERNELS, self.launches):
                k.launches += n
            out.append(self.losses.clone())
        return out
