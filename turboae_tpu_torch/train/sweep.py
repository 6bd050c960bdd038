"""SNR sweep with exact error counts (JAX: Trainer._sweep_chunk and
Trainer.sweep, train/trainer.py:368-482).

Each batch draws fresh Bernoulli(0.5) bits and fresh noise of cfg.channel at
the point's sigma (sigma(snr dB), or the raw probability snr for bec, bsc and
ge) from one torch.Generator on the device, runs the forward in cfg.dtype
(the fading gain from the same generator), rounds the decisions and adds
exact integer bit, block and positional error counts. Counts stay on the
device until a point ends.

cfg.legacy_noise reproduces the pre-2022 reference test bug (README.md:2):
one unit noise realization of shape (batch, L, n) is drawn at the start of
the sweep and scaled by each point's sigma for every batch of every point;
only the bits resample. It is defined for awgn and t-dist only.

With `mesh` (dist/mesh.py) every rank draws the global batch and keeps its
share along cfg.shard_axis (its blocks, or its positions of every block),
and the counts are summed over the data group: the result is the 1-rank
run's with that seed, on every rank.

The caller decides TF32: library code sets no global flag (the CLIs turn it
off, utils/device.py:no_tf32).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..channels.noise import check_legacy_noise_channel, point_sigma, sample_noise, spec_from_cfg
from ..dist import mesh as dm
from ..models.channel_ae import forward_ae, make_perms
from ..utils.device import resolve_device
from ..utils.logging import span
from ..utils.metrics import error_counts
from ..utils.tree import tree_map


def params_to(params, device):
    """The param tree with every tensor moved to `device`."""
    return tree_map(lambda t: t.to(device), params)


@torch.inference_mode()
def sweep_counts(params, cfg, bits: torch.Tensor, noise: torch.Tensor, perms=None,
                 generator: Optional[torch.Generator] = None):
    """Deterministic core of one batch (given the fading gain's generator):
    (bit_errors, block_errors, pos_errors) as int64 tensors, for given bits
    (B, L, k) and noise (B, L, n), the global batch under a mesh in effect
    (this rank's share along its axis is kept). The call is the span
    `sweep`, the counts its child `counts`."""
    with span('sweep'):
        bits, noise = (dm.shard_rows(t, dm.current()) for t in (bits, noise))
        if perms is None:
            perms = make_perms(cfg, bits.device)
        out, _, _ = forward_ae(params, cfg, bits, noise, perms, training=False,
                               generator=generator)
        with span('counts'):
            return error_counts(bits, out)


@torch.inference_mode()
def sweep(params, cfg, snrs, num_block: Optional[int] = None, device='cuda',
          generator: Optional[torch.Generator] = None, verbose: bool = False, mesh=None):
    """Sweep the SNR points; returns the JAX sweep's result dict.

    num_block // cfg.batch_size batches per point (at least one), of
    cfg.batch_size blocks over all ranks of `mesh`. Without a generator, one
    is seeded from cfg.seed on the device."""
    with dm.active(dm.along(mesh, cfg.shard_axis)):
        return _sweep(params, cfg, snrs, num_block, device, generator, verbose)


def _sweep(params, cfg, snrs, num_block, device, generator, verbose):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed)
    params = params_to(params, dev)
    perms = make_perms(cfg, dev)
    spec = spec_from_cfg(cfg)
    num_block = num_block or cfg.num_block
    num_batches = max(1, num_block // cfg.batch_size)
    bits_shape = (cfg.batch_size, cfg.block_len, cfg.code_rate_k)
    noise_shape = (cfg.batch_size, cfg.block_len, cfg.code_rate_n)
    fixed_unit = None
    if cfg.legacy_noise:
        check_legacy_noise_channel(cfg.channel)
        fixed_unit = sample_noise(noise_shape, spec, 1.0, generator, dev)
    res = {'snr': list(snrs), 'ber': [], 'bler': [], 'bit_errors': [],
           'blk_errors': [], 'pos_errors': [],
           'n_bits': num_batches * cfg.batch_size * cfg.block_len * cfg.code_rate_k,
           'n_blocks': num_batches * cfg.batch_size}
    for snr in snrs:
        sigma = point_sigma(cfg, snr)
        bit_e = torch.zeros((), dtype=torch.int64, device=dev)
        blk_e = torch.zeros((), dtype=torch.int64, device=dev)
        pos_e = torch.zeros(cfg.block_len * cfg.code_rate_k, dtype=torch.int64, device=dev)
        for _ in range(num_batches):
            bits = (torch.rand(bits_shape, generator=generator, device=dev) < 0.5).float()
            if fixed_unit is None:
                noise = sample_noise(noise_shape, spec, sigma, generator, dev)
            else:
                noise = sigma * fixed_unit
            be, ke, pe = sweep_counts(params, cfg, bits, noise, perms, generator)
            bit_e += be
            blk_e += ke
            pos_e += pe
        bit_e, blk_e = int(bit_e), int(blk_e)
        ber, bler = bit_e / res['n_bits'], blk_e / res['n_blocks']
        res['ber'].append(ber)
        res['bler'].append(bler)
        res['bit_errors'].append(bit_e)
        res['blk_errors'].append(blk_e)
        res['pos_errors'].append(pos_e.cpu().tolist())
        if verbose:
            print(f'Test SNR {snr} with ber {ber:.6e} ({bit_e} bit errs) '
                  f'with bler {bler:.6e} ({blk_e} blk errs)', flush=True)
    return res
