"""SNR sweep with exact error counts (JAX: Trainer._sweep_chunk and
Trainer.sweep, train/trainer.py:368-482).

Each batch draws fresh Bernoulli(0.5) bits and fresh noise at
sigma = snr_db2sigma(snr) from one torch.Generator on the device, runs the
forward in cfg.dtype, rounds the decisions and adds exact integer bit, block
and positional error counts. Counts stay on the device until a point ends.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..channels.noise import sample_noise
from ..models.channel_ae import forward_ae, make_perms
from ..utils.device import resolve_device
from ..utils.metrics import error_counts, snr_db2sigma
from ..utils.tree import tree_map


def params_to(params, device):
    """The param tree with every tensor moved to `device`."""
    return tree_map(lambda t: t.to(device), params)


@torch.inference_mode()
def sweep_counts(params, cfg, bits: torch.Tensor, noise: torch.Tensor, perms=None):
    """Deterministic core of one batch: (bit_errors, block_errors, pos_errors)
    as int64 tensors, for given bits (B, L, k) and noise (B, L, n)."""
    if perms is None:
        perms = make_perms(cfg, bits.device)
    out, _, _ = forward_ae(params, cfg, bits, noise, perms, training=False)
    return error_counts(bits, out)


@torch.inference_mode()
def sweep(params, cfg, snrs, num_block: Optional[int] = None, device='cuda',
          generator: Optional[torch.Generator] = None, verbose: bool = False):
    """Sweep the SNR points; returns the JAX sweep's result dict.

    num_block // cfg.batch_size batches per point (at least one). Without a
    generator, one is seeded from cfg.seed on the device."""
    if cfg.legacy_noise:
        raise NotImplementedError('legacy_noise is not ported yet')
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed)
    params = params_to(params, dev)
    perms = make_perms(cfg, dev)
    num_block = num_block or cfg.num_block
    num_batches = max(1, num_block // cfg.batch_size)
    bits_shape = (cfg.batch_size, cfg.block_len, cfg.code_rate_k)
    noise_shape = (cfg.batch_size, cfg.block_len, cfg.code_rate_n)
    res = {'snr': list(snrs), 'ber': [], 'bler': [], 'bit_errors': [],
           'blk_errors': [], 'pos_errors': [],
           'n_bits': num_batches * cfg.batch_size * cfg.block_len * cfg.code_rate_k,
           'n_blocks': num_batches * cfg.batch_size}
    for snr in snrs:
        sigma = snr_db2sigma(snr)
        bit_e = torch.zeros((), dtype=torch.int64, device=dev)
        blk_e = torch.zeros((), dtype=torch.int64, device=dev)
        pos_e = torch.zeros(cfg.block_len * cfg.code_rate_k, dtype=torch.int64, device=dev)
        for _ in range(num_batches):
            bits = (torch.rand(bits_shape, generator=generator, device=dev) < 0.5).float()
            noise = sample_noise(noise_shape, cfg, sigma, generator, dev)
            be, ke, pe = sweep_counts(params, cfg, bits, noise, perms)
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
