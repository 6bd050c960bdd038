"""Classical turbo-code Monte-Carlo benchmark (JAX: cli/turbo_benchmark.py;
reference commpy/turbo_codes_benchmark.py).

Engines:
  torch     bits, turbo encoding and noise on the host in numpy from -seed
            (corrupt_signal off AWGN), as JAX's `jax` engine draws them,
            then the batched log-BCJR decoder on --device (the default);
  torch_mc  bits, encoding, noise and decoding all on --device from a
            generator seeded by -seed (classical/turbo.make_turbo_mc), full
            batches of -batch_size, as JAX's `jax_mc`;
  numpy     the host oracle, one block at a time.
JAX's `native` engine, a C++ CPU oracle, is not ported yet: argparse
refuses it, and its -num_threads flag with it.

    python -m turboae_tpu_torch.cli.turbo_benchmark -block_len 100 -num_block 1000 \\
        -snr_test_start -1.5 -snr_test_end 2 -snr_points 8 -num_dec_iter 6 [--device cpu]

Without --device cpu and without a GPU it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def get_bench_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-code', choices=['757', 'lte'], default='757')
    p.add_argument('-block_len', type=int, default=100)
    p.add_argument('-num_block', type=int, default=1000)
    p.add_argument('-num_dec_iter', type=int, default=6)
    p.add_argument('-snr_test_start', type=float, default=-1.5)
    p.add_argument('-snr_test_end', type=float, default=2.0)
    p.add_argument('-snr_points', type=int, default=8)
    p.add_argument('-batch_size', type=int, default=1000)
    p.add_argument('-engine', choices=['torch', 'torch_mc', 'numpy'], default='torch',
                   help='torch_mc: bits, encoding, noise and decoding on the device, '
                        'the deep-tail engine')
    p.add_argument('-variant', choices=['hazzys', 'hazzys_g'], default='hazzys')
    p.add_argument('-noise_type', default='awgn',
                   help='awgn | t-dist | radar | bsc | bec | ge | ge_awgn | fading: '
                        'classical corrupt_signal semantics (reference '
                        'commpy/utils.py:45-247). The decoder stays the '
                        'Gaussian-LLR turbo decoder (mismatched on non-Gaussian '
                        "channels, the TurboAE paper's classical baseline)")
    p.add_argument('-vv', type=float, default=5.0, help='t-dist dof')
    p.add_argument('-radar_power', type=float, default=5.0)
    p.add_argument('-radar_prob', type=float, default=0.05)
    p.add_argument('-target_bit_err', type=int, default=0,
                   help='stop a SNR point once this many bit errors are collected '
                        '(0 = always run num_block blocks); num_block stays the cap')
    p.add_argument('-seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def run_benchmark(args):
    """The curve as JAX's prints it; returns a dict of the SNRs, the rates,
    the exact error and block counts, the seconds of each point and the
    device."""
    import torch

    from ..classical.channels import corrupt_signal
    from ..classical.interleavers import RandInterlv
    from ..classical.trellis import turbo757_trellis, turbo_lte_trellis
    from ..classical.turbo import (hazzys_g_turbo_decode, hazzys_turbo_decode,
                                   make_turbo_decoder, make_turbo_mc, turbo_encode_batch)
    from ..utils.device import describe, no_tf32, resolve_device

    dev = resolve_device(args.device)
    no_tf32()
    print('[device]', describe(dev), flush=True)
    trellis = turbo_lte_trellis() if args.code == 'lte' else turbo757_trellis()
    inter = RandInterlv(args.block_len, 0)
    rng = np.random.RandomState(args.seed)
    # corrupt_signal draws from the global numpy RNG: seed it too
    np.random.seed(args.seed)
    if args.engine == 'torch':
        decoder = make_turbo_decoder(trellis, inter.p_array, args.num_dec_iter, args.variant)
    elif args.engine == 'torch_mc':
        mc_step = make_turbo_mc(trellis, inter.p_array, args.num_dec_iter, args.variant,
                                batch=args.batch_size)
        mc_gen = torch.Generator(device=dev).manual_seed(args.seed)

    interval = (args.snr_test_end - args.snr_test_start) / max(1, args.snr_points - 1)
    snrs = [args.snr_test_start + interval * i for i in range(args.snr_points)]
    out = {'snrs': snrs, 'bers': [], 'blers': [], 'bit_errors': [], 'block_errors': [],
           'n_blocks': [], 'seconds': [], 'device': describe(dev)}

    for snr in snrs:
        sigma = 10 ** (-snr / 20.0)
        t0 = time.time()
        n_err = n_block_err = n_done = 0
        while n_done < args.num_block:
            B = min(args.batch_size, args.num_block - n_done)
            if args.engine == 'torch_mc':
                be, ble = mc_step(mc_gen, sigma)          # a full batch on the device
                n_err += int(be)
                n_block_err += int(ble)
                n_done += args.batch_size
                if args.target_bit_err and n_err >= args.target_bit_err:
                    break
                continue
            msgs = rng.randint(0, 2, (B, args.block_len))
            codes = turbo_encode_batch(msgs, trellis, inter.p_array)
            if args.noise_type == 'awgn':
                rx = 2.0 * codes - 1.0 + sigma * rng.randn(B, args.block_len, 3)
            else:
                # the Gaussian-LLR decoder below is then mismatched: the
                # classical baseline of the TurboAE paper on ATN/radar channels
                rx = corrupt_signal(codes, args.noise_type, sigma=sigma, vv=args.vv,
                                    radar_power=args.radar_power, radar_prob=args.radar_prob)
            if args.engine == 'torch':
                # f32 on the device, as JAX's jnp.asarray of float64 with x64 off
                dec = decoder(*(torch.as_tensor(rx[:, :, i], dtype=torch.float32, device=dev)
                                for i in range(3)), sigma ** 2).cpu().numpy()
            else:
                host_dec = hazzys_g_turbo_decode if args.variant == 'hazzys_g' \
                    else hazzys_turbo_decode
                dec = np.stack([host_dec(rx[i, :, 0], rx[i, :, 1], rx[i, :, 2], trellis,
                                         sigma ** 2, args.num_dec_iter, inter)
                                for i in range(B)])
            err = dec != msgs
            n_err += int(err.sum())
            n_block_err += int((err.sum(axis=1) > 0).sum())
            n_done += B
            if args.target_bit_err and n_err >= args.target_bit_err:
                break

        seconds = time.time() - t0
        ber = n_err / (n_done * args.block_len)
        bler = n_block_err / n_done
        for k, v in (('bers', ber), ('blers', bler), ('bit_errors', n_err),
                     ('block_errors', n_block_err), ('n_blocks', n_done), ('seconds', seconds)):
            out[k].append(v)
        print(f'[testing]SNR: {snr:.2f}, BER: {ber:.3e}, BLER: {bler:.3e}, '
              f'{n_err} bit errs / {n_done} blocks, '
              f'{seconds:.1f}s ({n_done / seconds:.0f} blk/s)', flush=True)

    print('[Result]SNR:', snrs)
    print('[Result]BER:', out['bers'])
    print('[Result]BLER:', out['blers'])
    return out


def main(argv=None):
    return run_benchmark(get_bench_args(argv))


if __name__ == '__main__':
    main()
