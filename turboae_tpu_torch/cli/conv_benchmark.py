"""Convolutional-code Viterbi Monte-Carlo benchmark (JAX: cli/conv_benchmark.py;
reference commpy/conv_codes_benchmark.py, and conv_codes_llcode.py through
-tb_depth).

Engines: torch, the batched Viterbi of classical/convcode.make_viterbi on
--device (the default); native, the C++ oracle of native/kernels.cpp in f64
on the host, one block a call; and numpy, the host oracle one block at a time.
Bits are drawn from -seed and the channel is classical/channels.corrupt_signal
on the host, as in JAX, so each engine's counts equal JAX's engine of the
same name. Only the numpy oracle has the windowed traceback: with -tb_depth
the run switches to it and says so, as JAX's does.

    python -m turboae_tpu_torch.cli.conv_benchmark -snr_test_start 0 -snr_test_end 4 \\
        -snr_points 3 -num_block 20000 [--device cpu]

Without --device cpu and without a GPU it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-enc1', type=int, default=7, help='octal generator 1')
    p.add_argument('-enc2', type=int, default=5, help='octal generator 2')
    p.add_argument('-enc3', type=int, default=0,
                   help='octal generator 3 (rate 1/3, relay benchmark)')
    p.add_argument('-enc4', type=int, default=0,
                   help='octal generator 4 (rate 1/4, relay benchmark)')
    p.add_argument('-fair', type=int, default=0,
                   help='zero the tail received symbols for a fair comparison with '
                        'unterminated neural decoders (reference '
                        'relay_conv_codes_benchmark.py)')
    p.add_argument('-M', type=int, default=2, help='memory')
    p.add_argument('-feedback', type=int, default=0)
    p.add_argument('-code_type', choices=['default', 'rsc'], default='default')
    p.add_argument('-channel', default='awgn',
                   choices=['awgn', 't-dist', 'radar', 'awgn+radar', 'fading',
                            'bsc', 'radar_erasure', 'radar_saturate'])
    p.add_argument('-decoding_type', default='unquantized',
                   choices=['hard', 'unquantized', 'tdist3', 'tdist5'])
    p.add_argument('-vv', type=float, default=5.0)
    p.add_argument('-radar_power', type=float, default=20.0)
    p.add_argument('-radar_prob', type=float, default=5e-2)
    p.add_argument('-block_len', type=int, default=100)
    p.add_argument('-num_block', type=int, default=1000)
    p.add_argument('-tb_depth', type=int, default=0, help='0 = full traceback')
    p.add_argument('-snr_test_start', type=float, default=0.0)
    p.add_argument('-snr_test_end', type=float, default=6.0)
    p.add_argument('-snr_points', type=int, default=4)
    p.add_argument('-engine', choices=['torch', 'native', 'numpy'], default='torch')
    p.add_argument('-seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def run(args):
    """The curve as JAX's prints it; returns a dict of the SNRs, the rates,
    the exact bit and block error counts, the seconds of each point and
    the device."""
    import torch

    from ..classical.channels import corrupt_signal
    from ..classical.convcode import conv_encode_batch, make_viterbi, viterbi_decode
    from ..classical.trellis import Trellis
    from ..native import native_viterbi
    from ..utils.device import describe, no_tf32, resolve_device

    dev = resolve_device(args.device)
    no_tf32()
    print('[device]', describe(dev), flush=True)
    gens = [args.enc1, args.enc2] + [g for g in (args.enc3, args.enc4) if g]
    trellis = Trellis(np.array([args.M]), np.array([gens]), args.feedback, args.code_type)
    n = trellis.n
    M = trellis.total_memory
    rng = np.random.RandomState(args.seed)
    np.random.seed(args.seed)

    if args.tb_depth and args.engine != 'numpy':
        # only the numpy host decoder has the windowed traceback
        print(f'[conv_benchmark] -tb_depth {args.tb_depth}: using numpy engine')
        args.engine = 'numpy'
    if args.engine == 'torch':
        decoder = make_viterbi(trellis, args.decoding_type)

    interval = (args.snr_test_end - args.snr_test_start) / max(1, args.snr_points - 1)
    snrs = [args.snr_test_start + interval * i for i in range(args.snr_points)]
    out = {'snrs': snrs, 'bers': [], 'blers': [], 'bit_errors': [], 'block_errors': [],
           'n_blocks': [], 'seconds': [], 'device': describe(dev)}

    for snr in snrs:
        # under bsc the swept value is the flip probability (trainer.test()
        # semantics); the reference feeds the awgn sigma formula into
        # np.random.choice's p= and crashes for snr < 0
        sigma = snr if args.channel == 'bsc' else 10 ** (-snr / 20.0)
        t0 = time.time()
        msgs = rng.randint(0, 2, (args.num_block, args.block_len))
        coded = conv_encode_batch(msgs, trellis, args.code_type)
        T = coded.shape[1] // n
        rx = corrupt_signal(coded.reshape(-1), args.channel, sigma=sigma, vv=args.vv,
                            radar_power=args.radar_power,
                            radar_prob=args.radar_prob).reshape(args.num_block, T, n)
        if args.channel == 'bsc':
            rx = (rx > 0).astype(float)          # hard decisions back to bits
        if args.fair:
            # zero all n*M tail symbols (the termination), so that the (L,
            # n*(L+M)) code compares with an unterminated (L, n*L) neural
            # decoder; the reference's 2*M (relay_conv_codes_benchmark.py:110)
            # is the whole tail only at rate 1/2
            rx = rx.reshape(args.num_block, -1)
            rx[:, -n * M:] = 0.0
            rx = rx.reshape(args.num_block, T, n)

        if args.engine == 'torch':
            dec = decoder(torch.as_tensor(rx, dtype=torch.float32, device=dev)).cpu().numpy()
        elif args.engine == 'native':
            dec = np.stack([native_viterbi(rx[i], trellis, args.decoding_type)
                            for i in range(args.num_block)])
        else:
            tb = args.tb_depth if args.tb_depth else None
            dec = np.stack([viterbi_decode(rx[i].reshape(-1), trellis, tb_depth=tb,
                                           decoding_type=args.decoding_type)
                            for i in range(args.num_block)])

        err = dec[:, :args.block_len] != msgs
        ber = err.mean()
        bler = (err.sum(axis=1) > 0).mean()
        seconds = time.time() - t0
        for k, v in (('bers', float(ber)), ('blers', float(bler)), ('bit_errors', int(err.sum())),
                     ('block_errors', int((err.sum(axis=1) > 0).sum())),
                     ('n_blocks', args.num_block), ('seconds', seconds)):
            out[k].append(v)
        print(f'[testing]SNR: {snr:.2f}, BER: {ber:.3e}, BLER: {bler:.3e}, {seconds:.1f}s')

    print('[Result]SNR:', snrs)
    print('[Result]BER:', out['bers'])
    print('[Result]BLER:', out['blers'])
    return out


def main(argv=None):
    return run(get_args(argv))


if __name__ == '__main__':
    main()
