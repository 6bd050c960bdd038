"""LDPC FER Monte-Carlo benchmark (JAX: cli/ldpc_benchmark.py; reference
commpy/ldpc_simulation.py and tests/test_ldpc.py): the all-zero codeword
over AWGN, BP-decoded until a frame-error budget or a frame cap is reached.

Engines: torch, the batched BP of classical/ldpc.make_ldpc_decoder on
--device (the default), and numpy, the host oracle one frame at a time. The
design is the reference's Gallager (96, 48) file copied into
classical/designs/ by default; `-design ''` generates a regular (n, dv, dc)
design from -seed instead.

    python -m turboae_tpu_torch.cli.ldpc_benchmark -ebn0_start 2.5 -points 1 \\
        -batch 2000 -max_frames 20000 [--device cpu]

Without --device cpu and without a GPU it raises.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..classical.ldpc import DESIGNS


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-design', default=os.path.join(DESIGNS, '96.33.964.txt'),
                   help="Gallager design file; '' -> a generated (n, dv, dc) design")
    p.add_argument('-n', type=int, default=96)
    p.add_argument('-dv', type=int, default=3)
    p.add_argument('-dc', type=int, default=6)
    p.add_argument('-alg', choices=['SPA', 'MSA'], default='SPA')
    p.add_argument('-n_iters', type=int, default=100)
    p.add_argument('-ebn0_start', type=float, default=2.0)
    p.add_argument('-ebn0_end', type=float, default=2.5)
    p.add_argument('-points', type=int, default=2)
    p.add_argument('-target_frame_errors', type=int, default=50)
    p.add_argument('-max_frames', type=int, default=5000)
    p.add_argument('-batch', type=int, default=256)
    p.add_argument('-engine', choices=['torch', 'numpy'], default='torch')
    p.add_argument('-seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def run(args):
    """The FER curve as JAX's prints it; returns a dict of the Eb/N0s, the
    rates, the exact frame and bit error counts, the frames, the seconds of
    each point and the device."""
    import torch

    from ..classical.ldpc import (gallager_ldpc_design, get_ldpc_code_params,
                                  ldpc_bp_decode, make_ldpc_decoder)
    from ..utils.device import describe, no_tf32, resolve_device

    dev = resolve_device(args.device)
    no_tf32()
    print('[device]', describe(dev), flush=True)
    if args.design:
        params = get_ldpc_code_params(args.design)
    else:
        params = gallager_ldpc_design(args.n, args.dv, args.dc, args.seed)
    n = params['n_vnodes']
    rate = 1.0 - params['n_cnodes'] / n
    rng = np.random.RandomState(args.seed)
    if args.engine == 'torch':
        decoder = make_ldpc_decoder(params, args.alg, args.n_iters)

    if args.points == 1:
        ebn0s = [args.ebn0_start]
    else:
        ebn0s = list(np.linspace(args.ebn0_start, args.ebn0_end, args.points))
    out = {'ebn0s': ebn0s, 'fers': [], 'bers': [], 'frame_errors': [], 'bit_errors': [],
           'frames': [], 'seconds': [], 'device': describe(dev)}
    for ebn0 in ebn0s:
        noise_var = 1.0 / (2 * rate * 10 ** (ebn0 / 10.0))
        fe = be = frames = 0
        t0 = time.time()
        while fe < args.target_frame_errors and frames < args.max_frames:
            B = args.batch
            rx = 1.0 + np.sqrt(noise_var) * rng.randn(B, n)       # the all-zero codeword
            llr = 2.0 * rx / noise_var
            if args.engine == 'torch':
                bits, _ = decoder(torch.as_tensor(llr, dtype=torch.float32, device=dev))
                bits = bits.cpu().numpy()
            else:
                bits = np.stack([ldpc_bp_decode(llr[i], params, args.alg, args.n_iters)[0]
                                 for i in range(B)])
            fe += int((bits.sum(axis=1) > 0).sum())
            be += int(bits.sum())
            frames += B
        fer = fe / frames
        ber = be / (frames * n)
        seconds = time.time() - t0
        for k, v in (('fers', fer), ('bers', ber), ('frame_errors', fe), ('bit_errors', be),
                     ('frames', frames), ('seconds', seconds)):
            out[k].append(v)
        print(f'[testing]Eb/N0: {ebn0:.2f}, FER: {fer:.3e}, BER: {ber:.3e} '
              f'({frames} frames, {seconds:.1f}s)')
    print('[Result]EbN0:', ebn0s)
    print('[Result]FER:', out['fers'])
    print('[Result]BER:', out['bers'])
    return out


def main(argv=None):
    return run(get_args(argv))


if __name__ == '__main__':
    main()
