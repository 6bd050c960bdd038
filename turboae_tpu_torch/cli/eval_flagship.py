"""BER/BLER evaluation of a flagship checkpoint on the GPU.

The port's counterpart of scripts/eval_flagship.py: loads a flax msgpack
checkpoint with the port's own reader, sweeps the SNR points with exact error
counts through the fused CUDA conv-stack kernel, and writes the same JSON
schema (counts, BER/BLER, Wilson CIs).

    python -m turboae_tpu_torch.cli.eval_flagship \
        --ckpt artifacts/flagship.msgpack --num_block 100000 --out eval.json
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..config import Config
from ..train.convert import from_jax
from ..train.msgpack_io import load_msgpack
from ..train.sweep import sweep
from ..utils.device import resolve_device
from ..utils.metrics import two_proportion_z, wilson_ci


def load_flagship(path: str, device):
    """Port params of a flax msgpack checkpoint (its 'params' subtree)."""
    tree = load_msgpack(path)
    return from_jax(tree.get('params', tree), device)


def evaluate(args) -> dict:
    dev = resolve_device(args.device)
    cfg = Config(batch_size=args.batch_size, num_block=args.num_block,
                 block_len=args.block_len, dtype=args.dtype,
                 use_fused_conv=True, seed=args.seed,
                 snr_points=args.snr_points, snr_test_start=args.snr_test_start,
                 snr_test_end=args.snr_test_end)
    params = load_flagship(args.ckpt, dev)
    interval = (cfg.snr_test_end - cfg.snr_test_start) / max(1, cfg.snr_points - 1)
    snrs = [cfg.snr_test_start + interval * i for i in range(cfg.snr_points)]
    deep = [s for s in snrs if args.deep_num_block and s >= args.deep_from_snr]
    shallow = [s for s in snrs if s not in deep]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed)

    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    per_point, total_blocks = {}, 0
    for points, n in ((shallow, args.num_block), (deep, args.deep_num_block)):
        if not points:
            continue
        r = sweep(params, cfg, points, num_block=n, device=dev, generator=gen,
                  verbose=True)
        for i, s in enumerate(points):
            per_point[s] = {k: r[k][i] for k in ('ber', 'bler', 'bit_errors', 'blk_errors')}
            per_point[s]['n_bits'] = r['n_bits']
            per_point[s]['n_blocks'] = r['n_blocks']
        total_blocks += r['n_blocks'] * len(points)
    rate = total_blocks / (time.perf_counter() - t0)

    col = lambda k: [per_point[s][k] for s in snrs]
    out = {'snr': snrs, 'ber': col('ber'), 'bler': col('bler'),
           'bit_errors': col('bit_errors'), 'blk_errors': col('blk_errors'),
           'n_bits': col('n_bits'), 'n_blocks': col('n_blocks'),
           'ber_ci95': [wilson_ci(p['bit_errors'], p['n_bits']) for p in map(per_point.get, snrs)],
           'bler_ci95': [wilson_ci(p['blk_errors'], p['n_blocks']) for p in map(per_point.get, snrs)],
           'channel': cfg.channel, 'dtype': cfg.dtype, 'legacy_noise': False,
           'ckpt': args.ckpt, 'eval_blocks_per_s': rate,
           'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}
    if args.ref:
        # two-proportion z of each point's BLER against a reference curve
        # file of the same schema (blocks are independent; bits are not)
        with open(args.ref) as f:
            ref = json.load(f)
        out['ref'] = args.ref
        out['z_bler_vs_ref'] = [
            two_proportion_z(per_point[s]['blk_errors'], per_point[s]['n_blocks'],
                             ref['blk_errors'][ref['snr'].index(s)],
                             ref['n_blocks'][ref['snr'].index(s)]) for s in snrs]
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--ckpt', default='artifacts/flagship.msgpack')
    p.add_argument('--num_block', type=int, default=100000)
    p.add_argument('--deep_num_block', type=int, default=0,
                   help='if >0, points >= --deep_from_snr use this many blocks')
    p.add_argument('--deep_from_snr', type=float, default=2.0)
    p.add_argument('--batch_size', type=int, default=2000)
    p.add_argument('--snr_points', type=int, default=12)
    p.add_argument('--snr_test_start', type=float, default=-1.5)
    p.add_argument('--snr_test_end', type=float, default=4.0)
    p.add_argument('--block_len', type=int, default=100)
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--ref', default='',
                   help='reference curve (e.g. artifacts/eval_crown_r4.json): '
                        'adds the BLER z statistic of each point against it')
    p.add_argument('--out', default='')
    args = p.parse_args(argv)
    out = evaluate(args)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == '__main__':
    main()
