"""BER/BLER evaluation of a checkpoint on the GPU.

The port's counterpart of scripts/eval_flagship.py, with its flags: loads a
flax msgpack checkpoint with the port's own reader, sweeps the SNR points
with exact error counts on any channel of the reference, and writes the same
JSON schema (counts, BER/BLER, Wilson CIs). TF32 is off. The decoder's plain
conv stacks run through the fused CUDA kernel; dense ones (every encoder but
the flagship's, DeepTurbo's included) run unfused, as in JAX.

    python -m turboae_tpu_torch.cli.eval_flagship \
        --ckpt artifacts/flagship_fading.msgpack --channel fading \
        --num_block 100000 --out eval.json   # default logs/flagship_eval.json
    python -m turboae_tpu_torch.cli.eval_flagship --ckpt artifacts/deepturbo.msgpack \
        --encoder Turbo_rate3_757 --ref artifacts/eval_deepturbo.json

`--device cpu` runs on the CPU (the kernel's plain version); without it the
CLI needs a GPU. `--chunk` is accepted so the JAX script's command lines run
unchanged; eager PyTorch launches batch by batch, so it has no effect.
`--ref` adds each point's BLER z statistic against a committed curve; under
`--legacy_noise` both sides count batch_size independent noise blocks.
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
from ..utils.device import describe, no_tf32, resolve_device
from ..utils.metrics import two_proportion_z, wilson_ci


def load_flagship(path: str, device):
    """Port params of a flax msgpack checkpoint (its 'params' subtree)."""
    tree = load_msgpack(path)
    return from_jax(tree.get('params', tree), device)


def config(args) -> Config:
    """The Config of the evaluation: the flags, bf16 or f32, fused decoder."""
    return Config(batch_size=args.batch_size, num_block=args.num_block,
                  encoder=args.encoder, decoder=args.decoder,
                  test_channel_mode=args.test_channel_mode, channel=args.channel,
                  vv=args.vv, radar_prob=args.radar_prob, radar_power=args.radar_power,
                  block_len=args.block_len, dec_num_layer=args.dec_num_layer,
                  dtype=args.dtype, legacy_noise=args.legacy_noise, use_fused_conv=True,
                  seed=args.seed, snr_points=args.snr_points,
                  snr_test_start=args.snr_test_start, snr_test_end=args.snr_test_end)


def evaluate(args) -> dict:
    dev = resolve_device(args.device)
    cfg = config(args)
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
           'channel': cfg.channel, 'dtype': cfg.dtype, 'legacy_noise': cfg.legacy_noise,
           'ckpt': args.ckpt, 'eval_blocks_per_s': rate, 'device': describe(dev)}
    if args.ref:
        # two-proportion z of each point's BLER against a reference curve
        # file of the same schema (blocks are independent; bits are not)
        with open(args.ref) as f:
            ref = json.load(f)
        out['ref'] = args.ref
        out['z_bler_vs_ref'] = []
        for s in snrs:
            j = ref['snr'].index(s)
            if cfg.legacy_noise:
                # one noise realization of batch_size blocks on each side
                n = cfg.batch_size
                z = two_proportion_z(per_point[s]['bler'] * n, n, ref['bler'][j] * n, n)
            else:
                z = two_proportion_z(per_point[s]['blk_errors'], per_point[s]['n_blocks'],
                                     ref['blk_errors'][j], ref['n_blocks'][j])
            out['z_bler_vs_ref'].append(z)
    return out


def parse(argv=None) -> argparse.Namespace:
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
    p.add_argument('--encoder', default='TurboAE_rate3_cnn',
                   help='e.g. Turbo_rate3_757 for DeepTurbo checkpoints, '
                        'TurboAE_rate3_cnn_dense')
    p.add_argument('--decoder', default='TurboAE_rate3_cnn')
    p.add_argument('--test_channel_mode', default='block_norm',
                   help='block_norm_ste for TurboAE-binary checkpoints')
    p.add_argument('--channel', default='awgn',
                   help='awgn | t-dist | radar | ge_awgn | bec | bsc | ge | fading')
    p.add_argument('--vv', type=float, default=5.0, help='t-dist dof')
    p.add_argument('--radar_prob', type=float, default=0.05)
    p.add_argument('--radar_power', type=float, default=5.0)
    p.add_argument('--block_len', type=int, default=100,
                   help='must match the training block_len (the interleaver depends on it)')
    p.add_argument('--dec_num_layer', type=int, default=5)
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--chunk', type=int, default=50,
                   help='accepted for the JAX command lines; no effect here')
    p.add_argument('--legacy_noise', action='store_true',
                   help='reproduce the pre-2022 fixed-noise test bug (awgn, t-dist)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--ref', default='',
                   help='reference curve (e.g. artifacts/eval_crown_r4.json): '
                        'adds the BLER z statistic of each point against it')
    p.add_argument('--out', default='logs/flagship_eval.json')
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    no_tf32()
    out = evaluate(args)
    # always written, as scripts/eval_flagship.py:144-147 writes it
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print('wrote', args.out)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
