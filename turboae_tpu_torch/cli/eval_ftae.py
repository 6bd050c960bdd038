"""FTAE BER/BLER evaluation of a checkpoint on the GPU, with exact error
counts: the port of scripts/eval_ftae.py, with its flags, defaults and JSON
fields (plus `device`, and `z_bler_vs_ref` under `--ref`). TF32 is off.

    python -m turboae_tpu_torch.cli.eval_ftae --ckpt artifacts/ftae_pa.msgpack \\
        --ftae_power_alloc pos_phase --ref artifacts/eval_ftae_pa.json

`--ftae_power_alloc` must match the checkpoint: the tolerant load would
otherwise keep the template's 'pw' or 'ps' (ones) and report another
code's numbers, so a checkpoint whose forward encoders hold 'pw' or 'ps'
where the flag asks for none, or lack one the flag asks for, is refused.
The JAX script checks 'pw' only (ADVICE.md item 1). `--device cpu` runs on
the CPU; without it the CLI needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..config import Config
from ..train.checkpoint import load_checkpoint
from ..train.msgpack_io import load_msgpack
from ..utils.device import describe, no_tf32, resolve_device
from ..utils.metrics import two_proportion_z, wilson_ci


def check_power_alloc(path: str, saved_params: dict, mode: str) -> None:
    """Refuse (SystemExit) a checkpoint whose 'pw'/'ps' leaves do not match
    --ftae_power_alloc."""
    enc1 = saved_params.get('fwd_enc1', {})
    for leaf, wanted in (('pw', mode != 'none'), ('ps', mode == 'pos_phase')):
        if (leaf in enc1) != wanted:
            raise SystemExit(
                f'{path}: checkpoint {"HAS" if leaf in enc1 else "has NO"} {leaf!r} '
                f'power-allocation leaves but --ftae_power_alloc={mode} — pass the mode '
                'the checkpoint was trained with')


def config(args) -> Config:
    return Config(batch_size=args.batch_size, block_len=args.block_len,
                  dec_type=args.dec_type, dtype=args.dtype,
                  fb_channel_low=args.fb_channel_low, fb_channel_high=args.fb_channel_high,
                  ftae_power_alloc=args.ftae_power_alloc, seed=args.seed)


def evaluate(args) -> dict:
    from ..train.ftae_trainer import FTAETrainer
    dev = resolve_device(args.device)
    saved = load_msgpack(args.ckpt)
    check_power_alloc(args.ckpt, saved.get('params', saved), args.ftae_power_alloc)
    tr = FTAETrainer(config(args), dev)
    tr.params = load_checkpoint(args.ckpt, tr.params)
    print(f'loaded {args.ckpt}', flush=True)

    if dev.type == 'cuda':
        import torch
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    r = tr.sweep(args.snrs, num_block=args.num_block)
    rate = r['n_blocks'] * len(args.snrs) / (time.perf_counter() - t0)
    print(f'eval: {rate:.0f} blk/s')
    out = dict(r)
    out.update({'ckpt': args.ckpt, 'dtype': args.dtype, 'fb_channel_low': args.fb_channel_low,
                'ber_ci95': [wilson_ci(e, r['n_bits']) for e in r['bit_errors']],
                'eval_blocks_per_s': rate, 'device': describe(dev)})
    if args.ref:
        # two-proportion z of each point's BLER against a committed curve
        with open(args.ref) as f:
            ref = json.load(f)
        out['ref'] = args.ref
        out['z_bler_vs_ref'] = [
            two_proportion_z(r['blk_errors'][i], r['n_blocks'],
                             ref['blk_errors'][ref['snr'].index(s)], ref['n_blocks'])
            for i, s in enumerate(r['snr'])]
    return out


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--ckpt', default='artifacts/ftae.msgpack')
    p.add_argument('--num_block', type=int, default=200000)
    p.add_argument('--batch_size', type=int, default=2000)
    p.add_argument('--block_len', type=int, default=50)
    p.add_argument('--dec_type', default='turboae_cnn')
    p.add_argument('--fb_channel_low', type=float, default=40.0)
    p.add_argument('--fb_channel_high', type=float, default=40.0)
    p.add_argument('--ftae_power_alloc', default='none', choices=['none', 'pos', 'pos_phase'],
                   help='must match the checkpoint being evaluated')
    p.add_argument('--snrs', type=float, nargs='*', default=[-2.0, -1.0, 0.0, 1.0, 2.0])
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--out', default='logs/ftae_eval.json')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    p.add_argument('--ref', default='',
                   help='reference curve (e.g. artifacts/eval_ftae_pa.json): adds the '
                        'BLER z statistic of each point against it')
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    no_tf32()
    out = evaluate(args)
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print('wrote', args.out)
    return out


if __name__ == '__main__':
    main()
