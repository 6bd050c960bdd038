"""Sweep a set of checkpoints at the twelve points of the published curve
and rank them by dominance, the cells strictly below its BER and BLER (the
port of scripts/select_checkpoint.py).

One generator on the device, seeded with the Config's seed, serves every
checkpoint in turn; each point counts exact errors over num_block blocks
(train/sweep.py). One JSON line a checkpoint is appended to --out.

    python -m turboae_tpu_torch.cli.select_checkpoint --num_block 100000 \\
        tmp/flagship_floor.msgpack.e* tmp/flagship_floor.msgpack.best
"""
from __future__ import annotations

import argparse
import json
import os


def parser(description: str, num_block: int, out: str) -> argparse.ArgumentParser:
    """The flags both selection CLIs take."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument('ckpts', nargs='+')
    p.add_argument('--num_block', type=int, default=num_block)
    p.add_argument('--batch_size', type=int, default=2000)
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--use_fused_conv', action='store_true',
                   help='decoder conv stacks through the CUDA bf16 kernel')
    p.add_argument('--out', default=out)
    p.add_argument('--device', default='cuda')
    return p


def sweeps(args, snrs):
    """(path, sweep result) of each checkpoint, in order, at `snrs`."""
    import torch

    from ..config import Config
    from ..models.channel_ae import init_ae
    from ..train.checkpoint import load_checkpoint
    from ..train.sweep import sweep
    from ..utils.device import no_tf32, resolve_device
    no_tf32()
    dev = resolve_device(args.device)
    cfg = Config(batch_size=args.batch_size, num_block=args.num_block, dtype=args.dtype,
                 use_fused_conv=args.use_fused_conv)
    template = init_ae(torch.Generator().manual_seed(cfg.seed), cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    for ck in args.ckpts:
        params = load_checkpoint(ck, template)
        yield ck, sweep(params, cfg, snrs, num_block=args.num_block, device=dev, generator=gen)


def main(argv=None):
    from ..results.reference_curves import TURBOAE_CNN_K100_FULL as ref
    args = parser(__doc__.splitlines()[0], 100000, 'logs/select_checkpoint.jsonl').parse_args(argv)
    n = len(ref['snr'])
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    results = []
    with open(args.out, 'a') as f:
        for ck, r in sweeps(args, ref['snr']):
            ber_w = [i for i in range(n) if r['ber'][i] < ref['ber'][i]]
            bler_w = [i for i in range(n) if r['bler'][i] < ref['bler'][i]]
            row = {'ckpt': ck, 'ber_wins': len(ber_w), 'bler_wins': len(bler_w),
                   'ber_losses': [ref['snr'][i] for i in range(n) if i not in ber_w],
                   'bler_losses': [ref['snr'][i] for i in range(n) if i not in bler_w],
                   'ber': r['ber'], 'bler': r['bler'], 'bit_errors': r['bit_errors'],
                   'blk_errors': r['blk_errors']}
            f.write(json.dumps(row) + '\n')
            f.flush()
            results.append(row)
            print(f"{ck}: BER {row['ber_wins']}/{n} BLER {row['bler_wins']}/{n} "
                  f"(losses: ber@{row['ber_losses']} bler@{row['bler_losses']})", flush=True)
    best = max(results, key=lambda r: (r['ber_wins'] + r['bler_wins'], -r['ber'][7]))
    print('BEST:', best['ckpt'], best['ber_wins'], best['bler_wins'])
    return results


if __name__ == '__main__':
    main()
