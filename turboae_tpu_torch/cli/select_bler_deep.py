"""Rank checkpoints by exact BLER counts at the SNRs given, the first one
deciding (the port of scripts/select_bler_deep.py).

Each point counts exact bit and block errors over num_block blocks
(train/sweep.py; never rank on a cell of fewer than ~100 errors); one JSON
line a checkpoint is appended to --out. The winner of such a ranking is the
minimum of noisy draws: measure it again with a fresh seed
(cli/eval_flagship.py) before quoting it.

    python -m turboae_tpu_torch.cli.select_bler_deep --num_block 1000000 \\
        tmp/soup_*.msgpack artifacts/flagship.msgpack --snrs 2.0 3.5
"""
from __future__ import annotations

import json
import os

from .select_checkpoint import parser, sweeps


def main(argv=None):
    p = parser(__doc__.splitlines()[0], 1000000, 'logs/select_bler_deep.jsonl')
    p.add_argument('--snrs', type=float, nargs='+', default=[2.0, 3.5])
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    rows = []
    with open(args.out, 'a') as f:
        for ck, r in sweeps(args, args.snrs):
            row = {'ckpt': ck, 'snr': r['snr'], 'ber': r['ber'], 'bler': r['bler'],
                   'bit_errors': r['bit_errors'], 'blk_errors': r['blk_errors'],
                   'n_bits': r['n_bits'], 'n_blocks': r['n_blocks']}
            f.write(json.dumps(row) + '\n')
            f.flush()
            rows.append(row)
            cells = ' '.join(f'snr{s}: ber {b:.3e} ({be}) bler {q:.3e} ({ke})'
                             for s, b, be, q, ke in zip(r['snr'], r['ber'], r['bit_errors'],
                                                        r['bler'], r['blk_errors']))
            print(f'{ck}: {cells}', flush=True)
    best = min(rows, key=lambda r: r['bler'][0])
    print(f"BEST by BLER@{args.snrs[0]}: {best['ckpt']} "
          f"{best['bler'][0]:.4e} ({best['blk_errors'][0]} errs)")
    return rows


if __name__ == '__main__':
    main()
