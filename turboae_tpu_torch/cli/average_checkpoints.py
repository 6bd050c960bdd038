"""Average the params of N checkpoints into one, a model soup (the port of
scripts/average_checkpoints.py).

Fine-tunes of one parent checkpoint stay mode-connected, so their weighted
average often keeps the strengths of both. Each file's params are read with
the port's msgpack reader, weighted (uniformly by default; weights are
normalised to sum 1) and summed in f64, then written back in f32 in the
JAX package's layout {'params': ..., 'step': 0}, as the JAX script writes
it. Rank the result with cli/select_checkpoint.py.

    python -m turboae_tpu_torch.cli.average_checkpoints --out tmp/soup.msgpack \\
        artifacts/flagship.msgpack tmp/flagship_floor2.msgpack.e100 --weights 0.5 0.5
"""
from __future__ import annotations

import argparse

import numpy as np

from ..train.msgpack_io import load_msgpack, save_msgpack


def _combine(trees, weights):
    """sum_i w_i tree_i in f64, leaf by leaf; the trees must match."""
    first = trees[0]
    if isinstance(first, dict):
        if any(not isinstance(t, dict) or set(t) != set(first) for t in trees):
            raise ValueError('the checkpoints hold different param trees')
        return {k: _combine([t[k] for t in trees], weights) for k in first}
    if any(np.shape(t) != np.shape(first) for t in trees):
        raise ValueError('the checkpoints hold params of different shapes')
    return sum(w * np.asarray(t, np.float64) for w, t in zip(weights, trees))


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def average(paths, weights=None) -> dict:
    """The weighted average of the files' params, f32 leaves."""
    w = list(weights) if weights else [1.0 / len(paths)] * len(paths)
    if len(w) != len(paths):
        raise ValueError(f'{len(w)} weights for {len(paths)} checkpoints')
    total = sum(w)
    w = [x / total for x in w]
    trees = []
    for path in paths:
        payload = load_msgpack(path)
        trees.append(payload.get('params', payload))
    return _f32(_combine(trees, w)), w


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('ckpts', nargs='+')
    p.add_argument('--weights', type=float, nargs='*', default=None,
                   help='per-checkpoint weights (default: uniform)')
    p.add_argument('--out', required=True)
    args = p.parse_args(argv)
    params, w = average(args.ckpts, args.weights)
    save_msgpack(args.out, {'params': params, 'step': 0})
    print(f'wrote {args.out} = ' + ' + '.join(
        f'{wi:.3f}*{path}' for wi, path in zip(w, args.ckpts)))
    return args.out


if __name__ == '__main__':
    main()
