"""Sequence-parallel (time-axis) against data-parallel sharding at K=1000
(the port of scripts/sp_study.py).

The reference concedes that block_len 1000 is memory-hard and leaves it
untrained (scripts/sp_study.py:3-5). Under torchrun on N ranks, at the
flagship's full width, this runs one decoder train step after another in
three layouts:

  single  every rank alone, the whole global batch, no collectives;
  batch   the global batch split over the N ranks (shard_axis 'batch');
  time    every block's positions split over the N ranks (shard_axis
          'time': halo windows for the conv stacks, the interleavers and the
          narrow stack inputs gathered along time, dist/mesh.py);

and reports for each: the peak memory a rank (torch.cuda.max_memory_allocated
over a decoder step after a warm one, on every rank: the port's counterpart
of XLA's memory analysis), ms a decoder step over `--steps` steps, and the
last step's loss (the three layouts take the same steps from the same seed:
their losses agree to f32 reordering). Rank 0 prints one JSON line a layout
and writes the three, with the card's name and power limit, to `--out`.

    python -m torch.distributed.run --nproc_per_node 4 -m turboae_tpu_torch.cli.sp_study \\
        --block_len 1000 --batch_size 64
    python -m torch.distributed.run --nproc_per_node 2 -m turboae_tpu_torch.cli.sp_study \\
        --device cpu --block_len 40 --batch_size 4 --num_units 8   # gloo, tiny

NCCL with one card a rank, or gloo on the CPU under `--device cpu` (where the
memory is not measured: null). Without torchrun it runs 'single' alone.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time

import torch

LAYOUTS = ('single', 'batch', 'time')


def study(args, dev, mesh) -> list:
    from ..config import Config
    from ..train.trainer import Trainer
    cuda = dev.type == 'cuda'

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    out = []
    for layout in LAYOUTS if mesh is not None else ('single',):
        cfg = Config(block_len=args.block_len, batch_size=args.batch_size,
                     num_block=args.batch_size, enc_num_unit=args.num_units,
                     dec_num_unit=args.num_units, num_iteration=args.num_iteration,
                     dtype=args.dtype, use_fused_conv=args.use_fused_conv,
                     shard_axis='batch' if layout == 'single' else layout)
        tr = Trainer(cfg, dev, mesh=None if layout == 'single' else mesh)
        tr._train_step('decoder')                   # warm
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        tr._train_step('decoder')
        sync()
        peak = torch.cuda.max_memory_allocated(dev) / 1e6 if cuda else None
        t0 = time.perf_counter()
        for _ in range(args.steps):
            loss = tr._train_step('decoder')
        sync()
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        row = {'layout': layout, 'ranks': 1 if mesh is None else mesh.size,
               'rows_per_rank': cfg.batch_size // (mesh.size if layout == 'batch' else 1),
               'positions_per_rank': cfg.block_len // (mesh.size if layout == 'time' else 1),
               'ms_per_step': ms, 'blocks_per_s': cfg.batch_size / ms * 1e3,
               'loss': float(loss)}
        row['peak_memory_mb'] = peak
        if mesh is not None and peak is not None:  # every rank's
            mem = torch.zeros(mesh.size * mesh.replicas, dtype=torch.float64, device=dev)
            mem[mesh.rank] = peak
            torch.distributed.all_reduce(mem)
            row['peak_memory_mb_by_rank'] = mem.tolist()
        out.append(row)
        del tr
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--block_len', type=int, default=1000)
    p.add_argument('--batch_size', type=int, default=64)
    p.add_argument('--num_units', type=int, default=100)
    p.add_argument('--num_iteration', type=int, default=6)
    p.add_argument('--steps', type=int, default=3)
    p.add_argument('--dtype', default='float32')
    p.add_argument('--use_fused_conv', action='store_true')
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default='logs/sp_study.json')
    args = p.parse_args(argv)

    from ..config import Config
    from ..dist import mesh as dm
    from ..utils.device import describe, no_tf32
    from .main import launch
    no_tf32()
    env = dm.launch_env()
    shape = (env[1],) if env else ()
    dev, mesh = launch(Config(mesh_shape=shape), args.device)
    try:
        rows = study(args, dev, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    res = {'device': describe(dev), 'block_len': args.block_len,
           'batch_size': args.batch_size, 'num_units': args.num_units,
           'num_iteration': args.num_iteration, 'dtype': args.dtype,
           'use_fused_conv': args.use_fused_conv, 'allow_tf32': False, 'layouts': rows}
    if mesh is None or mesh.rank == 0:
        for r in rows:
            print(json.dumps({**r, 'device': res['device']}))
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == '__main__':
    main()
