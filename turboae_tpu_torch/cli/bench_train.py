"""Benchmark: coded blocks/s through the full train step on one GPU (the
port of bench.py).

The flagship training config of bench.py: batch 500, K=100, rate 1/3, 6
decoder iterations, decoder SNR range -1.5..2.0 dB, bf16 conv stacks. Warms up
one decoder and one encoder step, then times 60 steps of the 1 encoder : 5
decoder schedule (bench.py:80-89) with a host clock that ends in
torch.cuda.synchronize(). Prints one JSON line with `train_blocks_per_s`.

`--use_fused_conv` routes the decoder's 12 stacks through the CUDA kernel K2
(forward) and its recompute backward. TF32 is off: the f32 backward
recompute and the f32 heads run in full f32. `mfu` stays null: the port has
no FLOP count yet (M17).

    python -m turboae_tpu_torch.cli.bench_train [--use_fused_conv] [--batch_size 500]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import Config
from ..train.trainer import Trainer
from ..utils.device import no_tf32, resolve_device

BASELINE_BLOCKS_PER_S = 2000.0     # the reference on a 1080Ti (bench.py:16)


def bench(batch_size: int = 500, use_fused_conv: bool = False, steps: int = 60,
          device='cuda', **cfg_overrides) -> dict:
    dev = resolve_device(device)
    no_tf32()
    cfg = Config(batch_size=batch_size, block_len=100, num_block=batch_size,
                 train_dec_channel_low=-1.5, train_dec_channel_high=2.0,
                 dtype='bfloat16', use_fused_conv=use_fused_conv, **cfg_overrides)
    trainer = Trainer(cfg, dev)
    trainer.train_epoch(0, 'decoder', verbose=False)     # warm up both phases
    trainer.train_epoch(0, 'encoder', verbose=False)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
    sync()
    t0 = time.perf_counter()
    losses = [trainer._train_step('encoder' if i % 6 == 0 else 'decoder')
              for i in range(steps)]
    sync()
    dt = time.perf_counter() - t0
    blocks_per_s = steps * cfg.batch_size / dt
    return {
        'metric': 'train_blocks_per_s',
        'value': blocks_per_s,
        'unit': 'blocks/s/GPU (rate-1/3, K=100, 6 dec iters, full train step)',
        'vs_baseline': blocks_per_s / BASELINE_BLOCKS_PER_S,
        'mfu': None, 'tflops_per_s': None, 'step_flops': None,
        'use_fused_conv': use_fused_conv, 'allow_tf32': False,
        'batch_size': batch_size, 'steps': steps, 'seconds': dt,
        'last_loss': float(losses[-1]),
        'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--batch_size', type=int, default=500)
    p.add_argument('--use_fused_conv', action='store_true')
    p.add_argument('--steps', type=int, default=60)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    out = bench(args.batch_size, args.use_fused_conv, args.steps, args.device)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
