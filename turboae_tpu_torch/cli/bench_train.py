"""Benchmark: coded blocks/s through the full train step on one GPU (the
port of bench.py).

The flagship training config of bench.py: batch 500, K=100, rate 1/3, 6
decoder iterations, decoder SNR range -1.5..2.0 dB, bf16 conv stacks. Warms up
one decoder and one encoder step, then times 60 steps of the 1 encoder : 5
decoder schedule (bench.py:80-89) with a host clock that ends in
torch.cuda.synchronize(). Prints one JSON line with `train_blocks_per_s`.

`--use_fused_conv` routes the decoder's 12 stacks through the CUDA kernel K2
(forward) and its recompute backward. TF32 is off: the f32 backward
recompute and the f32 heads run in full f32.

`--steps_per_call n` (n > 1) times the graph path instead: the encoder's
steps/6 steps, then the decoder's 5 steps/6, each phase in groups of n that
are one replay of its captured CUDA graph (the rest eagerly), both graphs
captured before the clock starts.

FLOPs and MFU as bench.py computes them (:74-107): `step_flops` holds the
FLOPs of one encoder and one decoder step, counted by FlopCounterMode
(utils/flops.py) on a throwaway trainer at the same config, unfused (the
fused stack does the same products); `tflops_per_s` is (enc + 5 dec) / 6
FLOPs a step over the timed steps' seconds, and `mfu` that over the card's
dense peak in the config's dtype (utils/flops.py:PEAKS). On a card not in
the table, and on the CPU, `mfu` is null and `mfu_reason` says why.

`--mesh_shape N [M]` under torchrun times N (N * M) ranks (dist/mesh.py;
NCCL, one card a rank, or gloo under --device cpu), sharding the batch or,
with `--shard_axis time`, every block's positions: --batch_size is then the
global batch, `value` the blocks/s of all ranks together, and `mfu` taken
against all the cards' peak (replicas included). Rank 0 prints.

    python -m turboae_tpu_torch.cli.bench_train [--use_fused_conv] [--batch_size 500] \
        [--steps_per_call 6]
    python -m torch.distributed.run --nproc_per_node 4 -m turboae_tpu_torch.cli.bench_train \
        --mesh_shape 4 --batch_size 2000 [--shard_axis time]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..config import Config
from ..train.trainer import Trainer
from ..utils.device import no_tf32, resolve_device
from ..utils.flops import counted_flops, peak

BASELINE_BLOCKS_PER_S = 2000.0     # the reference on a 1080Ti (bench.py:16)


def step_flops(cfg, device) -> dict:
    """{'enc', 'dec'}: the counted FLOPs of one encoder and one decoder step
    at cfg, unfused, on a throwaway trainer."""
    trainer = Trainer(cfg.replace(use_fused_conv=False, steps_per_call=1), device)
    return {'enc': counted_flops(trainer._train_step, 'encoder'),
            'dec': counted_flops(trainer._train_step, 'decoder')}


def bench(batch_size: int = 500, use_fused_conv: bool = False, steps: int = 60,
          device='cuda', steps_per_call: int = 1, mesh=None, **cfg_overrides) -> dict:
    dev = resolve_device(device)
    no_tf32()
    cfg = Config(batch_size=batch_size, block_len=100, num_block=batch_size,
                 train_dec_channel_low=-1.5, train_dec_channel_high=2.0,
                 dtype='bfloat16', use_fused_conv=use_fused_conv, **cfg_overrides)
    trainer = Trainer(cfg, dev, mesh=mesh)
    ranks = 1 if mesh is None else mesh.size * mesh.replicas
    trainer.train_epoch(0, 'decoder', verbose=False)     # warm up both phases
    trainer.train_epoch(0, 'encoder', verbose=False)
    n = steps_per_call

    def phase(mode, count):
        groups, rem = divmod(count, n)
        out = trainer._train_steps(mode, n, groups) if groups else []
        return out + [trainer._train_step(mode) for _ in range(rem)]
    if n > 1:                                            # capture both graphs
        phase('decoder', n)
        phase('encoder', n)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
    sync()
    t0 = time.perf_counter()
    if n > 1:
        losses = phase('encoder', steps // 6) + phase('decoder', steps - steps // 6)
    else:
        losses = [trainer._train_step('encoder' if i % 6 == 0 else 'decoder')
                  for i in range(steps)]
    sync()
    dt = time.perf_counter() - t0
    blocks_per_s = steps * cfg.batch_size / dt
    flops = step_flops(cfg, dev)
    avg_step_flops = (flops['enc'] + 5.0 * flops['dec']) / 6.0
    flops_per_s = avg_step_flops * steps / dt
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'
    peak_flops = peak(name, cfg.dtype) if dev.type == 'cuda' else None
    if dev.type != 'cuda':
        reason = 'no MFU on the CPU'
    elif peak_flops is None:
        reason = f'no {cfg.dtype} peak for {name!r} in utils/flops.py:PEAKS'
    else:
        reason = None
    return {
        'metric': 'train_blocks_per_s',
        'value': blocks_per_s,
        'unit': f'blocks/s over {ranks} rank(s) (rate-1/3, K=100, 6 dec iters, full train step)',
        'vs_baseline': blocks_per_s / BASELINE_BLOCKS_PER_S,
        'mfu': None if peak_flops is None else flops_per_s / (peak_flops * ranks),
        'mfu_reason': reason, 'peak_flops': peak_flops, 'peak_dtype': cfg.dtype,
        'tflops_per_s': flops_per_s / 1e12, 'step_flops': flops,
        'use_fused_conv': use_fused_conv, 'allow_tf32': False, 'steps_per_call': n,
        'batch_size': batch_size, 'ranks': ranks, 'shard_axis': cfg.shard_axis,
        'steps': steps, 'seconds': dt,
        'last_loss': float(torch.cat([l.reshape(-1) for l in losses])[-1]),
        'device': name,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--batch_size', type=int, default=500)
    p.add_argument('--use_fused_conv', action='store_true')
    p.add_argument('--steps', type=int, default=60)
    p.add_argument('--steps_per_call', type=int, default=1,
                   help='> 1: time the steps as replays of CUDA graphs of this many steps')
    p.add_argument('--device', default='cuda')
    p.add_argument('--mesh_shape', type=int, nargs='*', default=[],
                   help='N [M]: N (N * M) ranks under torchrun; --batch_size is global')
    p.add_argument('--shard_axis', default='batch', help='batch | time')
    args = p.parse_args(argv)
    from .main import launch
    device, mesh = launch(Config(mesh_shape=tuple(args.mesh_shape),
                                 shard_axis=args.shard_axis), args.device)
    try:
        out = bench(args.batch_size, args.use_fused_conv, args.steps, device,
                    args.steps_per_call, mesh=mesh, shard_axis=args.shard_axis)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
