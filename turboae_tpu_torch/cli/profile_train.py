"""Where a training step's time goes on the GPU.

Runs the bench's training config (cli/bench_train.py: batch 500, bf16, the
1 encoder : 5 decoder schedule) and prints one JSON line:
  - phases: the device time of each phase of a step (sampling, forward,
    backward, optimizer), from CUDA events that the trainer records between
    them (`Trainer.marks`), summed over the steps and split by mode; the
    events bracket the stream, so a phase's time includes the device's idle
    gaps while the host launches its work;
  - kernels: a second run of the same steps under torch.profiler, with the
    wall time, the device's busy time and share, and the device time of
    each kernel by name, largest first.

    python -m turboae_tpu_torch.cli.profile_train --steps 12 [--use_fused_conv]

`--encoder Turbo_rate3_757` profiles DeepTurbo's decoder steps (its encoder
has no params, and its recipe no encoder phase; its dense stacks never
fuse). `--encoder`/`--decoder` take the RNN zoo's keys, `--dtype float32`
its training dtype:

    python -m turboae_tpu_torch.cli.profile_train --encoder Turboae_rate3_rnn \
        --decoder TurboAE_rate3_rnn --dtype float32 --batch_size 100
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import Config
from ..train.trainer import Trainer
from ..utils.device import no_tf32, resolve_device
from .profile_sweep import _device_us

PHASES = ('sampled', 'forward', 'backward', 'optimizer')


def _modes(steps: int, encoder_phase: bool = True):
    return ['encoder' if encoder_phase and i % 6 == 0 else 'decoder' for i in range(steps)]


def phase_ms(trainer: Trainer, steps: int, encoder_phase: bool = True) -> dict:
    """{mode: {phase: device ms summed over that mode's steps, 'steps': n}}."""
    out = {}
    for mode in _modes(steps, encoder_phase):
        trainer.marks = []
        trainer._train_step(mode)
        torch.cuda.synchronize(trainer.device)
        names = [n for n, _ in trainer.marks]
        assert names == ['start', *PHASES], names
        acc = out.setdefault(mode, {p: 0.0 for p in PHASES} | {'steps': 0})
        for (_, a), (name, b) in zip(trainer.marks, trainer.marks[1:]):
            acc[name] += a.elapsed_time(b)
        acc['steps'] += 1
    trainer.marks = None
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--steps', type=int, default=12)
    p.add_argument('--batch_size', type=int, default=500)
    p.add_argument('--use_fused_conv', action='store_true')
    p.add_argument('--encoder', default='TurboAE_rate3_cnn')
    p.add_argument('--decoder', default='TurboAE_rate3_cnn')
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--top', type=int, default=15)
    args = p.parse_args(argv)

    dev = resolve_device('cuda')
    no_tf32()
    cfg = Config(batch_size=args.batch_size, block_len=100, num_block=args.batch_size,
                 train_dec_channel_low=-1.5, train_dec_channel_high=2.0,
                 encoder=args.encoder, decoder=args.decoder, dtype=args.dtype,
                 use_fused_conv=args.use_fused_conv)
    trainer = Trainer(cfg, dev)
    encoder_phase = bool(trainer._leaves['enc'])
    for mode in ('decoder', 'encoder'):      # warm up both phases
        trainer._train_step(mode)
    torch.cuda.synchronize(dev)
    phases = phase_ms(trainer, args.steps, encoder_phase)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for mode in _modes(args.steps, encoder_phase):
            trainer._train_step(mode)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    print(json.dumps({
        'device': torch.cuda.get_device_name(dev), 'encoder': args.encoder,
        'decoder': args.decoder, 'dtype': args.dtype, 'use_fused_conv': args.use_fused_conv,
        'allow_tf32': False, 'batch_size': args.batch_size, 'steps': args.steps,
        'phases_ms': phases, 'profiled_wall_ms': wall_ms, 'device_busy_ms': busy_ms,
        'busy_share': busy_ms / wall_ms,
        'train_blocks_per_s': args.steps * args.batch_size / wall_ms * 1e3,
        'kernels': [{'name': k[:120], 'calls': c, 'ms': ms, 'share_of_busy': ms / busy_ms}
                    for k, c, ms in rows[:args.top]]}))


if __name__ == '__main__':
    main()
