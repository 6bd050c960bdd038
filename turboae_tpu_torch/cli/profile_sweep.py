"""Where an evaluation sweep's time goes on the GPU.

Runs a few batches of the fused sweep of a checkpoint (the crown's by
default, bf16; `--encoder Turbo_rate3_757` with artifacts/deepturbo.msgpack
for DeepTurbo, whose dense stacks do not fuse; `--encoder`/`--decoder` take
the RNN zoo's keys too) under torch.profiler and prints one JSON line: wall
time, the device's busy time (the sum of its kernels' and copies' times; one
stream, so they do not overlap) and its share of the wall time, and the
device time of each kernel by name, largest first. With
`--ftae_power_alloc none|pos|pos_phase` the checkpoint is an FTAE one, swept
as cli/eval_ftae.py sweeps it (block_len 50, feedback at 40 dB).

    python -m turboae_tpu_torch.cli.profile_sweep --batches 3
    python -m turboae_tpu_torch.cli.profile_sweep --ckpt artifacts/deepturbo.msgpack \
        --encoder Turbo_rate3_757
    python -m turboae_tpu_torch.cli.profile_sweep --ckpt artifacts/ftae_pa.msgpack \
        --ftae_power_alloc pos_phase --dtype float32
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..config import Config
from ..train.sweep import sweep
from ..utils.device import no_tf32, resolve_device
from .eval_flagship import load_flagship


def _device_us(evt) -> float:
    # the attribute was renamed from *_cuda_* to *_device_* in recent PyTorch
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--ckpt', default='artifacts/flagship.msgpack')
    p.add_argument('--encoder', default='TurboAE_rate3_cnn')
    p.add_argument('--decoder', default='TurboAE_rate3_cnn')
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--ftae_power_alloc', default='',
                   help='none | pos | pos_phase: the checkpoint is an FTAE one')
    p.add_argument('--batches', type=int, default=3)
    p.add_argument('--batch_size', type=int, default=2000)
    p.add_argument('--snr', type=float, default=0.0)
    p.add_argument('--top', type=int, default=12)
    args = p.parse_args(argv)

    dev = resolve_device('cuda')
    no_tf32()
    if args.ftae_power_alloc:
        from ..train.checkpoint import load_checkpoint
        from ..train.ftae_trainer import FTAETrainer
        from ..train.msgpack_io import load_msgpack
        from .eval_ftae import check_power_alloc
        saved = load_msgpack(args.ckpt)
        check_power_alloc(args.ckpt, saved.get('params', saved), args.ftae_power_alloc)
        tr = FTAETrainer(Config(batch_size=args.batch_size, block_len=50, dtype=args.dtype,
                                fb_channel_low=40.0, fb_channel_high=40.0,
                                ftae_power_alloc=args.ftae_power_alloc), dev)
        tr.params = load_checkpoint(args.ckpt, tr.params)

        def run(n):
            tr.sweep([args.snr], num_block=n, verbose=False)
    else:
        params = load_flagship(args.ckpt, dev)
        cfg = Config(batch_size=args.batch_size, encoder=args.encoder, decoder=args.decoder,
                     dtype=args.dtype, use_fused_conv=True)
        gen = torch.Generator(device=dev).manual_seed(0)

        def run(n):
            sweep(params, cfg, [args.snr], num_block=n, device=dev, generator=gen)
    run(args.batch_size)
    torch.cuda.synchronize(dev)

    n_blocks = args.batches * args.batch_size
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_blocks)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host op's device time repeats its kernels'
    rows = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    print(json.dumps({
        'device': torch.cuda.get_device_name(dev), 'ckpt': args.ckpt,
        'encoder': args.encoder, 'decoder': args.decoder, 'dtype': args.dtype,
        'ftae_power_alloc': args.ftae_power_alloc, 'batches': args.batches,
        'batch_size': args.batch_size, 'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
        'busy_share': busy_ms / wall_ms, 'blocks_per_s': n_blocks / wall_ms * 1e3,
        'kernels': [{'name': k[:120], 'calls': c, 'ms': ms, 'share_of_busy': ms / busy_ms}
                    for k, c, ms in rows[:args.top]]}))


if __name__ == '__main__':
    main()
