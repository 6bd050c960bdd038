"""Capture a torch.profiler trace of the flagship's train steps and break
its device time down by category (the port of scripts/profile_step.py).

Two subcommands, so that the capture (on the card) and the report (on any
machine, from the trace file alone) can run apart:

    python -m turboae_tpu_torch.cli.profile_step capture --out logs/trace_step.json \
        [--use_fused_conv] [--mode decoder]
    python -m turboae_tpu_torch.cli.profile_step report --trace logs/trace_step.json

`capture` runs the bench's training config (cli/bench_train.py: batch 500,
K=100, bf16; decoder steps, as the JAX script traces `_step_dec`), warms up
outside the trace, and writes the Chrome trace of `--steps` steps with the
card's name and power limit (utils/device.py:describe) under the trace's
"turboae" key; it prints one JSON line naming the file.

`report` sums the self time of the trace's device events (the kernels,
copies and sets that run on the card; one stream, so they do not overlap)
by category and prints one JSON line: each category's microseconds and share
of the total (the categories sum to it), and the largest kernels. The
categories, by the kernel's name: the port's kernels K2 (conv_stack_bf16)
and K1 (conv_stack_f32), cuDNN convolution forward and backward, GEMM,
elementwise/reduce, copy/transpose (copies, sets, gathers and
concatenations), collectives (NCCL) and other. cli/profile_train.py reads the
device time by phase of a step; this tool reads it by kind of kernel.
"""
from __future__ import annotations

import argparse
import json
import os

CATEGORIES = ('K2 conv_stack_bf16', 'K1 conv_stack_f32', 'cudnn conv forward',
              'cudnn conv backward', 'gemm', 'elementwise/reduce', 'copy/transpose',
              'collectives', 'other')
# Kineto's categories of the events that run on the device
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
_COPY = ('copy', 'memcpy', 'memset', 'cat', 'index', 'gather', 'scatter', 'permute', 'fill')
# name fragments, lower case, tried in this order; PyTorch's own kernels
# (at::native) are copies or elementwise/reduce whatever their template
# arguments say
_RULES = (
    ('K2 conv_stack_bf16', ('conv_stack_bf16',)),
    ('K1 conv_stack_f32', ('conv_stack_f32',)),
    ('collectives', ('nccl',)),
    ('copy/transpose', ('nchwtonhwc', 'nhwctonchw', 'transpose', 'tensortransform')),
    ('cudnn conv backward', ('wgrad', 'dgrad', 'bprop', 'backward_data', 'backward_filter')),
    ('cudnn conv forward', ('fprop', 'conv', 'implicit_gemm', 'cudnn', 'winograd', 'fft')),
    ('gemm', ('gemm', 'cutlass', 'cublas', 'matmul', 'gemv', 'splitk')),
    ('copy/transpose', _COPY),
)


def category(name: str, cat: str = 'kernel') -> str:
    """The category of one device event."""
    if cat in ('gpu_memcpy', 'gpu_memset'):
        return 'copy/transpose'
    low = name.lower()
    if 'at::native' in low:
        return 'copy/transpose' if any(f in low for f in _COPY) else 'elementwise/reduce'
    for label, frags in _RULES:
        if any(f in low for f in frags):
            return label
    if any(f in low for f in ('elementwise', 'reduce', 'vectorized', 'foreach', 'multi_tensor',
                              'elu', 'sigmoid', 'philox', 'softmax', 'pointwise', 'triton')):
        return 'elementwise/reduce'
    return 'other'


def breakdown(trace: dict, top: int = 12) -> dict:
    """Device self time (us) by category of a Chrome trace's device events,
    with each category's share, and the `top` kernels by time."""
    per_cat = {c: 0.0 for c in CATEGORIES}
    per_name = {}
    for ev in trace.get('traceEvents', []):
        if ev.get('ph') != 'X' or ev.get('cat') not in DEVICE_CATS:
            continue
        dur = float(ev.get('dur', 0.0))
        c = category(ev.get('name', ''), ev['cat'])
        per_cat[c] += dur
        calls, us, _ = per_name.get(ev.get('name', ''), (0, 0.0, c))
        per_name[ev.get('name', '')] = (calls + 1, us + dur, c)
    total = sum(per_cat.values())
    return {'total_us': total,
            'categories': {c: {'us': us, 'share': us / total if total else 0.0}
                           for c, us in sorted(per_cat.items(), key=lambda kv: -kv[1])},
            'top': [{'name': n[:120], 'calls': k, 'us': us, 'category': c}
                    for n, (k, us, c) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:top]]}


def capture(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import Config
    from ..train.trainer import Trainer
    from ..utils.device import describe, no_tf32, resolve_device
    dev = resolve_device(args.device)
    no_tf32()
    cfg = Config(batch_size=args.batch_size, block_len=100, num_block=args.batch_size,
                 train_dec_channel_low=-1.5, train_dec_channel_high=2.0, dtype=args.dtype,
                 use_fused_conv=args.use_fused_conv)
    trainer = Trainer(cfg, dev)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
    for _ in range(3):                  # warm up outside the trace
        trainer._train_step(args.mode)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == 'cuda' else [])
    with profile(activities=acts) as prof:
        for _ in range(args.steps):
            trainer._train_step(args.mode)
        sync()
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    prof.export_chrome_trace(args.out)
    meta = {'device': describe(dev), 'steps': args.steps, 'mode': args.mode,
            'batch_size': args.batch_size, 'dtype': args.dtype,
            'use_fused_conv': args.use_fused_conv, 'allow_tf32': False}
    with open(args.out) as f:
        trace = json.load(f)
    trace['turboae'] = meta
    with open(args.out, 'w') as f:
        json.dump(trace, f)
    out = {'trace': args.out, **meta}
    print(json.dumps(out))
    return out


def report(args) -> dict:
    with open(args.trace) as f:
        trace = json.load(f)
    out = {'trace': args.trace, **trace.get('turboae', {}), **breakdown(trace, args.top)}
    steps = out.get('steps')
    if steps:
        out['device_us_per_step'] = out['total_us'] / steps
    print(json.dumps(out))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    sub = p.add_subparsers(dest='cmd', required=True)
    c = sub.add_parser('capture')
    c.add_argument('--out', default='logs/trace_step.json')
    c.add_argument('--steps', type=int, default=3)
    c.add_argument('--batch_size', type=int, default=500)
    c.add_argument('--dtype', default='bfloat16')
    c.add_argument('--use_fused_conv', action='store_true')
    c.add_argument('--mode', default='decoder', help='encoder | decoder | joint')
    c.add_argument('--device', default='cuda')
    r = sub.add_parser('report')
    r.add_argument('--trace', default='logs/trace_step.json')
    r.add_argument('--top', type=int, default=12)
    args = p.parse_args(argv)
    return capture(args) if args.cmd == 'capture' else report(args)


if __name__ == '__main__':
    main()
