"""Micro-benchmark of the decoder's hot block: the fused conv-stack kernels
against PyTorch's unfused conv chain (the port of scripts/bench_conv_stack.py).

Times a 5-layer same-length Conv1d + ELU stack (B=500, L=100, Cin=7, C=100,
K=5 by default) four ways:
  torch_f32   the unfused stack, F.conv1d through cuDNN in f32, TF32 off;
  torch_bf16  the unfused stack in bf16;
  cuda_f32    K1, `kernels/conv_stack.py::conv_stack_f32`;
  cuda_bf16   K2, `kernels/conv_stack.py::conv_stack_bf16`.
Each is timed as n applications chained through a data dependency: a slice
of one output, through tanh, is the next input. CUDA events around the chain
give ms per application. Then the ratio of the best kernel to the best
unfused stack, and the numerics of both kernels against the f32 stack.

    python -m turboae_tpu_torch.cli.bench_conv_stack [--B 500] [--L 100] [--C 100]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..kernels import conv_stack as ks
from ..ops.conv1d import stack_apply, stack_init
from ..utils.device import no_tf32, resolve_device


def chained_ms(stack_fn, layers, x, n: int) -> float:
    """ms per application of n dependency-chained applications (after one
    warm-up chain); CUDA events on the card, the host clock on the CPU."""
    cin = x.shape[2]

    def chain():
        h = x
        for _ in range(n):
            h = torch.tanh(stack_fn(layers, h)[:, :, :cin].float())
        return h

    chain()
    if x.device.type != 'cuda':
        t0 = time.perf_counter()
        chain()
        return (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize(x.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    end.record()
    torch.cuda.synchronize(x.device)
    return start.elapsed_time(end) / n


def rows(args):
    """Runs the bench; returns {row name: ms} and a dict of the cross-checks."""
    dev = resolve_device(args.device)
    no_tf32()
    gen = torch.Generator().manual_seed(args.seed)
    layers = stack_init(gen, args.layers, args.Cin, args.C, args.K, dev)
    x = torch.randn((args.B, args.L, args.Cin), generator=gen).to(dev)
    fns = {
        'torch_f32': lambda l, h: stack_apply(l, h),
        'torch_bf16': lambda l, h: stack_apply(l, h, compute_dtype=torch.bfloat16),
        'cuda_f32': ks.conv_stack_f32,
        'cuda_bf16': ks.conv_stack_bf16,
    }
    results = {name: chained_ms(fn, layers, x, args.n) for name, fn in fns.items()}
    with torch.no_grad():
        ref = stack_apply(layers, x)
        scale = ref.abs().max().item()
        check = {f'{name}_max_rel_err': (fn(layers, x).float() - ref).abs().max().item() / scale
                 for name, fn in (('cuda_f32', ks.conv_stack_f32),
                                  ('cuda_bf16', ks.conv_stack_bf16))}
    return results, check


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--B', type=int, default=500)
    p.add_argument('--L', type=int, default=100)
    p.add_argument('--C', type=int, default=100)
    p.add_argument('--Cin', type=int, default=7)
    p.add_argument('--K', type=int, default=5)
    p.add_argument('--layers', type=int, default=5)
    p.add_argument('--n', type=int, default=100, help='chained applications timed')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    flops, _ = ks.conv_stack_work(args.B, args.L, args.Cin, args.C, args.K, args.layers, 4)
    results, check = rows(args)
    for name, ms in results.items():
        print(f'{name:12s} {ms:8.3f} ms   {flops / ms / 1e9:6.1f} TFLOP/s', flush=True)
    best_kernel = min(results['cuda_f32'], results['cuda_bf16'])
    best_torch = min(results['torch_f32'], results['torch_bf16'])
    print(f'cuda/torch best ratio: {best_kernel / best_torch:.3f} '
          f'({"cuda wins" if best_kernel < best_torch else "torch wins"})')
    for name, err in check.items():
        print(f'{name} vs torch f32: {err:.2e}')
    return results, check


if __name__ == '__main__':
    main()
