"""Step-level roofline of the flagship's decoder train step on the card (the
port of scripts/roofline.py).

For each batch size of `--batch_sizes` (the bench's config otherwise:
K=100, rate 1/3, 6 decoder iterations, decoder SNR -1.5..2.0 dB) it reports:

  - ms a decoder step, eager and, for each n > 1 of `--steps_per_call`, as
    replays of the CUDA graph of n steps (train/trainer.py);
  - FLOPs a step: the closed form `step_flops` beside FlopCounterMode's
    count of an unfused step (utils/flops.py); TFLOP/s and MFU against the
    card's dense peak in the config's dtype (utils/flops.py:PEAKS);
  - HBM bytes a step, the closed form `step_bytes` below, and GB/s against
    the card's HBM peak;
  - the peak memory of a step (torch.cuda.max_memory_allocated);

and once, the dispatch floor: the ms a launch of a chain of empty launches
(an in-place add on a 0-d tensor, synchronised once at the end). Prints
one JSON line and writes it to `--out`, with the card's name and power
limit. On the CPU (`--device cpu`, plain versions, tiny sizes) the rates
against a peak are null.

The closed forms. A decoder step is the encoder's forward (no gradient),
the decoder's forward and the decoder's backward, then Adam on the
decoder's params:
  step_flops = F_enc + 3 F_dec, with F the forward FLOPs of
    utils/flops.py:analytic_flops (2 B L K Cin Cout a conv layer, the heads'
    products); the backward computes each product twice (the gradients of
    the input and of the weights). FlopCounterMode counts a little less
    (autograd skips the first decoder layer's input gradient, and the last
    head emits one channel): 0.06 % at the flagship's width;
  step_bytes = the activations' bytes, each tensor once:
    forward, every conv layer and head of both halves reads its input and
    writes its output, B L (Cin + Cout) elements;
    backward, every conv layer and head of the decoder reads its input, its
    output and its output's gradient and writes its input's gradient,
    B L 2 (Cin + Cout) elements;
    conv activations in cfg.dtype's bytes, heads in f32 (the last decoder
    head writes one channel);
    plus Adam's 7 f32 words a decoder param (reads p, g, m, v; writes p, m,
    v). Weights read by the layers are left out: ~1 % of the activations at
    B = 500. Eager PyTorch moves more (ELU is its own kernel, a bf16 cast
    too), so the achieved GB/s is a lower bound of the traffic.

    python -m turboae_tpu_torch.cli.roofline --batch_sizes 250,500,1000,2000 \
        [--steps_per_call 1,6] [--use_fused_conv]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ..config import Config
from ..utils.flops import analytic_flops, counted_flops, peak


def flagship(batch_size: int, **kw) -> Config:
    return Config(batch_size=batch_size, block_len=100, num_block=batch_size,
                  train_dec_channel_low=-1.5, train_dec_channel_high=2.0, **kw)


def step_flops(cfg) -> int:
    """A decoder step's FLOPs in closed form: F_enc + 3 F_dec."""
    f = analytic_flops(cfg, cfg.batch_size)
    return f['encoder_flops'] + 3 * f['decoder_flops']


def _layers(n_layer: int, cin: int, c: int):
    """(Cin, Cout) of each conv layer of a plain stack."""
    return [(cin, c)] + [(c, c)] * (n_layer - 1)


def step_bytes(cfg, dec_params: int) -> int:
    """A decoder step's HBM bytes in closed form (the module's docstring)."""
    s = 2 if cfg.dtype == 'bfloat16' else 4
    bl = cfg.batch_size * cfg.block_len
    k, n, ft, U = cfg.code_rate_k, cfg.code_rate_n, cfg.num_iter_ft, cfg.dec_num_unit
    enc = 3 * (sum(a + b for a, b in _layers(cfg.enc_num_layer, k, cfg.enc_num_unit)) * s
               + (cfg.enc_num_unit + 1) * 4)
    half = sum(a + b for a, b in _layers(cfg.dec_num_layer, 2 + ft, U)) * s + (U + ft) * 4
    dec = 2 * cfg.num_iteration * half - (ft - 1) * 4     # the last head writes one channel
    return bl * (enc + 3 * dec) + 7 * 4 * dec_params


def dispatch_floor_ms(dev, n: int = 200) -> float:
    """ms a launch of a chain of n empty launches, one sync at the end."""
    x = torch.zeros((), device=dev)
    for _ in range(10):
        x.add_(1.0)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    _sync(dev)
    return (time.perf_counter() - t0) / n * 1e3


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _timed_ms(trainer, steps: int, n: int) -> float:
    """ms a decoder step over `steps` steps: eager (n 1) or as replays of
    the n-step graph; warmed up (and the graph captured) first."""
    dev = trainer.device
    groups = max(1, steps // n)
    if n > 1:
        trainer._train_steps('decoder', n, 1)
    else:
        trainer._train_step('decoder')
    _sync(dev)
    t0 = time.perf_counter()
    if n > 1:
        trainer._train_steps('decoder', n, groups)
    else:
        for _ in range(groups):
            trainer._train_step('decoder')
    _sync(dev)
    return (time.perf_counter() - t0) / (groups * n) * 1e3


def row(batch_size: int, args, dev) -> dict:
    from ..train.trainer import Trainer
    from ..utils.flops import count_params
    cfg = flagship(batch_size, dtype=args.dtype, use_fused_conv=args.use_fused_conv)
    counted = counted_flops(Trainer(cfg.replace(use_fused_conv=False), dev)._train_step,
                            'decoder')
    trainer = Trainer(cfg, dev)
    if dev.type == 'cuda':
        trainer._train_step('decoder')
        _sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        trainer._train_step('decoder')
        _sync(dev)
        peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6
    else:
        peak_mb = None
    ms = {n: _timed_ms(trainer, args.steps, n) for n in args.steps_per_call}
    flops = step_flops(cfg)
    nbytes = step_bytes(cfg, count_params(trainer.params['dec']))
    name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'
    flop_peak = peak(name, cfg.dtype) if dev.type == 'cuda' else None
    hbm_peak = peak(name, 'bytes_per_s') if dev.type == 'cuda' else None
    best = min(ms.values())
    tflops, gbs = flops / best / 1e9, nbytes / best / 1e6
    mfu = None if flop_peak is None else flops / (best / 1e3) / flop_peak
    hbm = None if hbm_peak is None else nbytes / (best / 1e3) / hbm_peak
    return {'batch': batch_size, 'ms_per_step': {str(n): t for n, t in ms.items()},
            'blocks_per_s': batch_size / best * 1e3, 'gflop_per_step': flops / 1e9,
            'counted_gflop_per_step': counted / 1e9, 'hbm_gb_per_step': nbytes / 1e9,
            'tflops_per_s': tflops, 'mfu': mfu, 'gb_per_s': gbs, 'hbm_share': hbm,
            'peak_memory_mb': peak_mb}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--batch_sizes', default='250,500,1000,2000')
    p.add_argument('--dtype', default='bfloat16')
    p.add_argument('--use_fused_conv', action='store_true')
    p.add_argument('--steps', type=int, default=30)
    p.add_argument('--steps_per_call', default='1,6',
                   help='comma list: 1 times eager steps, n > 1 replays of n-step CUDA graphs')
    p.add_argument('--device', default='cuda')
    p.add_argument('--out', default='logs/roofline.json')
    args = p.parse_args(argv)
    args.steps_per_call = [int(s) for s in args.steps_per_call.split(',')]
    from ..utils.device import describe, no_tf32, resolve_device
    dev = resolve_device(args.device)
    no_tf32()
    floor = dispatch_floor_ms(dev)
    rows = [row(int(b), args, dev) for b in args.batch_sizes.split(',')]
    out = {'device': describe(dev), 'dtype': args.dtype, 'use_fused_conv': args.use_fused_conv,
           'allow_tf32': False, 'dispatch_floor_ms': floor, 'rows': rows}
    os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
