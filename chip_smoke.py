#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device       the card (nvidia-smi name and power limit, torch's name);
  build        nvcc build of every CUDA source of the port (seconds; ~0 if cached);
  kernel_check each kernel against its plain PyTorch version on the card, at
               the main path's shape and at edge shapes (one layer, K=1, odd B,
               C and L that are no multiple of the kernel's tile);
  forward      the crown checkpoint's forward on the card against the port's
               own forward on the CPU, on the same small input;
  crown_sweep  the main path: the crown's bf16 evaluation sweep through the
               fused decoder (-1 dB and 0 dB, 20,000 blocks each, batch 2000),
               held to artifacts/eval_crown_r4.json by a two-proportion z test,
               with the kernel's launch count read around it;
  times        CUDA-event times of each kernel, its plain version and a
               PyTorch library yardstick, beside the card's bound;
then the nvidia-smi line, the kernels' summary line, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result. Without a GPU it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published dense peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SWEEP_POINTS = (-1.0, 0.0)
SWEEP_BLOCKS = 20000
SWEEP_BATCH = 2000
MAX_Z = 4.0
KERNEL_REL_TOL = 1e-2       # bf16 tolerance of the Pallas kernel tests (tests/test_kernels.py:33-41)


def emit(phase: str, **fields):
    print(json.dumps({'phase': phase, **fields}), flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn() over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def conv_stack_work(B, L, Cin, C, K, nl):
    """(FLOP, bytes) one conv-stack call needs: each input read once (x and
    weights bf16, biases f32), the bf16 output written once."""
    macs = B * L * (K * Cin * C + (nl - 1) * K * C * C)
    n_w = K * Cin * C + (nl - 1) * K * C * C
    nbytes = B * L * Cin * 2 + n_w * 2 + nl * C * 4 + B * L * C * 2
    return 2 * macs, nbytes


def random_stack(gen, nl, cin, c, k, device):
    layers = []
    for i in range(nl):
        fan = (cin if i == 0 else c) * k
        bound = 1.0 / math.sqrt(fan)
        w = (torch.rand((c, cin if i == 0 else c, k), generator=gen) * 2 - 1) * bound
        b = (torch.rand((c,), generator=gen) * 2 - 1) * bound
        layers.append({'w': w.to(device), 'b': b.to(device)})
    return layers


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from turboae_tpu_torch.cli.eval_flagship import load_flagship
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.kernels import build
    from turboae_tpu_torch.kernels import conv_stack as ks
    from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms
    from turboae_tpu_torch.train.sweep import params_to, sweep
    from turboae_tpu_torch.utils.metrics import snr_db2sigma, two_proportion_z

    # f32 references in full f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)

    # ---- device ----
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit('device', nvidia_smi=smi, torch_name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build ----
    t0 = time.perf_counter()
    built = build.build([ks.LIBRARY])
    regs = [ln.strip() for b in built.values() for ln in b.log.splitlines()
            if 'registers' in ln or 'spill' in ln]
    emit('build', seconds=time.perf_counter() - t0,
         libraries={n: {'seconds': b.seconds, 'cached': b.seconds == 0.0} for n, b in built.items()},
         ptxas=regs)

    # ---- kernel_check: K2 against its plain version on the card ----
    crown = load_flagship(os.path.join(ROOT, 'artifacts', 'flagship.msgpack'), dev)
    gen = torch.Generator().manual_seed(0)
    main_shape = (SWEEP_BATCH, 100, 7, 100, 5, 5)     # B, L, Cin, C, K, layers
    cases = [('main_path', main_shape, crown['dec']['iters'][0]['dec1_cnn']),
             ('one_layer', (2000, 100, 7, 100, 5, 1), None),
             ('k1', (256, 100, 7, 100, 1, 3), None),
             ('odd_b', (333, 100, 7, 100, 5, 5), None),
             ('ragged', (5, 23, 3, 30, 3, 2), None)]
    max_abs = {}
    for name, (B, L, cin, c, k, nl), layers in cases:
        layers = layers or random_stack(gen, nl, cin, c, k, dev)
        x = torch.randn((B, L, cin), generator=gen).to(dev)
        got = ks.conv_stack_bf16(layers, x)
        ref = ks.conv_stack_bf16_plain(layers, x)
        torch.cuda.synchronize()
        check(got.shape == (B, L, c) and got.dtype == torch.bfloat16, f'{name}: shape/dtype')
        check(bool(torch.isfinite(got.float()).all()), f'{name}: non-finite output')
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        emit('kernel_check', kernel='conv_stack_bf16', case=name, shape=[B, L, cin, c, k, nl],
             max_abs_err=err, max_rel_err=rel, tol=KERNEL_REL_TOL)
        check(rel < KERNEL_REL_TOL, f'{name}: relative error {rel} >= {KERNEL_REL_TOL}')
        max_abs[name] = err

    # ---- forward: the crown on the card against the port on the CPU ----
    crown_cpu = params_to(crown, 'cpu')
    bits = (torch.rand((64, 100, 1), generator=gen) < 0.5).float()
    noise = snr_db2sigma(0.0) * torch.randn((64, 100, 3), generator=gen)
    outs = {}
    for dtype, fused in (('float32', False), ('bfloat16', True)):
        cfg = Config(dtype=dtype, use_fused_conv=fused)
        with torch.inference_mode():
            g_out = forward_ae(crown, cfg, bits.to(dev), noise.to(dev), make_perms(cfg, dev),
                               training=False)[0].cpu()
            c_out = forward_ae(crown_cpu, cfg, bits, noise, make_perms(cfg, 'cpu'),
                               training=False)[0]
        check(g_out.shape == (64, 100, 1) and bool(torch.isfinite(g_out).all()),
              f'{dtype} forward: shape or non-finite values')
        outs[dtype] = {'max_abs_diff': (g_out - c_out).abs().max().item(),
                       'decision_agreement': (g_out.round() == c_out.round()).float().mean().item()}
    emit('forward', batch=64, snr_db=0.0, **outs)
    # f32: same arithmetic on both sides up to summation order
    check(outs['float32']['max_abs_diff'] < 1e-4, 'f32 forward differs from the CPU')
    # bf16 fused: kernel on the card, plain version on the CPU; roundings to
    # bf16 may differ by one ulp and move a probability near 0.5 across it
    check(outs['bfloat16']['decision_agreement'] > 0.99, 'bf16 fused decisions differ')

    # ---- crown_sweep: the main path ----
    with open(os.path.join(ROOT, 'artifacts', 'eval_crown_r4.json')) as f:
        ref = json.load(f)
    cfg = Config(batch_size=SWEEP_BATCH, dtype='bfloat16', use_fused_conv=True)
    sweep_gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    ks.conv_stack_bf16.launches = 0
    t0 = time.perf_counter()
    res = sweep(crown, cfg, list(SWEEP_POINTS), num_block=SWEEP_BLOCKS, device=dev,
                generator=sweep_gen)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = ks.conv_stack_bf16.launches
    n_batches = SWEEP_BLOCKS // SWEEP_BATCH
    points = []
    for i, snr in enumerate(SWEEP_POINTS):
        j = ref['snr'].index(snr)
        z = two_proportion_z(res['blk_errors'][i], res['n_blocks'],
                             ref['blk_errors'][j], ref['n_blocks'][j])
        points.append({'snr': snr, 'blk_errors': res['blk_errors'][i],
                       'bit_errors': res['bit_errors'][i], 'n_blocks': res['n_blocks'],
                       'bler': res['bler'][i], 'ber': res['ber'][i],
                       'ref_bler': ref['bler'][j], 'ref_ber': ref['ber'][j], 'z_bler': z})
    blocks_per_s = res['n_blocks'] * len(SWEEP_POINTS) / sweep_s
    emit('crown_sweep', points=points, launches=launches,
         expected_launches=12 * n_batches * len(SWEEP_POINTS), seconds=sweep_s,
         blocks_per_s=blocks_per_s)
    check(launches == 12 * n_batches * len(SWEEP_POINTS),
          f'conv_stack_bf16 launched {launches} times in the sweep')
    for p in points:
        check(abs(p['z_bler']) < MAX_Z, f"BLER at {p['snr']} dB: z = {p['z_bler']}")

    # ---- times at the main path's shape ----
    B, L, cin, c, k, nl = main_shape
    layers = crown['dec']['iters'][0]['dec1_cnn']
    x = torch.randn((B, L, cin), generator=gen).to(dev)
    ms = cuda_ms(lambda: ks.conv_stack_bf16(layers, x), iters=20)
    plain_ms = cuda_ms(lambda: ks.conv_stack_bf16_plain(layers, x), iters=10)
    # yardstick only, never called by the port: five cuDNN bf16 conv1d + ELU
    xl = x.to(torch.bfloat16).transpose(1, 2).contiguous()
    lw = [(p['w'].to(torch.bfloat16), p['b'].to(torch.bfloat16)) for p in layers]

    def library_chain():
        h = xl
        for w, b in lw:
            h = torch.nn.functional.elu(torch.nn.functional.conv1d(h, w, b, padding=k // 2))
        return h
    library_ms = cuda_ms(library_chain, iters=20)
    flops, nbytes = conv_stack_work(B, L, cin, c, k, nl)
    compute_ms = flops / PEAK_BF16_FLOPS * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(compute_ms, memory_ms)
    emit('times', kernel='conv_stack_bf16', shape=list(main_shape), ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, flops=flops, bytes=nbytes, compute_bound_ms=compute_ms,
         memory_bound_ms=memory_ms, bound_ms=bound_ms, achieved_tflops=flops / ms / 1e9,
         sweep_blocks_per_s=blocks_per_s, card=smi)

    # ---- summary ----
    print(smi, flush=True)
    print(json.dumps({'kernels': [{
        'name': 'conv_stack_bf16', 'route': 'cuda',
        'source': 'turboae_tpu_torch/kernels/csrc/conv_stack_bf16.cu',
        'replaces': 'turboae_tpu/kernels/conv_stack.py:250',
        'launches': launches, 'max_abs_err': max(max_abs.values()),
        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': 'operations' if compute_ms >= memory_ms else 'bytes',
        'library_ms': library_ms}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
