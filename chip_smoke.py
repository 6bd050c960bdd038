#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device       the card (nvidia-smi name and power limit, torch's name);
  build        nvcc build of every CUDA source of the port, all in parallel
               (seconds; ~0 if cached); per kernel, ptxas's registers, shared
               memory and spills and the HMMA/HGMMA count of `cuobjdump -sass`
               (cuobjdump from beside nvcc); both kernels must show
               tensor-core instructions and no spills;
  kernel_check each kernel against its plain PyTorch version on the card, at
               its path's shape and at edge shapes (one or two layers, K=1, odd
               B, C and L that are no multiple of the kernel's tile, odd C,
               C=128 and 256, a partly filled last block) and at the
               long-block shape L=1000 that the wrappers window;
  forward      the crown checkpoint's forward on the card against the port's
               own forward on the CPU, on the same small input;
  crown_sweep  main path 1: the crown's bf16 evaluation sweep through the
               fused decoder (-1 dB and 0 dB, 20,000 blocks each, batch 2000),
               held to artifacts/eval_crown_r4.json by a two-proportion z test,
               with the kernels' launch counts read around it;
  train_step   from the crown's params and one batch of host-drawn bits and
               noise: a decoder, an encoder, a joint and an STE encoder step in
               f32, unfused, on the card against the port on the CPU;
  train        main path 2: one epoch of the flagship recipe from a seeded
               init at full width, bf16, fused (50 encoder steps, 5 decoder
               epochs of 50 steps, batch 500), then validate; launches read
               around it;
  train_times  the port of bench.py (cli/bench_train.py), fused on and off;
  conv_stack_bench  path 3: the port of scripts/bench_conv_stack.py, the only
               path of K1, with its launches read around it;
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
PEAK_BF16_FLOPS = 989e12       # tensor cores, bf16
PEAK_TF32_FLOPS = 495e12       # tensor cores, TF32: K1 does three TF32 products a product (3xTF32)
PEAK_F32_FLOPS = 67e12         # CUDA cores, f32 FFMA: the bound of exact f32 without the tensor cores
PEAK_BYTES_PER_S = 3.35e12

SWEEP_POINTS = (-1.0, 0.0)
SWEEP_BLOCKS = 20000
SWEEP_BATCH = 2000
MAX_Z = 4.0
KERNEL_REL_TOL = 1e-2       # bf16 tolerance of the Pallas kernel tests (tests/test_kernels.py:33-41)
F32_REL_TOL = 2e-5          # f32 tolerance of the Pallas kernel tests (tests/test_kernels.py:25-30)

TRAIN_BATCH = 500
TRAIN_NUM_BLOCK = 25000     # scripts/train_flagship.py defaults: 50 steps per epoch
# The last decoder epoch's mean loss (what scripts/train_flagship.py logs as
# dec_loss) must lie below this after one epoch of the recipe. Fixed before
# the first run on the card; the JAX trainer logged 0.159 there in f32
# (logs/flagship.jsonl:1), an untrained decoder ~0.69.
DEC_LOSS_MAX = 0.25
PARITY_BATCH = 64


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
    from turboae_tpu_torch.ops.conv1d import stack_init
    from turboae_tpu_torch.train.sweep import params_to, sweep
    from turboae_tpu_torch.utils.device import no_tf32
    from turboae_tpu_torch.utils.metrics import snr_db2sigma, two_proportion_z

    # f32 references in full f32: no TF32 in matmuls or cuDNN convolutions
    no_tf32()
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
    built = build.build(list(ks.LIBRARIES))
    libraries = {}
    for name, lib in built.items():
        ptxas = build.ptxas_report(lib.log)
        tensor_core = build.tensor_core_counts(build.sass(lib.path))
        libraries[name] = {'seconds': lib.seconds, 'cached': lib.seconds == 0.0,
                           'kernels': {k: {**ptxas.get(k, {}), 'hmma_hgmma': n}
                                       for k, n in tensor_core.items()}}
    emit('build', seconds=time.perf_counter() - t0, libraries=libraries)
    for name, lib in libraries.items():
        found = lib['kernels']
        check(bool(found) and all(v['hmma_hgmma'] > 0 for v in found.values()),
              f'{name} has no tensor-core instruction (HMMA/HGMMA) in its SASS')
        check(all('spill_stores' in v and v['spill_stores'] == v['spill_loads'] == 0
                  for v in found.values()), f'ptxas reports spills (or nothing) for {name}')

    # ---- kernel_check: each kernel against its plain version on the card ----
    crown = load_flagship(os.path.join(ROOT, 'artifacts', 'flagship.msgpack'), dev)
    gen = torch.Generator().manual_seed(0)
    main_shape = (SWEEP_BATCH, 100, 7, 100, 5, 5)     # B, L, Cin, C, K, layers
    bench_shape = (TRAIN_BATCH, 100, 7, 100, 5, 5)    # the conv-stack bench's, training's
    edge = [('one_layer', (2000, 100, 7, 100, 5, 1)), ('two_layers', (500, 100, 7, 100, 5, 2)),
            ('k1', (256, 100, 7, 100, 1, 3)), ('odd_b', (333, 100, 7, 100, 5, 5)),
            ('ragged', (5, 23, 3, 30, 3, 2)), ('long_block_l1000', (16, 1000, 7, 100, 5, 5))]
    # the tensor-core block layout of both kernels: odd C, one and several
    # column groups of warps, a last block that holds one of its three rows
    block_edge = [('odd_c', (500, 100, 7, 25, 5, 5)), ('c128', (500, 100, 7, 128, 5, 5)),
                  ('c256', (500, 100, 7, 256, 5, 5)), ('partial_block', (334, 100, 7, 100, 5, 5))]
    kernels = {  # name: (wrapper, plain, tolerance, cases)
        'conv_stack_bf16': (ks.conv_stack_bf16, ks.conv_stack_bf16_plain, KERNEL_REL_TOL,
                            [('main_path', main_shape, crown['dec']['iters'][0]['dec1_cnn'])]
                            + [(n, sh, None) for n, sh in edge + block_edge if n != 'two_layers']),
        'conv_stack_f32': (ks.conv_stack_f32, ks.conv_stack_f32_plain, F32_REL_TOL,
                           [('bench', bench_shape, None)]
                           + [(n, sh, None) for n, sh in edge + block_edge]),
    }
    max_abs = {}
    for kname, (wrapper, plain, tol, cases) in kernels.items():
        for name, (B, L, cin, c, k, nl), layers in cases:
            layers = layers or stack_init(gen, nl, cin, c, k, dev)
            x = torch.randn((B, L, cin), generator=gen).to(dev)
            before = wrapper.launches
            got = wrapper(layers, x)
            ref = plain(layers, x)
            torch.cuda.synchronize()
            check(wrapper.launches == before + 1, f'{kname} {name}: not one launch')
            check(got.shape == (B, L, c) and got.dtype == ref.dtype, f'{kname} {name}: shape/dtype')
            check(bool(torch.isfinite(got.float()).all()), f'{kname} {name}: non-finite output')
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            emit('kernel_check', kernel=kname, case=name, shape=[B, L, cin, c, k, nl],
                 max_abs_err=err, max_rel_err=rel, tol=tol)
            check(rel < tol, f'{kname} {name}: relative error {rel} >= {tol}')
            max_abs[kname] = max(max_abs.get(kname, 0.0), err)

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

    # ---- crown_sweep: main path 1 ----
    with open(os.path.join(ROOT, 'artifacts', 'eval_crown_r4.json')) as f:
        ref = json.load(f)
    cfg = Config(batch_size=SWEEP_BATCH, dtype='bfloat16', use_fused_conv=True)
    sweep_gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = sweep(crown, cfg, list(SWEEP_POINTS), num_block=SWEEP_BLOCKS, device=dev,
                generator=sweep_gen)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    paths = {'crown_sweep': read_counts()}
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
    expected = 12 * n_batches * len(SWEEP_POINTS)
    emit('crown_sweep', points=points, launches=paths['crown_sweep'],
         expected_launches=expected, seconds=sweep_s, blocks_per_s=blocks_per_s)
    check(paths['crown_sweep']['conv_stack_bf16'] == expected,
          f"conv_stack_bf16 launched {paths['crown_sweep']['conv_stack_bf16']} times in the sweep")
    for p in points:
        check(abs(p['z_bler']) < MAX_Z, f"BLER at {p['snr']} dB: z = {p['z_bler']}")

    # ---- train_step: f32 steps on the card against the CPU ----
    train_step_parity(crown, crown_cpu, dev, gen)

    # ---- train: main path 2, one epoch of the flagship recipe ----
    paths['train'] = train_epoch_phase(
        Config(batch_size=TRAIN_BATCH, num_block=TRAIN_NUM_BLOCK, dtype='bfloat16',
               use_fused_conv=True), dev)

    # ---- train_times: the port of bench.py, fused on and off ----
    train_times_phase(dev)

    # ---- conv_stack_bench: path 3, the only path of K1 ----
    paths['conv_stack_bench'] = conv_stack_bench_phase(dev)

    # ---- times: each kernel, its plain version, a library yardstick, its bound ----
    sweep_layers = crown['dec']['iters'][0]['dec1_cnn']
    times = {
        ('conv_stack_bf16', 'sweep'): time_kernel(ks.conv_stack_bf16, ks.conv_stack_bf16_plain,
                                                  torch.bfloat16, main_shape, sweep_layers, gen, dev),
        ('conv_stack_bf16', 'train'): time_kernel(ks.conv_stack_bf16, ks.conv_stack_bf16_plain,
                                                  torch.bfloat16, bench_shape, sweep_layers, gen, dev),
        ('conv_stack_f32', 'bench'): time_kernel(ks.conv_stack_f32, ks.conv_stack_f32_plain,
                                                 torch.float32, bench_shape, None, gen, dev),
    }
    for (kname, at), t in times.items():
        emit('times', kernel=kname, at=at, **t, card=smi)

    # ---- summary ----
    print(smi, flush=True)
    summary = []
    for kname, at, src, line in (('conv_stack_bf16', 'sweep', 'conv_stack_bf16.cu', 250),
                                 ('conv_stack_f32', 'bench', 'conv_stack_f32.cu', 137)):
        t = times[(kname, at)]
        by_path = {p: c[kname] for p, c in paths.items() if c[kname]}
        summary.append({
            'name': kname, 'route': 'cuda',
            'source': f'turboae_tpu_torch/kernels/csrc/{src}',
            'replaces': f'turboae_tpu/kernels/conv_stack.py:{line}',
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': max_abs[kname], 'ms': t['ms'], 'plain_ms': t['plain_ms'],
            'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
            'library_ms': t['library_ms'], 'shape': t['shape']})
    print(json.dumps({'kernels': summary}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


def train_epoch_phase(cfg, dev):
    """One epoch of the alternating recipe from a seeded init, then validate;
    returns the kernels' launch counts of the run."""
    from turboae_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    enc_losses = [trainer.train_epoch(0, 'encoder', verbose=False)
                  for _ in range(cfg.num_train_enc)]
    dec_losses = [trainer.train_epoch(0, 'decoder', verbose=False)
                  for _ in range(cfg.num_train_dec)]
    train_s = time.perf_counter() - t0
    val_bce, val_ber = trainer.validate(verbose=False)
    sync(dev)
    counts = read_counts()
    steps_per_epoch = max(1, cfg.num_block // cfg.batch_size)
    n_steps = steps_per_epoch * (cfg.num_train_enc + cfg.num_train_dec)
    forwards = n_steps + max(1, int(cfg.num_block / cfg.batch_size * cfg.test_ratio))
    emit('train', enc_losses=enc_losses, dec_losses=dec_losses, dec_loss=dec_losses[-1],
         dec_loss_max=DEC_LOSS_MAX, val_bce=val_bce, val_ber=val_ber, steps=n_steps,
         forwards=forwards, launches=counts, expected_launches=12 * forwards,
         train_seconds=train_s, train_blocks_per_s=n_steps * cfg.batch_size / train_s)
    check(all(math.isfinite(v) for v in enc_losses + dec_losses + [val_bce, val_ber]),
          'a training loss is not finite')
    check(counts['conv_stack_bf16'] == 12 * forwards,
          f"conv_stack_bf16 launched {counts['conv_stack_bf16']} times, "
          f'expected 12 x {forwards} forwards')
    check(dec_losses[-1] < DEC_LOSS_MAX, f'decoder loss {dec_losses[-1]} >= {DEC_LOSS_MAX}')
    return counts


def train_times_phase(dev, batch=TRAIN_BATCH, steps=60, **cfg_overrides):
    """cli/bench_train.py's timed loop, fused on and off, TF32 off."""
    from turboae_tpu_torch.cli.bench_train import bench
    from turboae_tpu_torch.kernels import conv_stack as ks
    out = {}
    for fused in (True, False):
        before = ks.conv_stack_bf16.launches
        r = bench(batch_size=batch, use_fused_conv=fused, steps=steps, device=dev,
                  **cfg_overrides)
        check(math.isfinite(r['last_loss']), 'bench_train: non-finite loss')
        check((ks.conv_stack_bf16.launches > before) == fused, 'bench_train: K2 launches')
        out['fused' if fused else 'unfused'] = r['value']
    emit('train_times', train_blocks_per_s=out, batch=batch, steps=steps,
         schedule='1 encoder : 5 decoder', dtype='bfloat16', allow_tf32=False)
    return out


def conv_stack_bench_phase(dev, argv=()):
    """cli/bench_conv_stack.py's rows; returns the launch counts of the run."""
    from turboae_tpu_torch.cli import bench_conv_stack
    args = bench_conv_stack.parse(['--device', str(dev), *argv])
    sync(dev)
    reset_counts()
    ms, numerics = bench_conv_stack.rows(args)
    sync(dev)
    counts = read_counts()
    emit('conv_stack_bench', ms=ms, check=numerics, launches=counts,
         shape=[args.B, args.L, args.Cin, args.C, args.K, args.layers])
    check(counts['conv_stack_f32'] > 0, 'K1 did not launch in its bench')
    check(counts['conv_stack_bf16'] > 0, 'K2 did not launch in its bench')
    check(numerics['cuda_f32_max_rel_err'] < F32_REL_TOL, 'K1 bench numerics')
    check(numerics['cuda_bf16_max_rel_err'] < KERNEL_REL_TOL, 'K2 bench numerics')
    return counts


def sync(dev):
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize(dev)


def reset_counts():
    from turboae_tpu_torch.kernels import conv_stack as ks
    ks.conv_stack_bf16.launches = 0
    ks.conv_stack_f32.launches = 0


def read_counts():
    from turboae_tpu_torch.kernels import conv_stack as ks
    return {'conv_stack_bf16': ks.conv_stack_bf16.launches,
            'conv_stack_f32': ks.conv_stack_f32.launches}


def time_kernel(wrapper, plain, dtype, shape, layers, gen, dev):
    """CUDA-event ms of the kernel, its plain version and five cuDNN conv1d +
    ELU in the kernel's type (TF32 off), with the bound of the same work: for
    bf16 its FLOP at the bf16 tensor-core peak; for f32 three TF32 products
    a product (K1's 3xTF32) at the TF32 peak, with exact f32 at the FFMA
    peak beside it."""
    from turboae_tpu_torch.ops.conv1d import stack_init
    B, L, cin, c, k, nl = shape
    layers = layers or stack_init(gen, nl, cin, c, k, dev)
    x = torch.randn((B, L, cin), generator=gen).to(dev)
    ms = cuda_ms(lambda: wrapper(layers, x), iters=20)
    plain_ms = cuda_ms(lambda: plain(layers, x), iters=10)
    # yardstick only, never called by the port
    xl = x.to(dtype).transpose(1, 2).contiguous()
    lw = [(p['w'].to(dtype), p['b'].to(dtype)) for p in layers]

    def library_chain():
        h = xl
        for w, b in lw:
            h = torch.nn.functional.elu(torch.nn.functional.conv1d(h, w, b, padding=k // 2))
        return h
    library_ms = cuda_ms(library_chain, iters=20)
    from turboae_tpu_torch.kernels.conv_stack import conv_stack_work
    itemsize = torch.finfo(dtype).bits // 8
    flops, nbytes = conv_stack_work(B, L, cin, c, k, nl, itemsize)
    if dtype == torch.bfloat16:
        peak, products, extra = PEAK_BF16_FLOPS, flops, {}
    else:
        peak, products = PEAK_TF32_FLOPS, 3 * flops
        extra = {'ffma_bound_ms': flops / PEAK_F32_FLOPS * 1e3}
    compute_ms = products / peak * 1e3
    memory_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {'shape': list(shape), 'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
            'flops': flops, 'tensor_core_flops': products, 'bytes': nbytes, 'peak_flops': peak,
            'compute_bound_ms': compute_ms, **extra, 'memory_bound_ms': memory_ms,
            'bound_ms': max(compute_ms, memory_ms),
            'bound_by': 'operations' if compute_ms >= memory_ms else 'bytes',
            'achieved_tflops': flops / ms / 1e9}


def train_step_parity(crown, crown_cpu, dev, gen, batch=PARITY_BATCH):
    """One step of each mode in f32, unfused, on the card and on the CPU from
    the same params, bits and noise (drawn on the host, noise at the
    decoder's training SNR mix). Tolerances: the loss to 1e-4 relative (f32,
    summation order only); gradients per leaf to 1e-3 of the leaf's largest;
    Adam's first step is ~lr * sign(g), so where |g| is below 1e-3 of the
    leaf's largest the sign is within the gradient tolerance and the update
    may flip (2 lr); elsewhere updated params agree to 1e-2 * lr."""
    from turboae_tpu_torch.channels.noise import train_sigma
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.trainer import Trainer
    bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
    noise = train_sigma((batch, 100, 3), -1.5, 2.0, gen, 'cpu') * \
        torch.randn((batch, 100, 3), generator=gen)
    for mode, extra in (('decoder', {}), ('encoder', {}), ('joint', {}),
                        ('encoder', {'train_channel_mode': 'block_norm_ste'})):
        cfg = Config(batch_size=batch, **extra)
        out = {}
        for where, params in (('gpu', crown), ('cpu', crown_cpu)):
            tr = Trainer(cfg, dev if where == 'gpu' else 'cpu', params=params)
            loss, grads = tr.loss_and_grads(mode, bits.to(tr.device), noise.to(tr.device))
            step_loss = tr._train_step(mode, bits.to(tr.device), noise.to(tr.device))
            out[where] = (loss.item(), step_loss.item(),
                          {h: [g.cpu() for g in gs] for h, gs in grads.items()},
                          {h: [p.cpu() for p in tr._leaves[h]] for h in grads})
        (lg, sg, gg, pg), (lc, sc, gc, pc) = out['gpu'], out['cpu']
        loss_rel = abs(lg - lc) / abs(lc)
        grad_rel, firm_dp, max_dp = 0.0, 0.0, 0.0
        for h in gc:
            lr = cfg.enc_lr if h == 'enc' else cfg.dec_lr
            for a, b, p, q in zip(gg[h], gc[h], pg[h], pc[h]):
                scale = b.abs().max().item()
                grad_rel = max(grad_rel, (a - b).abs().max().item() / scale)
                firm = b.abs() > 1e-3 * scale
                dp = (p - q).abs() / lr
                firm_dp = max(firm_dp, dp[firm].max().item() if firm.any() else 0.0)
                max_dp = max(max_dp, dp.max().item())
        emit('train_step', mode=mode, **extra, batch=batch, loss_gpu=lg, loss_cpu=lc,
             loss_rel=loss_rel, grad_rel=grad_rel, param_diff_firm_over_lr=firm_dp,
             param_diff_max_over_lr=max_dp)
        check(math.isfinite(lg) and abs(sg - lg) <= 1e-6 * abs(lg) and sc == lc,
              f'{mode}: the step did not see the loss it was given')
        check(loss_rel < 1e-4, f'{mode}: loss differs from the CPU by {loss_rel}')
        check(grad_rel < 1e-3, f'{mode}: gradients differ from the CPU by {grad_rel}')
        check(firm_dp < 1e-2 and max_dp <= 2.002, f'{mode}: updated params differ')


if __name__ == '__main__':
    sys.exit(main())
