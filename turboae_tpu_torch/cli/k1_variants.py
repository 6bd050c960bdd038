"""K1's design choices, measured: the shipped kernel against variants of its
own source (`kernels/csrc/conv_stack_f32.cu`) on one GPU.

Each variant is the shipped source with one change, made by text
substitution:
  regs168   every block on the 12-warp build, 168 registers a thread (the
            shipped launcher takes the 255-register build up to 8 warps);
  no_fold   each k-step's three MMAs summed straight into the layer's
            accumulators, not from zero and then added by an FADD;
  cvt_rna   TF32 rounding by cvt.rna.tf32.f32, not by an integer add and mask;
  presplit  the weights split into TF32 big and small planes by the packer,
            both planes through the ring (twice its bytes, so chunks of 32
            columns: 64 would not fit), not split in registers after
            ldmatrix;
  unroll2   the k-step loop unrolled twice, so that ptxas may load the next
            k-step's fragments during this one's MMAs;
and one variant of the plan alone:
  chunk32   weight chunks of 32 contraction columns, not 64.
The shipped kernel with one, two and three batch rows a block and each
variant with the plan the wrapper takes are built with nvcc (in parallel),
checked against the plain version and timed with CUDA events, launches
alone on weights packed once, at the conv-stack bench's shape (B=500,
L=100, Cin=7, C=100, K=5, 5 layers), every round in turn after one timing
of the wrapper, which packs the weights on every call; each build but presplit, whose doubled ring does not fit
there, is also checked at C=256 (B=100, three column groups of warps) with
the wrapper's plan. Prints the card's nvidia-smi line, then one JSON line per build
(ptxas registers and spills) and per timing.

    python -m turboae_tpu_torch.cli.k1_variants [--rounds 2]
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
from typing import Dict

import torch

from ..kernels import build
from ..kernels import conv_stack as ks
from ..ops.conv1d import stack_init
from ..utils.device import no_tf32, nvidia_smi, resolve_device

SOURCE = build.CSRC / 'conv_stack_f32.cu'

VARIANTS = {
    'regs168': [('nwarps <= WIDE_REG_WARPS ?', 'false ?')],
    'no_fold': [('''            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, as[i], bb);
            mma_tf32(d, ab[i], bs);
            mma_tf32(d, ab[i], bb);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j + h][q] += d[q];''', '''            mma_tf32(acc[i][j + h], as[i], bb);
            mma_tf32(acc[i][j + h], ab[i], bs);
            mma_tf32(acc[i][j + h], ab[i], bb);''')],
    'cvt_rna': [('  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;', '''  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;''')],
    'presplit': [
        ('const int stage = p.NW * p.SK;', 'const int stage = 2 * p.NW * p.SK;'),
        ('(size_t)(layer - 1) * p.NW * p.Kc', '(size_t)(layer - 1) * 2 * p.NW * p.Kc'),
        ('u < p.NW * q; u += blockDim.x', 'u < 2 * p.NW * q; u += blockDim.x'),
        ('''        uint32_t r[4];
        if (j + 1 < WN) ldsm_x4(bk + 4 * j * 8 * p.SK, r);
        else ldsm_x2(bk + 4 * j * 8 * p.SK, r);''', '''        uint32_t r[4], s[4];
        if (j + 1 < WN) {
          ldsm_x4(bk + 4 * j * 8 * p.SK, r);
          ldsm_x4(bk + 4 * (j * 8 + p.NW) * p.SK, s);
        } else {
          ldsm_x2(bk + 4 * j * 8 * p.SK, r);
          ldsm_x2(bk + 4 * (j * 8 + p.NW) * p.SK, s);
        }'''),
        ('''          uint32_t bb[2], bs[2];
          split(r[2 * h], bb[0], bs[0]);
          split(r[2 * h + 1], bb[1], bs[1]);''', '''          const uint32_t bb[2] = {r[2 * h], r[2 * h + 1]};
          const uint32_t bs[2] = {s[2 * h], s[2 * h + 1]};'''),
        ('(size_t)STAGES * p.NW * p.SK', '(size_t)STAGES * 2 * p.NW * p.SK')],
    'unroll2': [('    for (int ks = 0; ks < ksteps; ++ks) {',
                 '#pragma unroll 2\n    for (int ks = 0; ks < ksteps; ++ks) {')],
}


# plan fields that a variant of the plan alone overrides
PLAN_VARIANTS = {'chunk32': {'kch': 32, 'SK': 36}}
# and those of a variant of the source, where its plan must differ
VARIANT_PLANS = {'presplit': PLAN_VARIANTS['chunk32']}


def variant_sources(src: str) -> Dict[str, str]:
    """Every variant's source; raises if a substitution does not apply once."""
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise ValueError(f'variant {name}: {old[:60]!r} is not in the source once')
            text = text.replace(old, new)
        out[name] = text
    return out


def tf32_planes(w: torch.Tensor) -> torch.Tensor:
    """(..., NW, Kc) -> (..., 2 NW, Kc): the TF32 big part rna(w) above the
    small part rna(w - big), rna by the kernel's integer add and mask."""
    def rna(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    big = rna(w)
    return torch.cat([big, rna(w - big)], dim=-2).contiguous()


def _build(texts: Dict[str, str]):
    """name -> (launcher, ptxas report), all built in parallel."""
    out_dir = build.BUILD_DIR / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        (out_dir / f'{name}.cu').write_text(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, '-o', str(out_dir / f'{name}.so'),
             str(out_dir / f'{name}.cu')], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on variant {name}:\n{log}')
        fn = ctypes.CDLL(str(out_dir / f'{name}.so')).conv_stack_f32_launch
        fn.argtypes, fn.restype = ks._ARGTYPES, ctypes.c_int
        libs[name] = (fn, build.ptxas_report(log))
    return libs


def _launcher(fn, layers, x, plan, presplit=False):
    """Packs the weights once; returns call(), which launches fn on them."""
    w0, b0, wr, br = ks.pack_weights(layers, plan)
    if presplit:
        w0, wr = tf32_planes(w0), tf32_planes(wr)
    out = torch.empty((x.shape[0], x.shape[1], plan.C), device=x.device)
    ints = plan.as_ints()
    args = (x.data_ptr(), w0.data_ptr(), b0.data_ptr(), ks._ptr(wr), ks._ptr(br),
            out.data_ptr(), x.shape[0], (ctypes.c_int * len(ints))(*ints), len(ints),
            torch.cuda.current_stream(x.device).cuda_stream)

    def call():
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f'launch failed: CUDA error {rc}')
        return out
    return call


def _ms(fn, iters=20, warmup=3):
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--rounds', type=int, default=2)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != 'cuda':
        raise RuntimeError('k1_variants builds CUDA kernels: it needs a GPU')
    no_tf32()
    print(nvidia_smi(), flush=True)
    src = SOURCE.read_text()
    libs = _build({'shipped': src, **variant_sources(src)})
    for name, (_, report) in libs.items():
        print(json.dumps({'build': name, 'ptxas': list(report.values())}), flush=True)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(args.seed)

    def case(B, C):
        layers = stack_init(gen, 5, 7, C, 5, dev)
        x = torch.randn((B, 100, 7), generator=gen).to(dev)
        plan = ks.k1_plan(B, 100, 7, C, 5, 5, n_sm)
        return layers, x, ks.conv_stack_f32_plain(layers, x), plan

    def launcher(name, layers, x, plan):
        return _launcher(libs[name][0], layers, x, plan, name == 'presplit')

    def rel_err(call, ref):
        return ((call() - ref).abs().max() / ref.abs().max()).item()

    bench, wide = case(500, 100), case(100, 256)
    layers, x, ref, chosen = bench
    # (label, build, plan at the bench's shape)
    runs = [('shipped', 'shipped', ks.k1_layout(100, 7, 100, 5, 5, R)) for R in (1, 2, 3)]
    runs += [(name, name, dataclasses.replace(chosen, **VARIANT_PLANS.get(name, {})))
             for name in VARIANTS]
    runs += [(name, 'shipped', dataclasses.replace(chosen, **o))
             for name, o in PLAN_VARIANTS.items()]
    for name in [n for n in libs if n != 'presplit']:
        wl, wx, wref, wplan = wide
        print(json.dumps({'build': name, 'c256_max_rel_err':
                          rel_err(launcher(name, wl, wx, wplan), wref)}), flush=True)
    for rnd in range(args.rounds):
        print(json.dumps({'round': rnd, 'kernel': 'wrapper', 'R': chosen.R,
                          'ms': _ms(lambda: ks.conv_stack_f32(layers, x))}), flush=True)
        for label, name, plan in runs:
            call = launcher(name, layers, x, plan)
            print(json.dumps({'round': rnd, 'kernel': label, 'R': plan.R, 'warps': plan.nwarps,
                              'kch': plan.kch, 'ms': _ms(call),
                              'max_rel_err': rel_err(call, ref)}), flush=True)


if __name__ == '__main__':
    main()
