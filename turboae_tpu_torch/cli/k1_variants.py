"""K1's design choices, measured: the shipped kernel against variants of its
own source (`kernels/csrc/conv_stack_f32.cu`) and of its plan on one GPU.

The shipped kernel runs the bench's shape (C=100, wgmma n104) as two batch
rows a block on two consumer warpgroups of 240 registers, each running two
m64 tiles against every ring chunk; for each tile a warpgroup issues the
twelve products of the chunk's four k8 steps into a partial set of
accumulators from zero, loads and splits the next tile's A fragments while
they run, and folds the partial set into the tile's accumulators by FADD
once a chunk. Each source variant is the shipped source with one change,
made by text substitution:
  no_prefetch   a tile's A fragments load after the last tile's fold, not
                under its products;
  fold_step     the fold every k8 step (a wait for the products each step);
  no_fold       no partial set: the products run straight into the tile's
                accumulators (a one-sided error grows with the contraction:
                see the source's header);
  wg4_no_fold   the two rows on four warpgroups of one tile each (112
                registers a thread: no room for the partial set, so no
                fold).
Plan variants, on the shipped build: r1 (one row a block: one tile a
warpgroup, 500 blocks), stages2, stages3 (a ring of 2 or 3 stages, not 4).
At the conv-stack bench's shape (B=500, L=100, Cin=7, C=100, K=5, 5
layers): the wrapper (which packs the weights on every call), the packing
alone, and each build and plan launched alone on weights packed once,
checked against the plain version and timed with CUDA events, every round
in turn; each build is also checked at C=256 (B=100 at L=64, two column
groups of n128, the longest contraction the tests hold), where the fold
decides the error. Prints the card's nvidia-smi line, then one JSON line per
build (ptxas registers and spills, HGMMA count) and per timing.

    python -m turboae_tpu_torch.cli.k1_variants [--rounds 2]
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
from typing import Dict

import torch

from ..kernels import build
from ..kernels import conv_stack as ks
from ..ops.conv1d import stack_init
from ..utils.device import no_tf32, nvidia_smi, resolve_device

SOURCE = build.CSRC / 'conv_stack_f32.cu'

_PRODUCTS = '''              Mma<N>::run(part, as[j][ks], db + 2 * ks, ks);    // from zero at the chunk's first
              Mma<N>::run(part, ab[j][ks], ds + 2 * ks, 1);
              Mma<N>::run(part, ab[j][ks], db + 2 * ks, 1);'''
_FOLD = '''          fence_operands(part);
#pragma unroll
          for (int i = 0; i < N / 2; ++i) acc[j][i] = c ? acc[j][i] + part[i] : part[i];   // the fold
'''
_NO_FOLD = [(_PRODUCTS, '''              Mma<N>::run(acc[j], as[j][ks], db + 2 * ks, c | ks);
              Mma<N>::run(acc[j], ab[j][ks], ds + 2 * ks, 1);
              Mma<N>::run(acc[j], ab[j][ks], db + 2 * ks, 1);'''),
            (_FOLD, '          fence_operands(acc[j]);\n')]

VARIANTS = {
    'no_prefetch': [('constexpr bool PREFETCH = true;', 'constexpr bool PREFETCH = false;')],
    'fold_step': [(_PRODUCTS, '''              Mma<N>::run(part, as[j][ks], db + 2 * ks, 0);
              Mma<N>::run(part, ab[j][ks], ds + 2 * ks, 1);
              Mma<N>::run(part, ab[j][ks], db + 2 * ks, 1);
              wgmma_commit();
              wgmma_wait_all();
              fence_operands(part);
#pragma unroll
              for (int n = 0; n < N / 2; ++n) acc[j][n] = (c | ks) ? acc[j][n] + part[n] : part[n];
              wgmma_fence();'''), (_FOLD, '')],
    'no_fold': _NO_FOLD,
    'wg4_no_fold': _NO_FOLD + [
        ('case 104: return launch<104, 2, 2>(', 'case 104: return launch<104, 4, 1>('),
        ('static_assert(INC >= (TPW + 1) * N / 2 + 32 * TPW + 16,',
         'static_assert(INC >= TPW * N / 2 + 32 * TPW + 16,')],
}
PLAN_VARIANTS = ('r1', 'stages2', 'stages3')


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


def variant_plan(name: str, plan: ks.K1Plan) -> ks.K1Plan:
    """The plan a variant runs with: wg4_no_fold's the shipped rows on one
    tile a warpgroup (four where the shipped plan has two); r1's one row a
    block; stages2 and stages3 cut the ring; the other source variants take
    the shipped plan."""
    if name == 'wg4_no_fold':
        return dataclasses.replace(plan, nc=plan.nc * plan.tpw, tpw=1)
    if name == 'r1':
        return ks.k1_layout(plan.L, plan.Cin, plan.C, plan.K, plan.num_layer, 1)
    if name.startswith('stages'):
        return dataclasses.replace(plan, stages=int(name[len('stages'):]))
    return plan


def _build(texts: Dict[str, str]):
    """name -> (launch function, ptxas report, SASS tensor-core counts)."""
    libs = {}
    for name, lib in build.build_texts(texts, build.BUILD_DIR / 'k1_variants').items():
        fn = ctypes.CDLL(str(lib.path)).conv_stack_f32_launch
        fn.argtypes, fn.restype = ks._ARGTYPES, ctypes.c_int
        libs[name] = (fn, build.ptxas_report(lib.log), build.tensor_core_counts(build.sass(lib.path)))
    return libs


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
    for name, (_, report, counts) in libs.items():
        print(json.dumps({'build': name, 'ptxas': list(report.values()),
                          'hgmma': [v['hgmma'] for v in counts.values()]}), flush=True)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(args.seed)

    def case(B, L, C):
        layers = stack_init(gen, 5, 7, C, 5, dev)
        x = torch.randn((B, L, 7), generator=gen).to(dev)
        plan = ks.k1_plan(B, L, 7, C, 5, 5, n_sm)
        return layers, x, ks.conv_stack_f32_plain(layers, x), plan

    def launcher(build_name, layers, x, plan):
        return ks._prepared(ks.conv_stack_f32, plan, layers, x, fn=libs[build_name][0])

    def rel_err(call, ref):
        return ((call() - ref).abs().max() / ref.abs().max()).item()

    layers, x, ref, plan = case(500, 100, 100)
    wl, wx, wref, wplan = case(100, 64, 256)
    for name in libs:
        print(json.dumps({'build': name, 'c256_max_rel_err':
                          rel_err(launcher(name, wl, wx, variant_plan(name, wplan)), wref)}),
              flush=True)
    # (label, build, plan at the bench's shape)
    runs = [(name, name, variant_plan(name, plan)) for name in libs]
    runs += [(name, 'shipped', variant_plan(name, plan)) for name in PLAN_VARIANTS]
    for rnd in range(args.rounds):
        print(json.dumps({'round': rnd, 'kernel': 'wrapper', 'R': plan.R,
                          'ms': _ms(lambda: ks.conv_stack_f32(layers, x)),
                          'pack_ms': _ms(lambda: ks.pack_weights(layers, plan))}), flush=True)
        for label, name, pl in runs:
            call = launcher(name, layers, x, pl)
            print(json.dumps({'round': rnd, 'kernel': label, 'R': pl.R, 'N': pl.N,
                              'nc': pl.nc, 'stages': pl.stages, 'ms': _ms(call),
                              'max_rel_err': rel_err(call, ref)}), flush=True)


if __name__ == '__main__':
    main()
