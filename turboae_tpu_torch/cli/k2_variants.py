"""K2's design choices, measured: the shipped kernel against variants of its
own source (`kernels/csrc/conv_stack_bf16.cu`) and of its plan on one GPU.

Each source variant is the shipped source with one change, made by text
substitution, in how a consumer warpgroup groups its k16 steps (the
shipped kernel: groups of KB steps, 2 at n104 and 4 at the other widths,
each group's products waited for before the next group's A fragments
load):
  k4             groups of 4 steps at every width (16 A registers at n104);
  one_in_flight  one step a group, the next step's A fragments loading into
                 a second register set while it runs (wgmma.wait_group 1);
  two_in_flight  groups of 2 steps, two register sets, one group in flight;
  wg4            n104 on four consumer warpgroups (112 registers each, so
                 groups of 4 steps), with the plan's rows cut until its
                 tiles fit four (skipped where one row needs five).
Plan variants, on the shipped build:
  rows_ceil      Rmax rows a block and ceil(B / Rmax) blocks (the rule K2
                 had before its whole-rounds plan);
  rows_less      one row fewer a block, ceil(B / R) blocks;
  stages2, stages3  a ring of 2 or 3 stages, not 4.
At B=2000 and 500 (L=100) and at the K=1000 curve's windows (8000 rows of
270), with the crown checkpoint's first decoder stack (Cin=7, C=100, K=5, 5
layers): the wrapper (which packs the weights on every call), the packing
alone, and each build and plan launched alone on weights packed once,
checked against the plain version and timed with CUDA events, every round
in turn; then the shipped kernel on that stack's first layer alone (the
block's fixed costs and one epilogue). Prints the card's nvidia-smi line,
then one JSON line per build (ptxas registers and spills) and per timing.

    python -m turboae_tpu_torch.cli.k2_variants [--rounds 2]
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
from typing import Dict, Optional

import torch

from ..kernels import build
from ..kernels import conv_stack as ks
from ..utils.device import no_tf32, nvidia_smi, resolve_device
from .eval_flagship import load_flagship
from .k1_variants import _ms

SOURCE = build.CSRC / 'conv_stack_bf16.cu'

_LOOP = '''#pragma unroll
            for (int k0 = 0; k0 < 4; k0 += KB) {
              if (k0 >= nks) break;
#pragma unroll
              for (int i = 0; i < KB; ++i)
                if (k0 + i < nks) ldsm_x4(ak + 32 * (k0 + i), a[i]);
              wgmma_fence();
#pragma unroll
              for (int i = 0; i < KB; ++i)
                if (k0 + i < nks) Mma<N>::run(acc, a[i], d + 2 * (k0 + i), c | (k0 + i));
              wgmma_commit();
              wgmma_wait_all();      // the A registers (and, at the last, the stage) are free again
            }
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * s);
        }
        if (!active) continue;
'''
_RELEASE = '''              wgmma_commit();
              asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
              if (held >= 0) {     // the group before this one, the last reader of its stage
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + 8 * held);
                held = -1;
              }
            }
            held = s;
          } else {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * s);
          }
        }
        if (!active) continue;
        wgmma_wait_all();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * held);
'''
_HELD = ('        for (int c = 0; c < nch; ++c, ++t) {',
         '        int held = -1;\n        for (int c = 0; c < nch; ++c, ++t) {')

VARIANTS = {
    'k4': [('constexpr int KB = INC - N / 2 >= 48 ? 4 : 2;', 'constexpr int KB = 4;')],
    'wg4': [('case 104: return launch<104, 5>', 'case 104: return launch<104, 4>')],
    'one_in_flight': [_HELD, ('uint32_t a[KB][4];', 'uint32_t a[2][4];'), (_LOOP, '''#pragma unroll
            for (int ks = 0; ks < 4; ++ks) {
              if (ks >= nks) break;
              ldsm_x4(ak + 32 * ks, a[ks & 1]);
              wgmma_fence();
              Mma<N>::run(acc, a[ks & 1], d + 2 * ks, c | ks);
''' + _RELEASE)],
    'two_in_flight': [_HELD, ('uint32_t a[KB][4];', 'uint32_t a[2][2][4];'), (_LOOP, '''#pragma unroll
            for (int k0 = 0; k0 < 4; k0 += 2) {
              if (k0 >= nks) break;
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (k0 + i < nks) ldsm_x4(ak + 32 * (k0 + i), a[k0 / 2][i]);
              wgmma_fence();
#pragma unroll
              for (int i = 0; i < 2; ++i)
                if (k0 + i < nks) Mma<N>::run(acc, a[k0 / 2][i], d + 2 * (k0 + i), c | (k0 + i));
''' + _RELEASE)],
}


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


def plan_variants(plan: ks.K2Plan, B: int) -> Dict[str, ks.K2Plan]:
    """The plan variants of the docstring at a call of B rows."""
    r_max = plan.R
    while ks.k2_layout(plan.L, plan.Cin, plan.C, plan.K, plan.num_layer, r_max + 1).fits():
        r_max += 1
    args = (plan.L, plan.Cin, plan.C, plan.K, plan.num_layer)
    out = {'rows_ceil': ks.k2_layout(*args, r_max, -(-B // r_max)),
           'stages2': dataclasses.replace(plan, stages=2),
           'stages3': dataclasses.replace(plan, stages=3)}
    if r_max > 1:
        out['rows_less'] = ks.k2_layout(*args, r_max - 1, -(-B // (r_max - 1)))
    return out


def variant_plan(name: str, plan: ks.K2Plan, B: int) -> Optional[ks.K2Plan]:
    """The plan a source variant runs with: wg4's holds at most four m64
    tiles a block (None where one row needs more); the others take the
    shipped plan."""
    if name != 'wg4' or plan.nc <= 4:
        return plan
    for R in range(plan.R - 1, 0, -1):
        cut = ks.k2_layout(plan.L, plan.Cin, plan.C, plan.K, plan.num_layer, R, -(-B // R))
        if cut.nc <= 4:
            return cut
    return None


def _build(texts: Dict[str, str]):
    """name -> (launch function, ptxas report), all built in parallel."""
    libs = {}
    for name, lib in build.build_texts(texts, build.BUILD_DIR / 'k2_variants').items():
        fn = ctypes.CDLL(str(lib.path)).conv_stack_bf16_launch
        fn.argtypes, fn.restype = ks._ARGTYPES, ctypes.c_int
        libs[name] = (fn, build.ptxas_report(lib.log))
    return libs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--rounds', type=int, default=2)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--ckpt', default=os.path.join('artifacts', 'flagship.msgpack'))
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != 'cuda':
        raise RuntimeError('k2_variants builds CUDA kernels: it needs a GPU')
    no_tf32()
    print(nvidia_smi(), flush=True)
    src = SOURCE.read_text()
    libs = _build({'shipped': src, **variant_sources(src)})
    for name, (_, report) in libs.items():
        print(json.dumps({'build': name, 'ptxas': list(report.values())}), flush=True)
    layers = load_flagship(args.ckpt, dev)['dec']['iters'][0]['dec1_cnn']
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(args.seed)
    for B, L in ((2000, 100), (500, 100), (8000, 270)):
        x = torch.randn((B, L, 7), generator=gen).to(dev)
        ref = ks.conv_stack_bf16_plain(layers, x).float()
        plan = ks.k2_plan(B, L, 7, 100, 5, 5, n_sm)
        runs = [(name, name, variant_plan(name, plan, B)) for name in libs]
        runs = [r for r in runs if r[2] is not None]
        runs += [(name, 'shipped', pv) for name, pv in plan_variants(plan, B).items()]
        one = ks.k2_plan(B, L, 7, 100, 5, 1, n_sm)
        for rnd in range(args.rounds):
            print(json.dumps({'round': rnd, 'B': B, 'L': L, 'kernel': 'wrapper', 'R': plan.R,
                              'G': plan.G, 'ms': _ms(lambda: ks.conv_stack_bf16(layers, x)),
                              'pack_ms': _ms(lambda: ks.pack_weights_bf16(layers, plan))}),
                  flush=True)
            for label, name, pl in runs:
                call = ks._prepared(ks.conv_stack_bf16, pl, layers, x, fn=libs[name][0])
                ms = _ms(call)
                err = ((call().float() - ref).abs().max() / ref.abs().max()).item()
                print(json.dumps({'round': rnd, 'B': B, 'L': L, 'kernel': label, 'R': pl.R,
                                  'G': pl.G, 'stages': pl.stages, 'ms': ms,
                                  'max_rel_err': err}), flush=True)
            call = ks._prepared(ks.conv_stack_bf16, one, layers[:1], x, fn=libs['shipped'][0])
            print(json.dumps({'round': rnd, 'B': B, 'L': L, 'kernel': 'shipped_one_layer',
                              'R': one.R, 'G': one.G, 'ms': _ms(call)}), flush=True)


if __name__ == '__main__':
    main()
