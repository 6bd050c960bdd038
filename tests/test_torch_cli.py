"""The port's benchmark entry points, driven on the CPU at small sizes: the
control flow, the rows and the JSON line. Their times mean nothing here; on
the card chip_smoke.py runs them at full size."""
import json
import math

import numpy as np

import _torch_parity  # noqa: F401  (one PyTorch thread per test worker)
from turboae_tpu_torch.cli import bench_conv_stack, bench_train

NARROW = dict(enc_num_unit=12, dec_num_unit=12, num_iteration=2)


def test_bench_conv_stack_rows_on_cpu(capsys):
    results, check = bench_conv_stack.main(['--device', 'cpu', '--B', '3', '--C', '16',
                                            '--n', '2'])
    assert set(results) == {'torch_f32', 'torch_bf16', 'cuda_f32', 'cuda_bf16'}
    assert all(math.isfinite(v) and v > 0 for v in results.values())
    # on the CPU the kernel rows run the plain versions: K1's is f32-exact
    # up to summation order, K2's rounds to bf16 (< 1e-2 relative)
    assert check['cuda_f32_max_rel_err'] < 2e-5 and check['cuda_bf16_max_rel_err'] < 1e-2
    out = capsys.readouterr().out
    assert 'cuda/torch best ratio' in out and out.count('TFLOP/s') == 4


def test_bench_conv_stack_defaults_are_the_benchs():
    a = bench_conv_stack.parse([])
    assert (a.B, a.L, a.C, a.Cin, a.K, a.layers, a.n) == (500, 100, 100, 7, 5, 5, 100)


def test_bench_train_json_line_on_cpu():
    out = bench_train.bench(batch_size=4, steps=6, device='cpu', use_fused_conv=True, **NARROW)
    json.dumps(out)
    assert out['metric'] == 'train_blocks_per_s' and out['value'] > 0
    assert out['mfu'] is None and out['use_fused_conv'] and not out['allow_tf32']
    assert np.isfinite(out['last_loss']) and out['device'] == 'cpu'
    # the FLOPs of a step of each phase are counted on the CPU too; the MFU
    # needs a card's peak
    assert set(out['step_flops']) == {'enc', 'dec'}
    assert all(v > 0 for v in out['step_flops'].values())
    assert out['tflops_per_s'] > 0 and out['mfu_reason'] == 'no MFU on the CPU'


def test_bench_train_times_graph_groups_on_cpu():
    """--steps_per_call 3: the encoder's 2 and the decoder's 10 of 12 steps,
    in groups of 3 (eager on the CPU) and the rest one by one."""
    out = bench_train.main(['--device', 'cpu', '--batch_size', '4', '--steps', '12',
                            '--steps_per_call', '3'])
    assert out['steps_per_call'] == 3 and out['steps'] == 12 and out['value'] > 0
    assert np.isfinite(out['last_loss']) and out['mfu'] is None


def test_bench_train_defaults_are_bench_py():
    import inspect
    sig = inspect.signature(bench_train.bench)
    assert sig.parameters['batch_size'].default == 500
    assert sig.parameters['steps'].default == 60


def test_k1_variants_apply_to_the_source():
    """cli/k1_variants.py times K1 against variants of its own source: each
    substitution must still find its text in the shipped kernel, once."""
    from turboae_tpu_torch.cli import k1_variants
    src = k1_variants.SOURCE.read_text()
    texts = k1_variants.variant_sources(src)
    assert set(texts) == {'no_prefetch', 'fold_step', 'no_fold', 'wg4_no_fold'}
    assert len({src, *texts.values()}) == 5
    assert 'PREFETCH = false;' in texts['no_prefetch'] and 'PREFETCH = true;' in src
    for name in ('no_fold', 'wg4_no_fold'):
        assert '// the fold' not in texts[name] and '// the fold' in src
    assert 'launch<104, 4, 1>' in texts['wg4_no_fold'] and 'launch<104, 2, 2>' in src


def test_k2_variants_apply_to_the_source():
    """cli/k2_variants.py times K2 against variants of its own source: each
    substitution must still find its text in the shipped kernel, once."""
    from turboae_tpu_torch.cli import k2_variants
    src = k2_variants.SOURCE.read_text()
    texts = k2_variants.variant_sources(src)
    assert set(texts) == {'k4', 'wg4', 'one_in_flight', 'two_in_flight'}
    assert len({src, *texts.values()}) == 5
    for name in ('one_in_flight', 'two_in_flight'):
        assert 'wgmma.wait_group.sync.aligned 1' in texts[name]
    assert 'wgmma.wait_group.sync.aligned 1' not in src


def test_k2_plan_variants():
    """Its plan variants at B=2000 on 132 SMs: the rule K2 had (3 rows, 667
    blocks, a sixth round of 7), one row fewer (1000 blocks), and rings of 2
    and 3 stages; each fits a block."""
    from turboae_tpu_torch.cli import k2_variants
    from turboae_tpu_torch.kernels import conv_stack as ks
    plan = ks.k2_plan(2000, 100, 7, 100, 5, 5, n_sm=132)
    v = k2_variants.plan_variants(plan, 2000)
    assert (v['rows_ceil'].R, v['rows_ceil'].G) == (3, 667)
    assert (v['rows_less'].R, v['rows_less'].G) == (2, 1000)
    assert (v['stages2'].stages, v['stages3'].stages, plan.stages) == (2, 3, 4)
    assert all(p.fits() for p in v.values())
    # wg4: at most four m64 tiles a block, so 2 rows at L=100; none at L=270
    wg4 = k2_variants.variant_plan('wg4', plan, 2000)
    assert (wg4.R, wg4.G, wg4.nc) == (2, 1000, 4)
    assert k2_variants.variant_plan('k4', plan, 2000) is plan
    assert k2_variants.variant_plan('wg4', ks.k2_plan(8000, 270, 7, 100, 5, 5, n_sm=132),
                                    8000) is None


def test_k1_variants_tf32_planes():
    """The planes every K1 build launches on (the packer's `tf32_split`):
    TF32 big and small parts, low 13 bits zero, whose sum is the weight to
    2^-22 relative; and the plans the variants run with at the bench's
    shape: the shipped two rows on two warpgroups of two tiles against four
    of one (wg4_no_fold) and one row a block (r1), rings of 2 and 3 stages,
    the shipped plan otherwise."""
    import torch
    from turboae_tpu_torch.cli import k1_variants
    from turboae_tpu_torch.kernels import conv_stack as ks
    w = torch.from_numpy(np.random.RandomState(0).standard_normal((2, 16, 40)).astype(np.float32))
    big, small = ks.tf32_split(w)
    assert big.shape == small.shape == (2, 16, 40)
    assert not (big.view(torch.int32) & 0x1FFF).any() and not (small.view(torch.int32) & 0x1FFF).any()
    assert ((big + small - w).abs() <= 2.0 ** -22 * w.abs()).all()
    assert (big != w).any()
    plan = ks.k1_plan(500, 100, 7, 100, 5, 5, n_sm=132)
    assert (plan.R, plan.N, plan.nc, plan.tpw, plan.stages) == (2, 104, 2, 2, 4)
    wg4, r1 = (k1_variants.variant_plan(n, plan) for n in ('wg4_no_fold', 'r1'))
    assert (wg4.R, wg4.nc, wg4.tpw) == (2, 4, 1) and wg4.smem == plan.smem
    assert (r1.R, r1.nc, r1.tpw) == (1, 2, 1) and r1.fits()
    assert [k1_variants.variant_plan(f'stages{n}', plan).stages for n in (2, 3)] == [2, 3]
    assert k1_variants.variant_plan('no_prefetch', plan) is plan
