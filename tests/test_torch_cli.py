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
    assert set(texts) == {'regs168', 'no_fold', 'cvt_rna', 'presplit', 'unroll2'}
    assert len({src, *texts.values()}) == 6
    assert 'cvt.rna.tf32.f32 %0' in texts['cvt_rna'] and 'cvt.rna.tf32.f32 %0' not in src


def test_k1_variants_tf32_planes():
    """The presplit variant's weight planes: TF32 big and small parts, low 13
    bits zero, whose sum is the weight to 2^-22 relative."""
    import torch
    from turboae_tpu_torch.cli import k1_variants
    w = torch.from_numpy(np.random.RandomState(0).standard_normal((2, 16, 40)).astype(np.float32))
    planes = k1_variants.tf32_planes(w)
    assert planes.shape == (2, 32, 40)
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    big, small = planes[:, :16], planes[:, 16:]
    assert ((big + small - w).abs() <= 2.0 ** -22 * w.abs()).all()
    assert (big != w).any()
