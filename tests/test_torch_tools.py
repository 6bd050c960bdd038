"""The port's tooling (ROADMAP M17) on the CPU: cli/profile_step.py's report,
cli/roofline.py's closed forms, results/plot.py, cli/gen_results_tables.py
and cli/sp_study.py under torchrun with gloo, each against the JAX package's
tool where there is one."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from turboae_tpu.results import plot as jax_plot
from turboae_tpu_torch.cli import gen_results_tables, profile_step, roofline
from turboae_tpu_torch.config import Config
from turboae_tpu_torch.results import plot
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.flops import analytic_flops, count_params, counted_flops

from _torch_parity import ROOT


# ---------------------------------------------------------------- profile_step
def _event(name, dur, cat='kernel'):
    return {'ph': 'X', 'cat': cat, 'name': name, 'dur': dur, 'ts': 0, 'pid': 0, 'tid': 7}


TRACE = {'traceEvents': [
    _event('conv_stack_bf16_kernel', 500.0), _event('conv_stack_bf16_kernel', 300.0),
    _event('conv_stack_f32_kernel', 40.0),
    _event('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc', 250.0),
    _event('sm90_xmma_wgrad_implicit_gemm_bf16bf16', 200.0),
    _event('sm80_xmma_dgrad_implicit_gemm_f32f32', 100.0),
    _event('void tensorTransformGeneric<__nv_bfloat16, float>(cudnnTensorStruct)', 3.0),
    _event('sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32', 80.0),
    _event('void at::native::vectorized_elementwise_kernel<4, at::native::elu_kernel>', 60.0),
    _event('void at::native::reduce_kernel<512, 1>', 30.0),
    _event('void at::native::index_elementwise_kernel<128, 4>', 20.0),
    _event('Memcpy HtoD (Pageable -> Device)', 5.0, 'gpu_memcpy'),
    _event('Memset (Device)', 1.0, 'gpu_memset'),
    _event('ncclDevKernel_AllReduce_Sum_f32_RING_LL', 70.0),
    _event('some_unknown_kernel', 4.0),
    _event('aten::conv1d', 999.0, 'cpu_op'),            # host: not counted
    _event('cudaLaunchKernel', 999.0, 'cuda_runtime'),   # host: not counted
]}


def test_profile_step_report_sums_device_time_by_category(tmp_path, capsys):
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({**TRACE, 'turboae': {'steps': 2, 'device': 'x'}}))
    out = profile_step.main(['report', '--trace', str(path)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    cats = {c: v['us'] for c, v in out['categories'].items()}
    assert set(cats) == set(profile_step.CATEGORIES)
    assert out['total_us'] == sum(cats.values()) == 1663.0
    assert abs(sum(v['share'] for v in out['categories'].values()) - 1.0) < 1e-12
    assert cats == {'K2 conv_stack_bf16': 800.0, 'K1 conv_stack_f32': 40.0,
                    'cudnn conv forward': 250.0, 'cudnn conv backward': 300.0, 'gemm': 80.0,
                    'elementwise/reduce': 90.0, 'copy/transpose': 29.0, 'collectives': 70.0,
                    'other': 4.0}
    assert out['device_us_per_step'] == 831.5
    assert out['top'][0] == {'name': 'conv_stack_bf16_kernel', 'calls': 2, 'us': 800.0,
                             'category': 'K2 conv_stack_bf16'}


def test_profile_step_capture_on_the_cpu_has_no_device_time(tmp_path, capsys):
    """A capture on the CPU traces the host only: its report finds no
    device event, and names the device it ran on."""
    path = str(tmp_path / 't.json')
    meta = profile_step.main(['capture', '--device', 'cpu', '--out', path, '--steps', '1',
                              '--batch_size', '2', '--dtype', 'float32'])
    assert meta['device'] == 'cpu' and os.path.exists(path)
    out = profile_step.main(['report', '--trace', path])
    assert out['total_us'] == 0.0 and out['device'] == 'cpu' and out['steps'] == 1


# ---------------------------------------------------------------- roofline
SMALL = dict(enc_num_unit=12, dec_num_unit=12, enc_num_layer=2, dec_num_layer=3,
             num_iteration=2)


@pytest.mark.parametrize('width,tol', [('small', 3e-2), ('flagship', 1e-3)])
def test_roofline_step_flops_against_utils_flops(width, tol):
    """F_enc + 3 F_dec of utils/flops.py:analytic_flops, beside
    FlopCounterMode's count of an unfused decoder step, which is a little
    lower (autograd skips the input gradient of the first decoder layer, and
    the last head emits one channel): 2.2 % at a narrow width, 0.06 % at the
    flagship's."""
    cfg = roofline.flagship(2, **(SMALL if width == 'small' else {}))
    f = analytic_flops(cfg, 2)
    assert roofline.step_flops(cfg) == f['encoder_flops'] + 3 * f['decoder_flops']
    counted = counted_flops(Trainer(cfg, 'cpu')._train_step, 'decoder')
    assert 0 <= 1 - counted / roofline.step_flops(cfg) < tol


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_roofline_step_bytes_against_the_params(dtype):
    """The closed form against the same count walked over the param tree:
    every conv layer (C, Cin, K) and head (out, in) moves B L (Cin + C)
    elements forward, the decoder's twice that again backward, and Adam 7
    words a decoder param."""
    cfg = roofline.flagship(4, dtype=dtype, **SMALL)
    params = Trainer(cfg, 'cpu').params
    s = 2 if dtype == 'bfloat16' else 4

    def moved(tree):
        n = 0
        for branch in (tree.values() if isinstance(tree, dict) else tree):
            if isinstance(branch, dict) and 'w' in branch:
                w = branch['w']
                n += (w.shape[0] + w.shape[1]) * (s if w.dim() == 3 else 4)
            else:
                n += moved(branch)
        return n
    bl = cfg.batch_size * cfg.block_len
    want = bl * (moved(params['enc']) + 3 * moved(params['dec'])) \
        + 28 * count_params(params['dec'])
    assert roofline.step_bytes(cfg, count_params(params['dec'])) == want


def test_roofline_runs_on_the_cpu(tmp_path):
    out = roofline.main(['--device', 'cpu', '--batch_sizes', '2', '--steps', '2',
                         '--steps_per_call', '1,2', '--dtype', 'float32',
                         '--out', str(tmp_path / 'r.json')])
    (row,) = out['rows']
    assert out['device'] == 'cpu' and out['dispatch_floor_ms'] > 0
    assert set(row['ms_per_step']) == {'1', '2'} and row['mfu'] is None
    assert row['peak_memory_mb'] is None
    assert json.loads((tmp_path / 'r.json').read_text()) == out


# ---------------------------------------------------------------- plot
LOG = """[ID] 123
====> Epoch: 1 Average loss: 0.69314718  running time 1.0
BER [0.5]
final results on SNRs  [-1.0, 0.0, 1.0]
BER [0.1, 0.01, 0.001]
BLER [0.9, 0.5, 0.1]
final results on punctured SNRs  [-1.0, 0.0, 1.0]
BER [0.2, 0.02, 0.002]
BLER [0.95, 0.6, 0.2]
"""


def test_parse_log_equals_jax(tmp_path):
    path = tmp_path / 'log.txt'
    path.write_text(LOG)
    got = plot.parse_log(str(path))
    assert got == jax_plot.parse_log(str(path))
    assert got == {'snr': [-1.0, 0.0, 1.0], 'ber': [0.1, 0.01, 0.001], 'bler': [0.9, 0.5, 0.1]}


def test_plot_curves_writes_a_png(tmp_path):
    pytest.importorskip('matplotlib')
    from turboae_tpu_torch.results.reference_curves import TURBO757_K1000
    out = plot.plot_curves({'ours': {'snr': [0.0, 1.0], 'ber': [1e-2, 1e-3]},
                            'Turbo-757 K=1000': TURBO757_K1000}, str(tmp_path / 'c.png'))
    with open(out, 'rb') as f:
        assert f.read(8) == b'\x89PNG\r\n\x1a\n'


def test_plot_curves_names_matplotlib_when_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    with pytest.raises(ImportError, match='matplotlib'):
        plot.plot_curves({'ours': {'snr': [0.0], 'ber': [0.1]}})


# ---------------------------------------------------------------- gen_results_tables
def _jax_script():
    spec = importlib.util.spec_from_file_location(
        'jax_gen_results_tables', os.path.join(ROOT, 'scripts', 'gen_results_tables.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gen_results_tables_equals_the_jax_script():
    with open(os.path.join(ROOT, 'RESULTS.md')) as f:
        text = f.read()
    jax_script = _jax_script()
    assert set(gen_results_tables.GENERATORS) == set(jax_script.GENERATORS)
    ref = gen_results_tables.reference_dir(text)
    for name, gen in gen_results_tables.GENERATORS.items():
        assert gen().replace(gen_results_tables.REFERENCE, ref) == \
            jax_script.GENERATORS[name](), name
    assert gen_results_tables.regenerate(text) == jax_script.regenerate(text) == text
    with pytest.raises(ValueError, match='cites no file'):
        gen_results_tables.reference_dir('no citation here')


def test_gen_results_tables_check_reads_and_never_writes(capsys):
    path = os.path.join(ROOT, 'RESULTS.md')
    before = (os.stat(path).st_mtime_ns, open(path).read())
    gen_results_tables.main(['--check'])
    assert capsys.readouterr().out.strip() == 'tables in sync'
    assert (os.stat(path).st_mtime_ns, open(path).read()) == before


# ---------------------------------------------------------------- sp_study
def test_sp_study_under_torchrun_on_two_gloo_ranks(tmp_path):
    """The three layouts on two gloo ranks at a tiny width: each rank's share
    as named, and the same steps from the same seed in each (the losses to
    1e-5 relative)."""
    from test_torch_dist import free_port, run_procs
    out_json = tmp_path / 'sp.json'
    proc = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node', '2',
         '--master_port', str(free_port()), '-m', 'turboae_tpu_torch.cli.sp_study',
         '--device', 'cpu', '--block_len', '40', '--batch_size', '4', '--num_units', '8',
         '--num_iteration', '2', '--steps', '2', '--out', str(out_json)],
        cwd=tmp_path, text=True, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS='1'))
    out = run_procs([proc])[0]
    rows = [json.loads(x) for x in out.splitlines() if x.startswith('{')]
    assert [r['layout'] for r in rows] == ['single', 'batch', 'time']
    assert [(r['rows_per_rank'], r['positions_per_rank']) for r in rows] == \
        [(4, 40), (2, 40), (4, 20)]
    assert all(r['peak_memory_mb'] is None and r['device'] == 'cpu' for r in rows)
    losses = np.array([r['loss'] for r in rows])
    assert np.all(np.isfinite(losses)) and np.abs(losses / losses[0] - 1).max() < 1e-5
    saved = json.loads(out_json.read_text())
    assert [r['layout'] for r in saved['layouts']] == ['single', 'batch', 'time']
    assert saved['block_len'] == 40 and saved['device'] == 'cpu'
