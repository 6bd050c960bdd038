"""Properties of the port as a whole: it imports nothing of JAX, flax,
optax, msgpack or the JAX package, and its entry points run on the GPU or
raise; they never fall back to the CPU."""
import ast
import pathlib

import pytest
import torch

from turboae_tpu_torch.cli import eval_flagship
from turboae_tpu_torch.config import Config
from turboae_tpu_torch.train.sweep import sweep
from turboae_tpu_torch.utils.device import resolve_device

from _torch_parity import CROWN, ROOT

FORBIDDEN = ('jax', 'flax', 'optax', 'msgpack', 'turboae_tpu')
PORT_FILES = sorted(pathlib.Path(ROOT, 'turboae_tpu_torch').rglob('*.py')) + \
    [pathlib.Path(ROOT, 'chip_smoke.py')]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', getattr(node.func, 'id', '')) \
                in ('import_module', '__import__') and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split('.')[0]


@pytest.mark.parametrize('path', PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists()
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{path.name} imports {bad}'


def test_import_rule_covers_every_subpackage():
    """The rule walks the whole package: the classical tables and encoder
    (a numpy copy of turboae_tpu/classical, which has no JAX in it) and
    DeepTurbo's encoder are held to it too."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ('turboae_tpu_torch/classical/trellis.py', 'turboae_tpu_torch/classical/convcode.py',
              'turboae_tpu_torch/models/deepturbo.py', 'chip_smoke.py'):
        assert f in names
    subpackages = {p.parent.name for p in PORT_FILES if p.name == '__init__.py'}
    assert {'classical', 'models', 'train', 'kernels', 'ops', 'cli', 'dist', 'native'} <= subpackages


def test_ast_check_catches_forbidden_imports(tmp_path):
    f = tmp_path / 'm.py'
    f.write_text('import os\nfrom turboae_tpu.config import Config\nimport jax.numpy as jnp\n'
                 'importlib.import_module("flax.serialization")\n')
    assert set(_imported_roots(f)) & set(FORBIDDEN) == {'turboae_tpu', 'jax', 'flax'}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_resolve_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device()
    assert resolve_device('cpu') == torch.device('cpu')


def test_sweep_without_device_raises_without_gpu(no_gpu):
    params = eval_flagship.load_flagship(CROWN, 'cpu')
    with pytest.raises(RuntimeError, match='cuda'):
        sweep(params, Config(batch_size=10), [0.0], num_block=10)


def test_eval_cli_without_device_raises_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match='cuda'):
        eval_flagship.main(['--ckpt', CROWN, '--num_block', '10', '--batch_size', '10'])


@pytest.mark.parametrize('cli', ['bench_train', 'bench_conv_stack', 'profile_train'])
def test_bench_clis_raise_without_gpu(no_gpu, cli):
    from turboae_tpu_torch.cli import bench_conv_stack, bench_train, profile_train
    main = {'bench_train': bench_train.main, 'bench_conv_stack': bench_conv_stack.main,
            'profile_train': profile_train.main}[cli]
    with pytest.raises(RuntimeError, match='cuda'):
        main([])


@pytest.mark.parametrize('cli', ['main', 'train_flagship'])
def test_training_clis_raise_without_gpu(no_gpu, cli, tmp_path, monkeypatch):
    from turboae_tpu_torch.cli import main, train_flagship
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match='cuda'):
        {'main': main.main, 'train_flagship': train_flagship.main}[cli](['-num_epoch', '0']
                                                                       if cli == 'main' else [])
    assert not list(tmp_path.iterdir())          # nothing was started on the CPU


TINY = {'main': ['-num_epoch', '1', '-num_block', '8', '-batch_size', '8', '-block_len', '12',
                 '-enc_num_unit', '8', '-dec_num_unit', '8', '-dec_num_layer', '2',
                 '-num_iteration', '2', '-snr_points', '1'],
        'train_flagship': ['--epochs', '1', '--num_block', '8', '--batch_size', '8',
                           '--block_len', '12', '--enc_num_unit', '8', '--dec_num_unit', '8',
                           '--dec_num_layer', '2', '--num_iteration', '2', '--snr_points', '1',
                           '--ckpt', 'c.msgpack', '--metrics', 'm.jsonl'],
        'eval_flagship': ['--ckpt', CROWN, '--num_block', '4', '--batch_size', '4',
                          '--snr_points', '1']}


@pytest.mark.parametrize('cli', list(TINY))
def test_every_cli_turns_tf32_off(cli, tmp_path, monkeypatch):
    """Each CLI turns TF32 off (cuDNN and matmuls) before it computes; the
    JAX package has no switch to turn it on, nor has the port."""
    from turboae_tpu_torch.cli import eval_flagship, main, train_flagship
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    mod = {'main': main, 'train_flagship': train_flagship, 'eval_flagship': eval_flagship}[cli]
    mod.main([*TINY[cli], '--device', 'cpu'])
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_trainer_without_device_raises_without_gpu(no_gpu):
    from turboae_tpu_torch.train.trainer import Trainer
    with pytest.raises(RuntimeError, match='cuda'):
        Trainer(Config())
