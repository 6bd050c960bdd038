"""The port's entry points on the CPU at tiny configs: the reference flag surface
(config.get_args) against the JAX package's, cli/main.py (train, save,
reload) and cli/train_flagship.py (resume with the epoch counter and the
Adam count carried on, NaN backoff with halved lrs, .best, --test_every
snapshots, the trace)."""
import dataclasses
import json
import os

import pytest
import torch

from turboae_tpu.config import Config as JaxConfig
from turboae_tpu.config import get_args as jax_get_args
from turboae_tpu.train import guard as jguard
from turboae_tpu_torch.cli import main as cli_main
from turboae_tpu_torch.cli import train_flagship
from turboae_tpu_torch.config import Config, get_args
from turboae_tpu_torch.train import guard as tguard
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.tree import tree_leaves

from _torch_parity import CROWN

TINY_MAIN = ['-num_block', '32', '-batch_size', '16', '-block_len', '24', '-enc_num_unit', '12',
             '-dec_num_unit', '12', '-enc_num_layer', '2', '-dec_num_layer', '2',
             '-num_iteration', '2', '-snr_points', '3', '--device', 'cpu']
TINY_FLAGSHIP = ['--num_block', '16', '--batch_size', '8', '--block_len', '24',
                 '--enc_num_unit', '12', '--dec_num_unit', '12', '--dec_num_layer', '2',
                 '--num_iteration', '2', '--snr_points', '2', '--val_every', '1',
                 '--device', 'cpu']


# ---------------------------------------------------------------- flags
def test_config_fields_equal_jax():
    got = [(f.name, f.default) for f in dataclasses.fields(Config)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JaxConfig)]
    assert got == ref


@pytest.mark.parametrize('argv', [
    [],
    ['-num_epoch', '3', '-enc_lr', '0.0003', '-channel', 't-dist', '-vv', '3'],
    ['--legacy_noise', '--use_fused_conv', '--print_pos_ber', '-dtype', 'bfloat16'],
    ['-mesh_shape', '2', '4', '-shard_axis', 'time'],
    ['-encoder', 'TurboAE_rate3_cnn_dense', '-block_len', '1000', '-enc_quantize_level', '4'],
], ids=['defaults', 'values', 'booleans', 'mesh_shape', 'more_values'])
def test_get_args_equals_jax(argv):
    got, ref = get_args(argv), jax_get_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert type(got.mesh_shape) is tuple
    for f in dataclasses.fields(Config):
        assert type(getattr(got, f.name)) is type(getattr(ref, f.name)), f.name


# ---------------------------------------------------------------- guard
@pytest.mark.parametrize('losses', [
    [0.69, 0.4, 0.3, 0.25, 0.2, 2.0, 0.19],                    # explosion after warm-up
    [0.69, float('nan'), 0.5, 0.4],                            # NaN in warm-up
    [16.0, 0.7, 0.6],                                          # above hard_max
    [1e-4, 2e-4, 1e-4, 3e-4, 0.4, 0.6],                        # min_jump floor, then a jump
    [{'enc': 0.1, 'dec': 0.2}, {'enc': 0.1, 'dec': float('inf')}, (0.3, 0.2)],
], ids=['explosion', 'nan', 'hard_max', 'min_jump', 'dicts'])
def test_guard_equals_jax(losses):
    """The port's copy of train/guard.py trips on the same epochs, keeps the
    same best and backs off the same lrs as the JAX package's."""
    g_port, g_jax = tguard.DivergenceGuard(), jguard.DivergenceGuard()
    b_port, b_jax = tguard.BestTracker(), jguard.BestTracker()
    for epoch, loss in enumerate(losses):
        assert g_port.check(loss) == g_jax.check(loss)
        val = max(loss.values()) if isinstance(loss, dict) else \
            (max(loss) if isinstance(loss, tuple) else loss)
        assert b_port.update(val, epoch) == b_jax.update(val, epoch)
    assert (b_port.best, b_port.best_epoch) == (b_jax.best, b_jax.best_epoch)
    g_port.reset()
    assert g_port._hist == []
    lrs = {'enc': 1e-3, 'dec': 3e-4}
    assert tguard.backoff_lrs(lrs) == jguard.backoff_lrs(lrs)


# ---------------------------------------------------------------- cli/main.py
def test_main_trains_saves_and_reloads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trained = cli_main.main(['-num_epoch', '2', *TINY_MAIN])
    ckpts = list((tmp_path / 'tmp').glob('model_*.msgpack'))
    assert len(ckpts) == 1 and len(list((tmp_path / 'logs').glob('*_log.txt'))) == 1
    saved = load_msgpack(str(ckpts[0]))
    assert int(saved['opt_state']['enc']['0']['count']) == 2 * 2      # 2 epochs x 2 steps
    assert int(saved['opt_state']['dec']['0']['count']) == 2 * 5 * 2

    reloaded = cli_main.main(['-num_epoch', '0', '-init_nw_weight', str(ckpts[0]), *TINY_MAIN])
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(reloaded.params), tree_leaves(trained.params)))
    # the reload's test is the trained params' test from a fresh generator
    ref = Trainer(reloaded.cfg, 'cpu', params=trained.params)
    ref.test(verbose=False)
    assert reloaded.last_test['ber'] == ref.last_test['ber']
    assert max(reloaded.last_test['ber']) < 0.45


@pytest.mark.parametrize('argv,error,what', [
    (['-mesh_shape', '2'], RuntimeError, 'torchrun'),
    (['-mesh_shape', '2', '-shard_axis', 'time'], RuntimeError, 'torchrun'),
    (['-mesh_shape', '2', '2'], RuntimeError, 'torchrun'),
    (['-shard_axis', 'model'], ValueError, 'shard_axis'),
    (['-mesh_shape', '2', '2', '2'], ValueError, 'at most two')])
def test_main_refuses_what_is_not_ported(argv, error, what, tmp_path, monkeypatch):
    """-mesh_shape outside torchrun (no WORLD_SIZE) names the launcher, for
    time-axis sharding and 2-D meshes too; an axis other than batch or time,
    and a mesh of more than ('data', 'model'), are refused. Nothing is
    written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(error, match=what):
        cli_main.main([*argv, *TINY_MAIN])
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------- cli/train_flagship.py
def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_flagship_resumes_with_epoch_and_adam_count(tmp_path):
    ckpt, metrics = str(tmp_path / 'f.msgpack'), str(tmp_path / 'm.jsonl')
    train_flagship.main(['--epochs', '2', '--ckpt', ckpt, '--metrics', metrics, *TINY_FLAGSHIP])
    first = load_msgpack(ckpt)
    assert first['step'] == 2
    assert int(first['opt_state']['enc']['0']['count']) == 2 * 2
    assert int(first['opt_state']['dec']['0']['count']) == 2 * 5 * 2
    assert os.path.exists(ckpt + '.best')

    metrics2 = str(tmp_path / 'm2.jsonl')
    tr = train_flagship.main(['--epochs', '3', '--resume', ckpt, '--ckpt', ckpt,
                              '--metrics', metrics2, *TINY_FLAGSHIP])
    second = load_msgpack(ckpt)
    assert second['step'] == 3
    assert int(second['opt_state']['enc']['0']['count']) == 3 * 2
    assert int(second['opt_state']['dec']['0']['count']) == 3 * 5 * 2
    epochs = [r['epoch'] for r in _records(metrics2) if r['event'] == 'epoch']
    assert epochs == [3]
    test = [r for r in _records(metrics2) if r['event'] == 'test'][-1]
    assert len(test['ber']) == 2 and tr.last_test['encoder_power'] > 0

    # --fresh_opt --start_epoch 0: params only, a new optimizer state
    train_flagship.main(['--epochs', '1', '--resume', ckpt, '--fresh_opt', '--start_epoch', '0',
                         '--ckpt', str(tmp_path / 'g.msgpack'), '--metrics', metrics2,
                         *TINY_FLAGSHIP])
    third = load_msgpack(str(tmp_path / 'g.msgpack'))
    assert third['step'] == 1 and int(third['opt_state']['enc']['0']['count']) == 2


def test_train_flagship_backs_off_on_a_nan_epoch(tmp_path, monkeypatch):
    """A NaN loss in epoch 2's last decoder epoch (the one the CLI reports):
    the CLI reloads the epoch-1 checkpoint into a fresh trainer with both
    lrs halved and runs epoch 2 again."""
    inner = Trainer.train_epoch
    calls = []

    def train_epoch(self, epoch, mode='encoder', verbose=True):
        calls.append((epoch, mode))
        loss = inner(self, epoch, mode, verbose)
        return float('nan') if (epoch, mode) == (2, 'decoder') and calls.count((2, mode)) == 5 \
            else loss
    monkeypatch.setattr(Trainer, 'train_epoch', train_epoch)
    ckpt, metrics = str(tmp_path / 'f.msgpack'), str(tmp_path / 'm.jsonl')
    tr = train_flagship.main(['--epochs', '3', '--ckpt_every', '1', '--enc_lr', '0.002',
                              '--dec_lr', '0.004', '--ckpt', ckpt, '--metrics', metrics,
                              *TINY_FLAGSHIP])
    recs = _records(metrics)
    diverged = [r for r in recs if r['event'] == 'diverged']
    assert len(diverged) == 1
    assert diverged[0]['lrs'] == {'enc': 0.001, 'dec': 0.002}
    assert diverged[0]['reload_epoch'] == 1 and diverged[0]['action'] == 'backoff'
    assert [r['epoch'] for r in recs if r['event'] == 'epoch'] == [1, 2, 2, 3]
    assert (tr.cfg.enc_lr, tr.cfg.dec_lr) == (0.001, 0.002)
    assert (tr.opt['enc'].lr, tr.opt['dec'].lr) == (0.001, 0.002)
    saved = load_msgpack(ckpt)
    # the fresh trainer took epochs 2 and 3 with a new optimizer state
    assert saved['step'] == 3 and int(saved['opt_state']['enc']['0']['count']) == 2 * 2


def test_train_flagship_test_every_and_trace(tmp_path):
    ckpt, metrics = str(tmp_path / 'f.msgpack'), str(tmp_path / 'm.jsonl')
    train_flagship.main(['--epochs', '2', '--test_every', '2', '--test_num_block', '16',
                         '--scan_unroll', '5', '--trace_dir', str(tmp_path / 'trace'),
                         '--ckpt', ckpt, '--metrics', metrics, *TINY_FLAGSHIP])
    assert load_msgpack(ckpt + '.e2')['step'] == 2
    tests = [r for r in _records(metrics) if r['event'] == 'test']
    assert tests[0]['epoch'] == 2 and len(tests[0]['blk_errors']) == 2
    with open(tmp_path / 'trace' / 'trace.json') as f:
        assert json.load(f)['traceEvents']


def test_train_flagship_stops_at_its_time_budget(tmp_path):
    ckpt, metrics = str(tmp_path / 'f.msgpack'), str(tmp_path / 'm.jsonl')
    train_flagship.main(['--epochs', '50', '--time_budget_s', '1e-9', '--ckpt', ckpt,
                         '--metrics', metrics, *TINY_FLAGSHIP])
    assert load_msgpack(ckpt)['step'] == 1
    assert [r['epoch'] for r in _records(metrics) if r['event'] == 'epoch'] == [1]


@pytest.mark.parametrize('models', [
    ['--encoder', 'TurboAE_rate3_cnn2d', '--decoder', 'TurboAE_rate3_cnn2d', '--block_len', '100'],
    ['--encoder', 'turboae_2int', '--decoder', 'turboae_2int'],
    ['--decoder', 'TurboAE_rate3_cnn_2inter']])
def test_train_flagship_trains_the_cnn_zoo(models, tmp_path):
    """The rate-3 CNN zoo trains through the script's flags (the 2D code at
    the default img_size 10, so block_len 100), as in JAX; the file's trees
    are JAX's."""
    ckpt = str(tmp_path / 'f.msgpack')
    tr = train_flagship.main([*TINY_FLAGSHIP, '--epochs', '1', '--num_train_dec', '1',
                              '--ckpt', ckpt, '--metrics', str(tmp_path / 'm.jsonl'), *models])
    saved = load_msgpack(ckpt)
    assert saved['step'] == 1 and int(saved['opt_state']['dec']['0']['count']) == 2
    epoch = [r for r in _records(str(tmp_path / 'm.jsonl')) if r['event'] == 'epoch']
    assert len(epoch) == 1 and 0 < epoch[0]['dec_loss'] < 1
    assert tr.last_test['encoder_power'] > 0


@pytest.mark.parametrize('models', [['--decoder', 'TurboAE_rate3_cnn_2inter'],
                                    ['--encoder', 'turboae_2int',
                                     '--decoder', 'TurboAE_rate3_cnn_2inter']])
def test_eval_cli_evaluates_the_cnn_zoo(models, tmp_path):
    """The CNN zoo's keys evaluate through the eval CLI: the crown's params
    have the two-interleaver code's trees."""
    from turboae_tpu_torch.cli import eval_flagship
    out = eval_flagship.main([*models, '--ckpt', CROWN, '--num_block', '4',
                              '--batch_size', '2', '--snr_points', '1', '--device', 'cpu',
                              '--out', str(tmp_path / 'e.json')])
    assert out['n_blocks'] == [4] and 0 <= out['blk_errors'][0] <= 4


def test_eval_cli_writes_its_json_by_default(tmp_path, monkeypatch, capsys):
    """As scripts/eval_flagship.py does: without --out the JSON goes to
    logs/flagship_eval.json under the working directory."""
    from turboae_tpu_torch.cli import eval_flagship
    assert eval_flagship.parse([]).out == 'logs/flagship_eval.json'
    monkeypatch.chdir(tmp_path)
    out = eval_flagship.main(['--ckpt', CROWN, '--num_block', '4', '--batch_size', '2',
                              '--snr_points', '2', '--device', 'cpu'])
    with open(tmp_path / 'logs' / 'flagship_eval.json') as f:
        assert json.load(f) == json.loads(json.dumps(out))
    assert 'wrote logs/flagship_eval.json' in capsys.readouterr().out


# ---------------------------------------------------------------- the classical benchmark CLIs
@pytest.mark.parametrize('cli,engine', [('turbo_benchmark', 'torch'), ('turbo_benchmark', 'torch_mc'),
                                        ('conv_benchmark', 'torch'), ('ldpc_benchmark', 'torch')])
def test_classical_clis_raise_without_gpu(cli, engine, monkeypatch, capsys):
    """Without --device cpu each classical CLI asks for the card and raises
    when there is none: no engine falls back to the CPU, and nothing is
    decoded or printed before it raises."""
    import importlib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    mod = importlib.import_module(f'turboae_tpu_torch.cli.{cli}')
    with pytest.raises(RuntimeError, match='cuda'):
        mod.main(['-engine', engine])
    assert '[testing]' not in capsys.readouterr().out
