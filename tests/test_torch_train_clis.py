"""The port's training-side CLIs on the CPU at tiny sizes: the model soup
against the JAX script's on the same files, the published curves against
the JAX package's copy, the two checkpoint rankings, train_family for both
families (train, checkpoint, resume, warm start) and cli/main.py with
variable block lengths."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from turboae_tpu.results import reference_curves as j_curves
from turboae_tpu_torch.cli import average_checkpoints, select_bler_deep, select_checkpoint
from turboae_tpu_torch.cli import main as cli_main
from turboae_tpu_torch.cli import train_family
from turboae_tpu_torch.config import Config
from turboae_tpu_torch.models.channel_ae import init_ae
from turboae_tpu_torch.results import reference_curves as curves
from turboae_tpu_torch.train.checkpoint import save_checkpoint
from turboae_tpu_torch.train.msgpack_io import load_msgpack

from _torch_parity import CROWN, ROOT, SMALL

TINY_FAMILY = ['--epochs', '2', '--num_block', '16', '--batch_size', '8', '--block_len', '10',
               '--enc_num_unit', '6', '--dec_num_unit', '6', '--dec_num_layer', '2',
               '--num_iteration', '2', '--snr_points', '2', '--test_num_block', '16',
               '--val_every', '1', '--val_num_block', '16', '--device', 'cpu']


def _tiny_ckpts(tmp_path, n=2):
    cfg = Config(**SMALL)
    paths = []
    for seed in range(n):
        path = str(tmp_path / f'c{seed}.msgpack')
        save_checkpoint(path, init_ae(torch.Generator().manual_seed(seed), cfg), step=seed)
        paths.append(path)
    return paths


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f'{prefix}/{k}').items()}
    return {prefix: np.asarray(tree)}


# ---------------------------------------------------------------- the soup
@pytest.mark.parametrize('weights', [None, ['0.3', '0.7']], ids=['uniform', 'weighted'])
def test_average_checkpoints_equals_the_jax_script(tmp_path, weights):
    """The same files through scripts/average_checkpoints.py (flax, in a
    subprocess) and the port: the same bytes."""
    a, b = _tiny_ckpts(tmp_path)
    extra = ['--weights', *weights] if weights else []
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    subprocess.run([sys.executable, os.path.join(ROOT, 'scripts', 'average_checkpoints.py'),
                    '--out', str(tmp_path / 'jax.msgpack'), a, b, *extra],
                   check=True, env=env, capture_output=True, cwd=ROOT)
    average_checkpoints.main(['--out', str(tmp_path / 'port.msgpack'), a, b, *extra])
    ref = (tmp_path / 'jax.msgpack').read_bytes()
    assert (tmp_path / 'port.msgpack').read_bytes() == ref
    got = _leaves(load_msgpack(str(tmp_path / 'port.msgpack'))['params'])
    wa = 0.3 if weights else 0.5
    for k, v in _leaves(load_msgpack(a)['params']).items():
        w = _leaves(load_msgpack(b)['params'])[k]
        np.testing.assert_allclose(got[k], wa * v + (1 - wa) * w, rtol=1e-6, atol=1e-7)
        assert got[k].dtype == np.float32


def test_average_of_a_file_with_itself_is_its_params(tmp_path):
    out = str(tmp_path / 'self.msgpack')
    average_checkpoints.main(['--out', out, CROWN, CROWN])
    crown = load_msgpack(CROWN)
    got = load_msgpack(out)
    assert got['step'] == 0
    assert all(np.array_equal(got_v, v) for (k, v), got_v in
               zip(_leaves(crown['params']).items(), _leaves(got['params']).values()))


def test_average_refuses_mismatched_trees(tmp_path):
    a, = _tiny_ckpts(tmp_path, 1)
    with pytest.raises(ValueError):
        average_checkpoints.main(['--out', str(tmp_path / 'x.msgpack'), a, CROWN])
    with pytest.raises(ValueError):
        average_checkpoints.main(['--out', str(tmp_path / 'x.msgpack'), a, a, '--weights', '1'])


def test_reference_curves_equal_jax():
    ref = {k: v for k, v in vars(j_curves).items() if k.isupper()}
    got = {k: v for k, v in vars(curves).items() if k.isupper()}
    assert got == ref and 'TURBOAE_CNN_K100_FULL' in got


# ---------------------------------------------------------------- rankings
def test_select_checkpoint_ranks_twelve_points(tmp_path, capsys):
    soup = str(tmp_path / 'soup.msgpack')
    average_checkpoints.main(['--out', soup, CROWN, CROWN])
    out = str(tmp_path / 'rank.jsonl')
    rows = select_checkpoint.main([CROWN, soup, '--num_block', '16', '--batch_size', '16',
                                   '--device', 'cpu', '--out', out])
    with open(out) as f:
        written = [json.loads(line) for line in f]
    assert [r['ckpt'] for r in written] == [CROWN, soup] and written == rows
    for r in rows:
        assert len(r['ber']) == len(r['bler']) == len(r['blk_errors']) == 12
        assert r['ber_wins'] + len(r['ber_losses']) == 12
        assert r['ber'][0] > r['ber'][-1]
    # the soup of the crown with itself is the crown: the same params on the
    # next draws of one generator
    assert 'BEST:' in capsys.readouterr().out


def test_select_bler_deep_counts_at_the_snrs(tmp_path, capsys):
    out = str(tmp_path / 'deep.jsonl')
    rows = select_bler_deep.main([CROWN, '--num_block', '32', '--batch_size', '16',
                                  '--device', 'cpu', '--out', out, '--snrs', '0.0', '-1.0'])
    (row,) = rows
    assert row['snr'] == [0.0, -1.0] and row['n_blocks'] == 32
    assert row['bler'][0] == row['blk_errors'][0] / 32 and row['bler'][1] > 0
    assert 'BEST by BLER@0.0' in capsys.readouterr().out
    with open(out) as f:
        assert json.loads(f.readline()) == row


# ---------------------------------------------------------------- train_family
@pytest.mark.parametrize('family', ['ftae', 'mod'])
def test_train_family_trains_checkpoints_and_resumes(family, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = train_family.main(['--family', family, '--ckpt', 'tmp/f.msgpack',
                                 '--metrics', 'logs/f.jsonl', *TINY_FAMILY])
    with open('logs/f.jsonl') as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if r['event'] == 'epoch']
    assert [r['epoch'] for r in epochs] == [1, 2]
    assert all(np.isfinite(v) for r in epochs for k, v in r.items() if k.endswith('_loss'))
    assert any(r['event'] == 'best' for r in records) and os.path.exists('tmp/f.msgpack.best')
    saved = load_msgpack('tmp/f.msgpack')
    assert saved['step'] == 2
    assert set(saved['opt_state']) == ({'enc', 'dec'} if family == 'ftae'
                                       else {'encoder', 'decoder', 'mod', 'demod'})
    assert sorted(k for k in epochs[0] if k.endswith('_loss')) == sorted(
        f'{ph}_loss' for ph in ['encoder', 'decoder'] + ([] if family == 'ftae'
                                                          else ['mod', 'demod']))
    assert np.isfinite(trainer.test(verbose=False)[1]).all()

    # resume: the epoch counter and the optimizer state carry on
    resumed = train_family.main(['--family', family, '--resume', 'tmp/f.msgpack',
                                 '--ckpt', 'tmp/g.msgpack', '--metrics', 'logs/g.jsonl',
                                 *TINY_FAMILY[:1], '3', *TINY_FAMILY[2:]])
    again = load_msgpack('tmp/g.msgpack')
    assert again['step'] == 3
    first = next(iter(again['opt_state'].values()))
    first0 = next(iter(saved['opt_state'].values()))
    assert int(first['0']['count']) == int(first0['0']['count']) * 3 // 2
    assert resumed is not None


def test_train_family_init_from_refuses_a_file_that_matches_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt, = _tiny_ckpts(tmp_path, 1)
    with pytest.raises(SystemExit, match='ZERO leaves'):
        train_family.main(['--family', 'ftae', '--init_from', ckpt, *TINY_FAMILY])


def test_train_family_mod_warm_starts_from_a_flagship_file(tmp_path, monkeypatch, capsys):
    """A flagship checkpoint of the same widths seeds the mod family's enc
    and dec; mod and demod stay fresh."""
    monkeypatch.chdir(tmp_path)
    cfg = Config(enc_num_unit=6, dec_num_unit=6, dec_num_layer=2, num_iteration=2, block_len=10)
    save_checkpoint('flag.msgpack', init_ae(torch.Generator().manual_seed(0), cfg))
    train_family.main(['--family', 'mod', '--init_from', 'flag.msgpack', *TINY_FAMILY[:1], '1',
                       *TINY_FAMILY[2:]])
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith('warm-started')][0]
    merged, total = map(int, line.split()[1].split('/'))
    assert 0 < merged < total


# ---------------------------------------------------------------- cli/main.py
def test_main_with_variable_block_lengths(tmp_path, monkeypatch, capsys):
    """--is_variable_block_len trains at the bucket lengths and tests again at
    block_len_low and block_len_high."""
    monkeypatch.chdir(tmp_path)
    trainer = cli_main.main(['--is_variable_block_len', '-block_len_low', '10',
                             '-block_len_high', '30', '-num_epoch', '1', '-num_block', '32',
                             '-batch_size', '8', '-enc_num_unit', '12', '-dec_num_unit', '12',
                             '-enc_num_layer', '2', '-dec_num_layer', '2', '-num_iteration', '2',
                             '-snr_points', '2', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert '====> test at block_len 10' in out and '====> test at block_len 30' in out
    assert out.count('final results on SNRs') == 3
    lengths = {L for _, L in trainer._vbl}
    assert lengths and lengths <= {10, 12, 15, 18, 20, 23, 26, 29}
    assert os.listdir('tmp') and os.listdir('logs')
