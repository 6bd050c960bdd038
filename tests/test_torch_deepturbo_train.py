"""Training DeepTurbo in the port, on the CPU.

  - artifacts/deepturbo.msgpack resumed with its Adam state: one f32 decoder
    step at full width (batch 8) against the JAX Trainer's from the same
    file and batch: the loss to 1e-4 relative, params to 1e-5 of each
    leaf's largest (tests/test_torch_resume.py's bounds and reasons);
  - a Trainer with num_train_enc 0 through cli/train_flagship.py and
    cli/main.py at a small config: the empty encoder half and its optimizer
    are never touched, epochs resume, Trainer.test runs both passes and
    reports the encoder power of the +-1 codes;
  - cli/main.py with -optimizer lookahead and every loss of the menu.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from turboae_tpu.train.checkpoint import load_checkpoint as jax_load
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.cli import main as cli_main
from turboae_tpu_torch.cli import train_flagship
from turboae_tpu_torch.train.checkpoint import load_checkpoint
from turboae_tpu_torch.train.convert import to_jax
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.train.trainer import Trainer

from _torch_parity import ROOT, configs

DEEPTURBO = os.path.join(ROOT, 'artifacts', 'deepturbo.msgpack')
TINY = ['--num_block', '16', '--batch_size', '8', '--block_len', '24', '--dec_num_unit', '12',
        '--dec_num_layer', '2', '--num_iteration', '2', '--snr_points', '2', '--val_every', '1',
        '--device', 'cpu']
TINY_MAIN = ['-num_block', '32', '-batch_size', '16', '-block_len', '24', '-enc_num_unit', '12',
             '-dec_num_unit', '12', '-enc_num_layer', '2', '-dec_num_layer', '2',
             '-num_iteration', '2', '-snr_points', '2', '--device', 'cpu']


def test_deepturbo_resume_step_matches_jax():
    jcfg, tcfg = configs(encoder='Turbo_rate3_757', batch_size=8, dec_lr=2e-5)
    jt = JaxTrainer(jcfg)
    params, opt, step = jax_load(DEEPTURBO, jt.params, jt.opt_state)
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision('highest'):
        new_params, new_opt, ref_loss = jt._train_step(params, opt, key, mode='decoder')
        k_data, _ = jax.random.split(key)
        bits, noise = jt._sample_batch(k_data, 'decoder')

    tr = Trainer(tcfg, 'cpu')
    tr.params, tr.opt_state, t_step = load_checkpoint(DEEPTURBO, tr.params, tr.opt_state)
    count = int(load_msgpack(DEEPTURBO)['opt_state']['dec']['0']['count'])
    assert t_step == step == 522 and tr.opt['dec'].count == count
    loss = tr._train_step('decoder', torch.tensor(np.asarray(bits)),
                          torch.tensor(np.asarray(noise)))
    assert abs(loss.item() - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    assert tr.opt['dec'].count == count + 1 == int(new_opt['dec'][0].count)
    assert tr.opt['enc'].count == 0 and tr.params['enc'] == {}
    got = jax.tree.leaves(to_jax(tr.params)['dec'])
    ref = [np.asarray(t) for t in jax.tree.leaves(new_params['dec'])]
    before = [np.asarray(t) for t in jax.tree.leaves(params['dec'])]
    assert len(got) == len(ref) == 48
    moved = 0
    for g, r, b in zip(got, ref, before):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()
        moved += int(np.abs(r - b).max() > 0)
    assert moved == len(ref)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize('encoder', ['Turbo_rate3_757', 'Turbo_rate3_lte'])
def test_train_flagship_trains_deepturbo_without_an_encoder_phase(encoder, tmp_path, monkeypatch):
    ckpt, metrics = str(tmp_path / 'dt.msgpack'), str(tmp_path / 'm.jsonl')
    # the encoder's optimizer must take no step and launch nothing
    steps = []
    real = Trainer._train_step

    def counted(self, mode, *a, **kw):
        steps.append(mode)
        return real(self, mode, *a, **kw)
    monkeypatch.setattr(Trainer, '_train_step', counted)
    tr = train_flagship.main(['--epochs', '2', '--encoder', encoder, '--num_train_enc', '0',
                              '--num_train_dec', '2', '--ckpt', ckpt, '--metrics', metrics,
                              *TINY])
    assert set(steps) == {'decoder'} and len(steps) == 2 * 2 * 2
    saved = load_msgpack(ckpt)
    assert saved['step'] == 2 and saved['params']['enc'] == {}
    assert int(saved['opt_state']['enc']['0']['count']) == 0
    assert int(saved['opt_state']['dec']['0']['count']) == 8
    epochs = [r for r in _records(metrics) if r['event'] == 'epoch']
    assert [r['epoch'] for r in epochs] == [1, 2] and all(r['enc_loss'] == 0.0 for r in epochs)
    assert all(np.isfinite(r['dec_loss']) for r in epochs)
    # Trainer.test ran both passes; the encoder power is that of +-1 codes
    last = tr.last_test
    assert len(last['bler']) == len(last['bler_punc']) == 2
    n = 8 * 24 * 3
    assert abs(last['encoder_power'] - np.sqrt(n / (n - 1))) < 2e-3

    # resumed: the epoch counter and the decoder's Adam count carry on
    train_flagship.main(['--epochs', '3', '--encoder', encoder, '--num_train_enc', '0',
                         '--num_train_dec', '2', '--resume', ckpt, '--ckpt', ckpt,
                         '--metrics', metrics, *TINY])
    again = load_msgpack(ckpt)
    assert again['step'] == 3 and int(again['opt_state']['dec']['0']['count']) == 12
    assert int(again['opt_state']['enc']['0']['count']) == 0


@pytest.mark.parametrize('argv', [
    ['-encoder', 'Turbo_rate3_757', '-num_train_enc', '0'],
    ['-optimizer', 'lookahead', '-loss', 'maxBCE'],
    ['-optimizer', 'lookahead', '-loss', 'sortBCE', '-encoder', 'TurboAE_rate3_cnn_dense'],
], ids=['deepturbo', 'lookahead_maxbce', 'lookahead_sortbce_dense'])
def test_main_trains_the_new_configs(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = cli_main.main([*argv, '-num_epoch', '2', *TINY_MAIN])
    cfg = trainer.cfg
    assert cfg.num_epoch == 2
    (ckpt,) = os.listdir(tmp_path / 'tmp')
    saved = load_msgpack(str(tmp_path / 'tmp' / ckpt))
    if cfg.optimizer == 'lookahead':
        for h in ('enc', 'dec'):
            state = saved['opt_state'][h]
            steps = 2 * (cfg.num_train_enc if h == 'enc' else cfg.num_train_dec) * 2
            assert int(state['count']) == int(state['inner']['0']['count']) == steps
    else:
        assert saved['params']['enc'] == {}
        assert int(saved['opt_state']['enc']['0']['count']) == 0
    assert all(np.isfinite(trainer.last_test['ber']))


@pytest.mark.parametrize('loss', ['soft_ber', 'bce_rl', 'enc_rl', 'bce_block', 'focal', 'mse',
                                  'maxBCE', 'sortBCE'])
def test_every_loss_trains_a_step_of_each_phase(loss):
    _, tcfg = configs(enc_num_unit=12, dec_num_unit=12, enc_num_layer=2, dec_num_layer=2,
                      num_iteration=2, block_len=24, batch_size=8, loss=loss)
    tr = Trainer(tcfg, 'cpu')
    before = {h: [t.clone() for t in tr._leaves[h]] for h in ('enc', 'dec')}
    for mode in ('encoder', 'decoder'):
        assert torch.isfinite(tr._train_step(mode))
    assert tr.opt['enc'].count == tr.opt['dec'].count == 1
    for h in ('enc', 'dec'):
        # enc_rl reaches the decoder with zero gradients, and Adam's first
        # step on a zero gradient is zero
        moved = any(not torch.equal(a, b) for a, b in zip(tr._leaves[h], before[h]))
        assert moved == (h == 'enc' or loss != 'enc_rl')
