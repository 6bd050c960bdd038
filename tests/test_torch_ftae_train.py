"""FTAE's training slice in the port (train/ftae_trainer.py, cli/ftae_main.py,
cli/eval_ftae.py) against the JAX package's on the CPU, at small widths:
one encoder and one decoder step on the same params and batch (f32 loss to
1e-5 relative, gradients to 1e-4 of the largest in each leaf's module, the phase's
leaves moved and the others not), the trainer's loops, the training CLI's
checkpoint read by JAX, and the eval CLI's power-allocation guard."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from turboae_tpu.train.checkpoint import load_checkpoint as jax_load
from turboae_tpu.train.ftae_trainer import FTAETrainer as JaxFTAETrainer
from turboae_tpu_torch.cli import eval_ftae, ftae_main
from turboae_tpu_torch.train.checkpoint import FTAE_GROUPS, groups
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.ftae_trainer import FTAETrainer
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.utils.tree import tree_leaves

from _torch_parity import ROOT, configs

SMALL_FTAE = dict(enc_num_unit=8, dec_num_unit=8, enc_num_layer=2, dec_num_layer=2,
                  num_iter_ft=3, num_iteration=2, block_len=10, batch_size=8)
TINY_CLI = ['-enc_num_unit', '6', '-dec_num_unit', '6', '-dec_num_layer', '2',
            '-num_iteration', '2', '-block_len', '10', '-num_block', '8', '-batch_size', '8',
            '-snr_points', '2', '-num_iter_ft', '3']


def _batch(seed=0, B=8, L=10):
    rng = np.random.RandomState(seed)
    bits = (rng.random_sample((B, L, 1)) < 0.5).astype(np.float32)
    fwd = rng.standard_normal((B, L, 3)).astype(np.float32)
    fb = (0.1 * rng.standard_normal((B, L, 3))).astype(np.float32)
    return bits, fwd, fb


@pytest.mark.parametrize('dec_type,alloc', [('turboae_cnn', 'pos_phase'),
                                            ('turboae_rnn', 'none'),
                                            ('turboae_sharedcnn', 'pos')])
@pytest.mark.parametrize('mode', ['encoder', 'decoder'])
def test_ftae_step_matches_jax(mode, dec_type, alloc):
    jcfg, tcfg = configs(**SMALL_FTAE, dec_type=dec_type, ftae_power_alloc=alloc)
    jt = JaxFTAETrainer(jcfg)
    jp = jax.tree.map(np.asarray, jt.params)
    bits, fwd, fb = _batch()
    keys = FTAE_GROUPS['enc' if mode == 'encoder' else 'dec']
    other = [k for k in jp if k not in keys]
    diff = {k: jnp.asarray(jp[k]) if not isinstance(jp[k], dict) else
            jax.tree.map(jnp.asarray, jp[k]) for k in keys}
    frozen = {k: jax.tree.map(jnp.asarray, jp[k]) for k in other}
    with jax.default_matmul_precision('highest'):
        ref_loss, ref_g = jax.value_and_grad(jt._loss)(diff, frozen, jnp.asarray(bits),
                                                      jnp.asarray(fwd), jnp.asarray(fb))
    opt = jt.opt_enc if mode == 'encoder' else jt.opt_dec
    upd, _ = opt.update(ref_g, opt.init(diff), diff)
    ref_new = optax.apply_updates(diff, upd)

    tr = FTAETrainer(tcfg, 'cpu', params=from_jax(jp))
    before = {k: [t.clone() for t in tree_leaves(tr.params[k])] for k in tr.params}
    loss, grads = tr.loss_and_grads(mode, *map(torch.from_numpy, (bits, fwd, fb)))
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    # gradients per leaf to 1e-4 of the largest in its module (a phase
    # encoder, or the decoder): a phase head's bias meets the whitening,
    # which takes out constant shifts, so its gradient is a cancellation
    # (zero up to rounding where ELU is linear) whose error follows the
    # module's scale, not its own
    ref_tree = from_jax(jax.tree.map(np.asarray, ref_g))
    got = iter(grads)
    for k in keys:
        ref = tree_leaves(ref_tree[k])
        scale = max(float(r.abs().max()) for r in ref)
        for r in ref:
            assert float((next(got) - r).abs().max()) <= 1e-4 * scale, k
    step_loss = tr._train_step(mode, *map(torch.from_numpy, (bits, fwd, fb)))
    assert step_loss.item() == loss.item()
    h = 'enc' if mode == 'encoder' else 'dec'
    assert tr.opt[h].count == 1 and tr.opt['dec' if h == 'enc' else 'enc'].count == 0
    # the phase's leaves moved as optax moved them; the others did not
    ref_new = from_jax(jax.tree.map(np.asarray, ref_new))
    lr = tcfg.enc_lr if mode == 'encoder' else tcfg.dec_lr
    for k in tr.params:
        now = tree_leaves(tr.params[k])
        if k in keys:
            # Adam's first step is ~lr * sign(g): within 2 lr where the sign
            # of a gradient that is zero up to rounding differs
            for a, b in zip(now, tree_leaves(ref_new[k])):
                assert float((a - b).abs().max()) <= 2.002 * lr
            assert not all(torch.equal(a, old) for a, old in zip(now, before[k]))
        else:
            assert all(torch.equal(a, b) for a, b in zip(now, before[k]))


def test_trainer_loops_run_and_count(capsys):
    _, tcfg = configs(**SMALL_FTAE, num_block=16, dec_type='turboae_rnn')
    tr = FTAETrainer(tcfg, 'cpu')
    enc = tr.train_epoch(1, 'encoder')
    dec = tr.train_epoch(1, 'decoder')
    assert np.isfinite(enc) and np.isfinite(dec)
    assert tr.opt['enc'].count == 2 and tr.opt['dec'].count == 2
    res = tr.sweep([0.0, 2.0], num_block=16, verbose=False)
    assert res['n_blocks'] == 16 and res['n_bits'] == 160
    assert all(0 <= e <= 160 for e in res['bit_errors'])
    assert all(b <= e for b, e in zip(res['blk_errors'], res['bit_errors']))
    snrs, ber, bler = tr.test(verbose=True)
    assert len(snrs) == tcfg.snr_points and all(0.0 <= b <= 1.0 for b in ber + bler)
    assert 'BLER' in capsys.readouterr().out
    with pytest.raises(ValueError, match='mode'):
        tr._train_step('joint')


def test_sample_draws_the_phase_and_feedback_ranges():
    """Forward noise at the phase's training range, feedback noise at
    fb_channel_low..high, both (B, L, 3)."""
    _, tcfg = configs(**{**SMALL_FTAE, 'batch_size': 2000}, train_enc_channel_low=20.0,
                      train_enc_channel_high=20.0, train_dec_channel_low=0.0,
                      train_dec_channel_high=0.0, fb_channel_low=40.0, fb_channel_high=40.0)
    tr = FTAETrainer(tcfg, 'cpu')
    for mode, snr in (('encoder', 20.0), ('decoder', 0.0)):
        bits, fwd, fb = tr._sample(mode)
        assert bits.shape == (2000, 10, 1) and fwd.shape == fb.shape == (2000, 10, 3)
        np.testing.assert_allclose(float(fwd.std()), 10 ** (-snr / 20), rtol=0.02)
        np.testing.assert_allclose(float(fb.std()), 1e-2, rtol=0.02)


def test_ftae_main_saves_a_checkpoint_jax_reads(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tr = ftae_main.main(['--device', 'cpu', '-dec_type', 'turboae_rnn', '-num_epoch', '1',
                         '-num_train_dec', '1', '-ftae_power_alloc', 'pos_phase', *TINY_CLI])
    ckpt = next((tmp_path / 'tmp').glob('ftae_model_*.msgpack'))
    saved = load_msgpack(str(ckpt))
    assert set(saved['opt_state']['enc']['0']['mu']) == set(FTAE_GROUPS['enc'])
    assert set(saved['opt_state']['dec']['0']['mu']) == set(FTAE_GROUPS['dec'])
    assert int(saved['opt_state']['enc']['0']['count']) == 1
    from turboae_tpu.config import get_args
    from turboae_tpu.models.ftae import init_ftae
    jcfg = get_args(['-dec_type', 'turboae_rnn', '-ftae_power_alloc', 'pos_phase', *TINY_CLI])
    stats = {}
    params = jax_load(str(ckpt), init_ftae(jax.random.PRNGKey(0), jcfg), stats=stats)
    assert stats['kept'] == 0
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(to_jax(tr.params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    # reloaded through -init_nw_weight, the params come back exactly
    back = ftae_main.main(['--device', 'cpu', '-dec_type', 'turboae_rnn', '-num_epoch', '0',
                           '-ftae_power_alloc', 'pos_phase', '-init_nw_weight', str(ckpt),
                           *TINY_CLI])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params),
                                                  tree_leaves(tr.params)))
    assert [t.shape for t in tree_leaves(groups(back.params)['enc'])] == \
        [t.shape for t in back.opt['enc'].mu]


@pytest.mark.parametrize('ckpt,mode', [('ftae.msgpack', 'pos'), ('ftae.msgpack', 'pos_phase'),
                                       ('ftae_pa.msgpack', 'none'), ('ftae_pa.msgpack', 'pos')])
def test_eval_cli_refuses_a_mismatched_power_alloc(ckpt, mode, tmp_path):
    """Both 'pw' and 'ps' are held to --ftae_power_alloc, where the JAX
    script checks 'pw' only (ADVICE.md item 1): 'pos' on the pos_phase
    checkpoint is refused too."""
    path = os.path.join(ROOT, 'artifacts', ckpt)
    with pytest.raises(SystemExit, match='power-allocation'):
        eval_ftae.main(['--ckpt', path, '--ftae_power_alloc', mode, '--device', 'cpu',
                        '--num_block', '2', '--batch_size', '2', '--snrs', '0',
                        '--out', str(tmp_path / 'e.json')])
    assert not (tmp_path / 'e.json').exists()


def test_eval_cli_without_device_raises_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        eval_ftae.main(['--ckpt', os.path.join(ROOT, 'artifacts', 'ftae.msgpack'),
                        '--out', str(tmp_path / 'e.json')])
    with pytest.raises(RuntimeError, match='cuda'):
        ftae_main.main(['-num_epoch', '0'])
