"""Lookahead over Adam, and a resume of a maxBCE run: the port against the
JAX package on the CPU.

  - k + 1 = 6 Lookahead(Adam) steps on a small tree against JAX's
    lookahead(optax.adam), across the syncs at counts 0 and 5: the same f32
    arithmetic, so params and slow weights agree to 1e-6 relative;
  - two trainer steps (small flagship config, lookahead) against the JAX
    Trainer's, on the same batches: the loss to 1e-5 relative; Adam's first
    steps are ~lr * sign(g), so params agree to 1e-3 * lr on 99 % of the
    elements and to 2 lr at worst (tests/test_torch_train.py's reasons);
  - checkpoints both ways: a JAX-written Lookahead file loads into the port
    and its next step equals JAX's; a port-written one loads in JAX's
    load_checkpoint with its state;
  - artifacts/flagship_maxbce_ft.msgpack resumed with its Adam state and
    --loss maxBCE: one f32 decoder step at full width against JAX's, the
    loss to 1e-4 relative and params to 1e-5 of each leaf's largest, as
    tests/test_torch_resume.py holds the fading file.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from turboae_tpu.train.checkpoint import load_checkpoint as jax_load
from turboae_tpu.train.checkpoint import save_checkpoint as jax_save
from turboae_tpu.train.optimizers import lookahead
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.train import optimizers as topt
from turboae_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from turboae_tpu_torch.train.convert import to_jax
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.tree import tree_leaves, tree_unflatten

from _torch_parity import ROOT, SMALL, configs, small_params

MAXBCE_FT = os.path.join(ROOT, 'artifacts', 'flagship_maxbce_ft.msgpack')


def _tree(rng):
    return {'a': rng.standard_normal((5, 3)).astype(np.float32),
            'b': [rng.standard_normal(7).astype(np.float32)]}


def test_lookahead_steps_match_jax_across_two_syncs():
    rng = np.random.RandomState(7)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(7)]
    tx = lookahead(optax.adam(1e-2), k=5, alpha=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    leaves = [torch.from_numpy(t.copy()) for t in tree_leaves(params)]
    opt = topt.Lookahead(leaves, 1e-2)
    first = None
    for i, g in enumerate(grads):
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(t) for t in tree_leaves(g)])
        assert opt.count == int(state['count']) == i + 1
        assert opt.inner.count == int(state['inner'][0].count) == i + 1
        for got, ref in zip(leaves, jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
        for got, ref in zip(opt.slow, jax.tree.leaves(state['slow'])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
        if i == 0:
            first = [t.clone() for t in leaves]
    # the step-0 sync halves the first update: half of Adam's ~lr * sign(g)
    adam = [torch.from_numpy(t.copy()) for t in tree_leaves(params)]
    topt.Adam(adam, 1e-2).step([torch.from_numpy(t) for t in tree_leaves(grads[0])])
    p0 = [torch.from_numpy(t) for t in tree_leaves(params)]
    for f, a, p in zip(first, adam, p0):
        torch.testing.assert_close(f - p, 0.5 * (a - p), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize('name', ['adam', 'sgd', 'lookahead'])
def test_optimizer_over_no_params_counts_and_launches_nothing(name, monkeypatch):
    """DeepTurbo's encoder half has no params: its optimizer steps without
    calling torch._foreach_* (which refuses empty lists) and keeps count as
    optax does."""
    _, tcfg = configs(optimizer=name)
    opt = topt.make_optimizer(tcfg, 1e-3, [])
    called = []
    for fn in [f for f in dir(torch) if f.startswith('_foreach_')]:
        monkeypatch.setattr(torch, fn, lambda *a, n=fn, **k: called.append(n))
    for _ in range(6):
        opt.step([])
    assert not called
    if name == 'lookahead':
        assert opt.count == opt.inner.count == 6 and opt.state()['slow'] == []
    elif name == 'adam':
        assert opt.count == 6 and opt.state() == {'count': 6, 'mu': [], 'nu': []}


def _jax_trainer_step(jt, params, opt, key):
    with jax.default_matmul_precision('highest'):
        new_params, new_opt, loss = jt._train_step(params, opt, key, mode='decoder')
        k_data, _ = jax.random.split(key)
        bits, noise = jt._sample_batch(k_data, 'decoder')
    return new_params, new_opt, float(loss), np.array(bits), np.array(noise)


def _close_half(port_trainer, jax_half, half, atol):
    got = jax.tree.leaves(to_jax(port_trainer.params)[half])
    ref = [np.asarray(t) for t in jax.tree.leaves(jax_half)]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= atol(r), (np.abs(g - r).max(), atol(r))


def test_lookahead_trainer_step_matches_jax():
    """Two decoder steps from a JAX init: the first syncs (count 0), the
    second does not."""
    jcfg, tcfg = configs(**SMALL, batch_size=16, optimizer='lookahead')
    jp, tp = small_params(jcfg)
    jt = JaxTrainer(jcfg)
    params = jax.tree.map(jnp.asarray, jp)
    opt = {'enc': jt.opt_enc.init(params['enc']), 'dec': jt.opt_dec.init(params['dec'])}
    tr = Trainer(tcfg, 'cpu', params=tp)
    lr = tcfg.dec_lr
    for i in range(2):
        params, opt, ref_loss, bits, noise = _jax_trainer_step(jt, params, opt,
                                                               jax.random.PRNGKey(i))
        loss = tr._train_step('decoder', torch.from_numpy(bits), torch.from_numpy(noise))
        assert abs(loss.item() - ref_loss) <= 1e-5 * abs(ref_loss)
        assert tr.opt['dec'].count == int(opt['dec']['count']) == i + 1
        assert tr.opt['enc'].count == 0
        # Adam's first steps are ~lr * sign(g): a tiny gradient difference
        # may flip an update where |g| is near 0, so the bound is 1e-3 * lr
        # on most of a leaf and 2 lr at worst
        _close_half(tr, params['dec'], 'dec', lambda r: 2 * lr * (1 + 1e-3))
        diffs = np.concatenate([np.abs(g - np.asarray(r)).ravel() for g, r in zip(
            jax.tree.leaves(to_jax(tr.params)['dec']), jax.tree.leaves(params['dec']))])
        assert np.mean(diffs <= 1e-3 * lr) > 0.99


def test_jax_lookahead_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains two steps with Lookahead and saves; the port loads the file
    (params, inner Adam, slow weights, counts) and its next step equals
    JAX's next step from the same state."""
    jcfg, tcfg = configs(**SMALL, batch_size=16, optimizer='lookahead')
    jt = JaxTrainer(jcfg)
    params, opt = jt.params, jt.opt_state
    for i in range(2):
        params, opt, *_ = _jax_trainer_step(jt, params, opt, jax.random.PRNGKey(10 + i))
    path = str(tmp_path / 'la.msgpack')
    jax_save(path, params, opt, step=7)
    saved = load_msgpack(path)['opt_state']['dec']
    assert sorted(saved) == ['count', 'inner', 'slow'] and sorted(saved['inner']) == ['0', '1']

    tr = Trainer(tcfg, 'cpu')
    tr.params, tr.opt_state, step = load_checkpoint(path, tr.params, tr.opt_state)
    assert step == 7 and tr.opt['dec'].count == tr.opt['dec'].inner.count == 2
    for got, ref in zip(jax.tree.leaves(to_jax({'enc': tr.params['enc'], 'dec': tree_unflatten(
            tr.params['dec'], tr.opt['dec'].slow)})['dec']), jax.tree.leaves(opt['dec']['slow'])):
        np.testing.assert_array_equal(got, np.asarray(ref))

    params, opt, ref_loss, bits, noise = _jax_trainer_step(jt, params, opt,
                                                           jax.random.PRNGKey(20))
    loss = tr._train_step('decoder', torch.from_numpy(bits), torch.from_numpy(noise))
    assert abs(loss.item() - ref_loss) <= 1e-5 * abs(ref_loss)
    assert tr.opt['dec'].count == int(opt['dec']['count']) == 3
    # the moments carry two steps: the update is no longer ~lr * sign(g)
    _close_half(tr, params['dec'], 'dec', lambda r: 1e-5 * np.abs(r).max())


def test_port_lookahead_checkpoint_loads_in_jax(tmp_path):
    jcfg, tcfg = configs(**SMALL, batch_size=16, optimizer='lookahead')
    tr = Trainer(tcfg, 'cpu')
    for mode in ('encoder', 'decoder', 'decoder'):
        tr._train_step(mode)
    path = str(tmp_path / 'port_la.msgpack')
    save_checkpoint(path, tr.params, tr.opt_state, step=3)
    jt = JaxTrainer(jcfg)
    params, opt, step = jax_load(path, jt.params, jt.opt_state)
    assert step == 3
    for h, n in (('enc', 1), ('dec', 2)):
        o = tr.opt[h]
        assert int(opt[h]['count']) == int(opt[h]['inner'][0].count) == n == o.count
        mine = to_jax({'enc': tr.params['enc'], 'dec': tr.params['dec'],
                       h: tree_unflatten(tr.params[h], o.slow)})[h]
        for got, ref in zip(jax.tree.leaves(mine), jax.tree.leaves(opt[h]['slow'])):
            np.testing.assert_array_equal(got, np.asarray(ref))
        mu = to_jax({**tr.params, h: tree_unflatten(tr.params[h], o.inner.mu)})[h]
        for got, ref in zip(jax.tree.leaves(mu), jax.tree.leaves(opt[h]['inner'][0].mu)):
            np.testing.assert_array_equal(got, np.asarray(ref))
    for got, ref in zip(jax.tree.leaves(to_jax(tr.params)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_maxbce_resume_step_matches_jax():
    jcfg, tcfg = configs(batch_size=8, loss='maxBCE')
    jt = JaxTrainer(jcfg)
    params, opt, step = jax_load(MAXBCE_FT, jt.params, jt.opt_state)
    new_params, new_opt, ref_loss, bits, noise = _jax_trainer_step(jt, params, opt,
                                                                   jax.random.PRNGKey(3))
    tr = Trainer(tcfg, 'cpu')
    tr.params, tr.opt_state, t_step = load_checkpoint(MAXBCE_FT, tr.params, tr.opt_state)
    counts = {h: int(load_msgpack(MAXBCE_FT)['opt_state'][h]['0']['count']) for h in ('enc', 'dec')}
    assert t_step == step == 890 and tr.opt['dec'].count == counts['dec']
    loss = tr._train_step('decoder', torch.from_numpy(bits), torch.from_numpy(noise))
    assert abs(loss.item() - ref_loss) <= 1e-4 * abs(ref_loss)
    assert tr.opt['dec'].count == counts['dec'] + 1 == int(new_opt['dec'][0].count)
    assert tr.opt['enc'].count == counts['enc']
    _close_half(tr, new_params['dec'], 'dec', lambda r: 1e-5 * np.abs(r).max())
