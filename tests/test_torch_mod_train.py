"""The modulation AE's training in the port (train/mod_trainer.py,
cli/main_modulation.py) against the JAX package's on the CPU, at small
widths: one f32 step of each of the four phases on the same params and
batch (loss to 1e-5 relative, gradients to 1e-4 of each leaf's largest,
the phase's leaves moved as optax moves them and the others not), the
trainer's loops and test, and the CLI's checkpoint read by JAX."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from turboae_tpu.train.checkpoint import load_checkpoint as jax_load
from turboae_tpu.train.mod_trainer import ModTrainer as JaxModTrainer
from turboae_tpu_torch.cli import main_modulation
from turboae_tpu_torch.train.checkpoint import MOD_GROUPS
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.mod_trainer import ModTrainer
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.utils.tree import tree_leaves

from _torch_parity import configs

SMALL_MOD = dict(enc_num_unit=10, dec_num_unit=10, enc_num_layer=2, dec_num_layer=2,
                 num_iteration=2, block_len=16, batch_size=8, mod_num_unit=6, demod_num_unit=6,
                 mod_lr=0.004, demod_lr=0.003)
TINY_CLI = ['-enc_num_unit', '6', '-dec_num_unit', '6', '-dec_num_layer', '2',
            '-num_iteration', '2', '-block_len', '12', '-num_block', '8', '-batch_size', '8',
            '-snr_points', '2', '-mod_num_unit', '4', '-demod_num_unit', '4']


@pytest.mark.parametrize('mod_pc', ['block_power', 'symbol_power'])
@pytest.mark.parametrize('phase', ['encoder', 'decoder', 'mod', 'demod'])
def test_mod_step_matches_jax(phase, mod_pc):
    jcfg, tcfg = configs(mod_pc=mod_pc, **SMALL_MOD)
    jt = JaxModTrainer(jcfg)
    jp = jax.tree.map(np.asarray, jt.params)
    rng = np.random.RandomState(1)
    bits = (rng.random_sample((8, 16, 1)) < 0.5).astype(np.float32)
    noise = (0.8 * rng.standard_normal((8, 24, 2))).astype(np.float32)
    keys = MOD_GROUPS[phase]
    diff = {k: jax.tree.map(jnp.asarray, jp[k]) for k in keys}
    frozen = {k: jax.tree.map(jnp.asarray, jp[k]) for k in jp if k not in keys}
    with jax.default_matmul_precision('highest'):
        ref_loss, ref_g = jax.value_and_grad(jt._loss)(diff, frozen, jax.random.PRNGKey(0),
                                                      jnp.asarray(bits), jnp.asarray(noise))
    upd, _ = jt.opts[phase].update(ref_g, jt.opts[phase].init(diff), diff)
    ref_new = from_jax(jax.tree.map(np.asarray, optax.apply_updates(diff, upd)))

    tr = ModTrainer(tcfg, 'cpu', params=from_jax(jp))
    before = [t.clone() for t in tree_leaves(tr.params)]
    loss, grads = tr.loss_and_grads(phase, torch.from_numpy(bits), torch.from_numpy(noise))
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = tree_leaves(from_jax(jax.tree.map(np.asarray, ref_g)))
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        assert float((g - r).abs().max()) <= 1e-4 * float(r.abs().max()) + 1e-12
    step_loss = tr._train_step(phase, torch.from_numpy(bits), torch.from_numpy(noise))
    assert step_loss.item() == loss.item()
    assert {ph: o.count for ph, o in tr.opt.items()} == {ph: int(ph == phase) for ph in MOD_GROUPS}
    lr = getattr(tcfg, {'encoder': 'enc_lr', 'decoder': 'dec_lr'}.get(phase, phase + '_lr'))
    moved = tree_leaves({k: tr.params[k] for k in keys})
    # Adam's first step is ~lr * sign(g): within 2 lr where the sign of a
    # gradient that is zero up to rounding differs
    for a, b in zip(moved, tree_leaves(ref_new)):
        assert float((a - b).abs().max()) <= 2.002 * lr
    n_moved = 0
    for k in tr.params:
        now = tree_leaves(tr.params[k])
        old = before[n_moved:n_moved + len(now)]
        n_moved += len(now)
        same = all(torch.equal(a, b) for a, b in zip(now, old))
        assert same == (k not in keys), k


def test_trainer_loops_sample_and_test(capsys):
    _, tcfg = configs(**{**SMALL_MOD, 'batch_size': 2000}, num_block=4000,
                      train_enc_channel_low=20.0, train_enc_channel_high=20.0,
                      train_dec_channel_low=0.0, train_dec_channel_high=0.0)
    tr = ModTrainer(tcfg, 'cpu')
    for phase, snr in (('encoder', 20.0), ('mod', 0.0), ('demod', 0.0), ('decoder', 0.0)):
        bits, noise = tr._sample(phase)
        assert bits.shape == (2000, 16, 1) and noise.shape == (2000, 24, 2)
        np.testing.assert_allclose(float(noise.std()), 10 ** (-snr / 20), rtol=0.02)
    tr.cfg = tcfg.replace(batch_size=8, num_block=16)
    losses = {ph: tr.train_epoch(1, ph) for ph in MOD_GROUPS}
    assert all(np.isfinite(v) for v in losses.values())
    assert {ph: o.count for ph, o in tr.opt.items()} == {ph: 2 for ph in MOD_GROUPS}
    snrs, ber, bler = tr.test(verbose=True)
    assert len(snrs) == tcfg.snr_points and all(0.0 <= b <= 1.0 for b in ber + bler)
    assert 'BLER' in capsys.readouterr().out
    with pytest.raises(ValueError, match='phase'):
        tr._train_step('joint')


def test_main_modulation_saves_a_checkpoint_jax_reads(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    tr = main_modulation.main(['--device', 'cpu', '-num_epoch', '1', '-num_train_dec', '2',
                               '-num_train_demod', '1', *TINY_CLI])
    ckpt = next((tmp_path / 'tmp').glob('mod_model_*.msgpack'))
    saved = load_msgpack(str(ckpt))
    assert {ph: int(s['0']['count']) for ph, s in saved['opt_state'].items()} == \
        {'encoder': 1, 'decoder': 2, 'mod': 1, 'demod': 1}
    assert {ph: list(s['0']['mu']) for ph, s in saved['opt_state'].items()} == \
        {ph: list(keys) for ph, keys in MOD_GROUPS.items()}
    from turboae_tpu.config import get_args
    from turboae_tpu.models.channel_ae import init_mod_ae
    jt = JaxModTrainer(get_args(TINY_CLI))
    stats = {}
    params, opt, step = jax_load(str(ckpt), init_mod_ae(jax.random.PRNGKey(0), jt.cfg),
                                 jt.opt_state, stats=stats)
    assert stats['kept'] == 0 and step == 0
    assert int(opt['decoder'][0].count) == 2
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(to_jax(tr.params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert 'final results on SNRs' in capsys.readouterr().out
    # reloaded through -init_nw_weight (params only), the params come back exactly
    back = main_modulation.main(['--device', 'cpu', '-num_epoch', '0', '-init_nw_weight',
                                 str(ckpt), *TINY_CLI])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params),
                                                  tree_leaves(tr.params)))
    assert all(o.count == 0 for o in back.opt.values())


def test_main_modulation_refuses_mesh_and_needs_a_gpu(monkeypatch):
    """-mesh_shape outside torchrun names the launcher, for a 2-D mesh and
    -shard_axis time too (which this CLI takes and shards the batch under,
    as JAX does); an unknown axis is refused; without --device cpu and a GPU
    it raises."""
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    with pytest.raises(RuntimeError, match='torchrun'):
        main_modulation.main(['--device', 'cpu', '-mesh_shape', '2', *TINY_CLI])
    with pytest.raises(RuntimeError, match='torchrun'):
        main_modulation.main(['--device', 'cpu', '-mesh_shape', '2', '2', '-shard_axis', 'time',
                              *TINY_CLI])
    with pytest.raises(ValueError, match='shard_axis'):
        main_modulation.main(['--device', 'cpu', '-shard_axis', 'model', *TINY_CLI])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        main_modulation.main(['-num_epoch', '0', *TINY_CLI])
