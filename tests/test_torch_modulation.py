"""The joint coding+modulation AE's model and checkpoint in the port
(models/modulation.py, models/channel_ae.py:forward_mod_ae, the four
optimizer groups of train/checkpoint.py) against the JAX package on the
CPU: identical converted params, codes, bits and noise; f32 to 1e-5 (JAX at
'highest' matmul precision), bf16 to 1e-2 relative. Small configs: 10
units, 2 iterations, block_len 16; and artifacts/mod_ae.msgpack at full
width."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models import modulation as jmod
from turboae_tpu.train.checkpoint import load_checkpoint as jax_load
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.models import modulation as tmod
from turboae_tpu_torch.train.checkpoint import MOD_GROUPS, groups, load_checkpoint, save_checkpoint
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.mod_trainer import ModTrainer
from turboae_tpu_torch.utils.tree import tree_leaves

from _torch_parity import ROOT, configs, rel_err

MOD_AE = os.path.join(ROOT, 'artifacts', 'mod_ae.msgpack')
MOD_SMALL = dict(enc_num_unit=10, dec_num_unit=10, enc_num_layer=2, dec_num_layer=2,
                 num_iteration=2, block_len=16, mod_num_unit=6, demod_num_unit=6)
B = 6


def _jax_params(jcfg, seed):
    return jax.tree.map(np.asarray, jae.init_mod_ae(jax.random.PRNGKey(seed), jcfg))


def _check(got, ref, dtype):
    if dtype == 'float32':
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert rel_err(got, ref) < 1e-2


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mod_pc', ['qpsk', 'symbol_power', 'block_power'])
@pytest.mark.parametrize('mod_rate', [1, 2, 3])
def test_mod_and_demod_match_jax(mod_pc, mod_rate, dtype):
    jcfg, tcfg = configs(mod_pc=mod_pc, mod_rate=mod_rate, dtype=dtype, **MOD_SMALL)
    jp = _jax_params(jcfg, seed=mod_rate)
    tp = from_jax(jp)
    codes = np.random.RandomState(mod_rate).standard_normal((B, 16, 3)).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref = jmod.mod_apply(jp['mod'], jcfg, jnp.asarray(codes))
        ref_rx = jmod.demod_apply(jp['demod'], jcfg, ref + 0.5)
    got = tmod.mod_apply(tp['mod'], tcfg, torch.from_numpy(codes))
    assert got.shape == (B, 16 * 3 // mod_rate, 2)
    if mod_pc == 'qpsk':
        # sign of the whitened symbols: equal to JAX's wherever a rounding
        # does not move a value across zero
        assert (got.float().numpy() == np.asarray(ref, np.float32)).mean() > 0.99
    else:
        _check(got, ref, dtype)
    rx = tmod.demod_apply(tp['demod'], tcfg, torch.tensor(np.asarray(ref, np.float32)) + 0.5)
    assert rx.shape == (B, 16, 3)
    _check(rx, ref_rx, dtype)


def test_symbol_power_whitens_each_symbol_position():
    """Per symbol position, over (batch, I/Q): mean 0 and Bessel std 1."""
    _, tcfg = configs(mod_pc='symbol_power', **MOD_SMALL)
    params = tmod.mod_init(torch.Generator().manual_seed(0), tcfg)
    sym = tmod.mod_apply(params, tcfg, torch.randn(B, 16, 3))
    flat = sym.permute(1, 0, 2).reshape(24, -1)
    torch.testing.assert_close(flat.mean(dim=1), torch.zeros(24), atol=1e-6, rtol=0)
    torch.testing.assert_close(flat.std(dim=1), torch.ones(24), atol=1e-5, rtol=0)


@pytest.mark.parametrize('rec_quantize', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('encoder,decoder', [('TurboAE_rate3_cnn', 'TurboAE_rate3_cnn'),
                                             ('TurboAE_rate3_cnn2d', 'TurboAE_rate3_cnn2d')])
def test_forward_mod_ae_matches_jax(encoder, decoder, dtype, rec_quantize):
    jcfg, tcfg = configs(encoder=encoder, decoder=decoder, dtype=dtype, img_size=4,
                         rec_quantize=rec_quantize, **MOD_SMALL)
    jp = _jax_params(jcfg, seed=3)
    tp = tae.init_mod_ae(torch.Generator().manual_seed(0), tcfg)
    assert [t.shape for t in tree_leaves(tp)] == [t.shape for t in tree_leaves(from_jax(jp))]
    tp = from_jax(jp)
    rng = np.random.RandomState(3)
    bits = (rng.random_sample((B, 16, 1)) < 0.5).astype(np.float32)
    noise = (0.7 * rng.standard_normal((B, 24, 2))).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref, ref_sym, _ = jae.forward_mod_ae(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(bits),
                                             jnp.asarray(noise), jae.make_perms(jcfg),
                                             training=False)
    got, sym, _ = tae.forward_mod_ae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                                     tae.make_perms(tcfg, 'cpu'), training=False)
    assert got.shape == (B, 16, 1) and sym.shape == (B, 24, 2)
    _check(sym, ref_sym, dtype)
    _check(got, ref, dtype)


def test_mod_ae_checkpoint_loads_whole_matches_jax_and_writes_back_byte_for_byte(tmp_path):
    """artifacts/mod_ae.msgpack: every param and Adam leaf merged, the four
    phases' counts, the forward equal to JAX's on the file's params, and
    the file written back byte for byte."""
    _, tcfg = configs()
    tr = ModTrainer(tcfg, 'cpu')
    stats = {}
    params, opt, step = load_checkpoint(MOD_AE, tr.params, tr.opt_state, stats=stats)
    # 74 param arrays in the file, the decoder's iterations 0-4 stacked
    assert stats == {'merged': 74, 'kept': 0}
    assert step == 400
    assert {h: s['count'] for h, s in opt.items()} == \
        {'encoder': 5200, 'decoder': 26000, 'mod': 10800, 'demod': 42800}
    tr.params, tr.opt_state = params, opt
    for ph, keys in MOD_GROUPS.items():
        assert [t.shape for t in tr.opt[ph].mu] == \
            [t.shape for t in tree_leaves({k: tr.params[k] for k in keys})]
    out = tmp_path / 'back.msgpack'
    save_checkpoint(str(out), tr.params, tr.opt_state, step=step)
    with open(MOD_AE, 'rb') as f:
        assert out.read_bytes() == f.read()

    jcfg, _ = configs()
    jp = jax_load(MOD_AE, _jax_params(jcfg, seed=0))
    rng = np.random.RandomState(5)
    bits = (rng.random_sample((4, 100, 1)) < 0.5).astype(np.float32)
    noise = rng.standard_normal((4, 150, 2)).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref, ref_sym, _ = jae.forward_mod_ae(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(bits),
                                             jnp.asarray(noise), jae.make_perms(jcfg),
                                             training=False)
    got, sym, _ = tae.forward_mod_ae(tr.params, tcfg, torch.from_numpy(bits),
                                     torch.from_numpy(noise), tr.perms, training=False)
    _check(sym, ref_sym, 'float32')
    _check(got, ref, 'float32')


def test_mod_groups_and_jax_round_trip():
    jcfg, _ = configs(**MOD_SMALL)
    jp = _jax_params(jcfg, seed=4)
    tp = from_jax(jp)
    assert list(tp) == ['enc', 'dec', 'mod', 'demod'] and list(tp['mod']) == ['layer', 'final']
    assert {h: list(g) for h, g in groups(tp).items()} == \
        {'encoder': ['enc'], 'decoder': ['dec'], 'mod': ['mod'], 'demod': ['demod']}
    back = to_jax(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
