"""The RNN zoo of the port (models/encoders.py, models/decoders.py over
ops/gru.py) against the JAX package's on the CPU, at small widths: params
made by JAX's init and converted, inputs from numpy at a fixed seed, the JAX
side at 'highest' matmul precision. f32 within 1e-5 (1e-5 relative for the
training losses); the decoder's dropout by statistics; the CLIs take the
RNN keys."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models.decoders import DEC_REGISTRY as JDEC
from turboae_tpu.models.encoders import ENC_REGISTRY as JENC
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.models import decoders as tdec
from turboae_tpu_torch.models import encoders as tenc
from turboae_tpu_torch.ops import gru as tgru
from turboae_tpu_torch.train.checkpoint import save_checkpoint
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.trainer import Trainer
from turboae_tpu_torch.utils.tree import tree_leaves

from _torch_parity import configs, to_np

SMALL_RNN = dict(enc_num_unit=8, dec_num_unit=8, enc_num_layer=2, num_iter_ft=3,
                 block_len=12)


def _perms(jcfg, tcfg):
    return jae.make_perms(jcfg), tae.make_perms(tcfg, 'cpu')


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize('key,kw', [
    ('Turboae_rate3_rnn', {}), ('Turboae_rate3_rnn', {'enc_rnn': 'lstm'}),
    ('TurboAE_rate3_rnn_sys', {}), ('TurboAE_rate3_rnn_sys', {'enc_rnn': 'lstm'}),
    ('TurboAE_rate2_rnn', {'code_rate_n': 2}),
    ('Turboae_rate3_rnn', {'enc_act': 'tanh', 'dtype': 'bfloat16'})])
def test_rnn_encoder_matches_jax(key, kw):
    jcfg, tcfg = configs(encoder=key, **SMALL_RNN, **kw)
    jinit, japply = JENC[key]
    jp = _np_tree(jinit(jax.random.PRNGKey(1), jcfg))
    tinit, tapply = tenc.make_encoder(tcfg)
    tp = from_jax(jp)
    assert [t.shape for t in tree_leaves(tp)] == \
        [t.shape for t in tree_leaves(tinit(torch.Generator().manual_seed(0), tcfg))]
    x = (np.random.RandomState(2).random_sample((6, 12, 1)) < 0.5).astype(np.float32)
    jperm, tperm = _perms(jcfg, tcfg)
    with jax.default_matmul_precision('highest'):
        ref, _ = japply(jp, jcfg, jnp.asarray(x), jperm)
    got, _ = tapply(tp, tcfg, torch.from_numpy(x), tperm)
    assert got.shape == (6, 12, tcfg.code_rate_n)
    tol = 1e-5 if tcfg.dtype == 'float32' else 2e-2
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=tol, atol=tol)
    if key == 'TurboAE_rate3_rnn_sys':
        np.testing.assert_array_equal(to_np(got)[:, :, 0], 2 * x[:, :, 0] - 1)


DECODER_CASES = [('TurboAE_rate3_rnn', {}), ('TurboAE_rate3_rnn', {'dec_rnn': 'lstm'}),
                 ('TurboAE_rate3_rnn', {'dec_act': 'tanh', 'extrinsic': 0}),
                 ('TurboAE_rate2_rnn', {'code_rate_n': 2}),
                 ('nbcjr_rate3', {}), ('nbcjr_rate3', {'extrinsic': 0})]


@pytest.mark.parametrize('num_iteration', [1, 2])
@pytest.mark.parametrize('key,kw', DECODER_CASES)
def test_rnn_decoder_matches_jax(key, kw, num_iteration):
    jcfg, tcfg = configs(decoder=key, num_iteration=num_iteration, **SMALL_RNN, **kw)
    jinit, japply = JDEC[key]
    jp = _np_tree(jinit(jax.random.PRNGKey(3), jcfg))
    tinit, tapply = tdec.make_decoder(tcfg)
    tp = from_jax(jp)
    assert [t.shape for t in tree_leaves(tp)] == \
        [t.shape for t in tree_leaves(tinit(torch.Generator().manual_seed(0), tcfg))]
    # the round trip back to JAX's layout is exact
    for a, b in zip(jax.tree.leaves(to_jax(tp)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    rec = np.random.RandomState(4).standard_normal((5, 12, tcfg.code_rate_n)).astype(np.float32)
    jperm, tperm = _perms(jcfg, tcfg)
    with jax.default_matmul_precision('highest'):
        ref = japply(jp, jcfg, jnp.asarray(rec), jperm)
    got = tapply(tp, tcfg, torch.from_numpy(rec), tperm)
    assert got.shape == (5, 12, 1)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_nbcjr_extrinsic_inversion_changes_the_output():
    """nbcjr subtracts its prior when NOT extrinsic: the two settings give
    different outputs, each equal to JAX's (test above)."""
    outs = []
    for ext in (0, 1):
        jcfg, tcfg = configs(decoder='nbcjr_rate3', num_iteration=2, extrinsic=ext, **SMALL_RNN)
        tp = from_jax(_np_tree(JDEC['nbcjr_rate3'][0](jax.random.PRNGKey(3), jcfg)))
        rec = np.random.RandomState(4).standard_normal((5, 12, 3)).astype(np.float32)
        outs.append(tdec.nbcjr_apply(tp, tcfg, torch.from_numpy(rec), tae.make_perms(tcfg, 'cpu')))
    assert not torch.allclose(outs[0], outs[1])


PAIRS = [('Turboae_rate3_rnn', 'TurboAE_rate3_rnn', {}),
         ('Turboae_rate3_rnn', 'TurboAE_rate3_rnn', {'enc_rnn': 'lstm', 'dec_rnn': 'lstm'}),
         ('TurboAE_rate3_rnn_sys', 'TurboAE_rate3_rnn', {}),
         ('TurboAE_rate2_rnn', 'TurboAE_rate2_rnn', {'code_rate_n': 2}),
         ('Turboae_rate3_rnn', 'nbcjr_rate3', {})]


@pytest.mark.parametrize('enc,dec,kw', PAIRS)
def test_forward_ae_matches_jax(enc, dec, kw):
    jcfg, tcfg = configs(encoder=enc, decoder=dec, num_iteration=2, **SMALL_RNN, **kw)
    jp = _np_tree(jae.init_ae(jax.random.PRNGKey(5), jcfg))
    tp = from_jax(jp)
    rng = np.random.RandomState(6)
    bits = (rng.random_sample((4, 12, 1)) < 0.5).astype(np.float32)
    noise = rng.standard_normal((4, 12, tcfg.code_rate_n)).astype(np.float32)
    jperm, tperm = _perms(jcfg, tcfg)
    with jax.default_matmul_precision('highest'):
        ref, rcodes, _ = jae.forward_ae(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(bits),
                                        jnp.asarray(noise), jperm, training=False)
    got, codes, _ = tae.forward_ae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                                   tperm, training=False)
    np.testing.assert_allclose(to_np(codes), np.asarray(rcodes), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_decoder_dropout_share_and_generator(monkeypatch):
    """-dropout 0.3 in training: every call drops ~30 % of its units (4
    sigma), draws only from the forward's generator, and is off in
    evaluation and without a generator; the last iteration's dec2 RNN gets no
    inter-layer dropout, its head does."""
    _, tcfg = configs(decoder='TurboAE_rate3_rnn', num_iteration=2, dropout=0.3, **SMALL_RNN)
    tp = tdec.largernn_init(torch.Generator().manual_seed(0), tcfg)
    rec = torch.randn((64, 12, 3), generator=torch.Generator().manual_seed(1))
    perms = tae.make_perms(tcfg, 'cpu')
    calls = []
    inner = tgru.dropout

    def record(x, rate, generator):
        y = inner(x, rate, generator)
        calls.append((x.shape[-1], float((y == 0).float().mean()), x.numel()))
        return y
    monkeypatch.setattr(tgru, 'dropout', record)
    a = tdec.largernn_apply(tp, tcfg, rec, perms, training=True,
                            generator=torch.Generator().manual_seed(7))
    # 2 iterations x 2 halves: RNN layer 0 and the head, except no RNN mask
    # in the last half-iteration
    widths = [c[0] for c in calls]
    assert widths == [16, 3, 16, 3, 16, 3, 1], widths
    dropped = sum(s * n for _, s, n in calls) / sum(n for *_, n in calls)
    n = sum(n for *_, n in calls)
    assert abs(dropped - 0.3) < 4 * np.sqrt(0.3 * 0.7 / n)
    b = tdec.largernn_apply(tp, tcfg, rec, perms, training=True,
                            generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    calls.clear()
    ev = tdec.largernn_apply(tp, tcfg, rec, perms, training=False,
                             generator=torch.Generator().manual_seed(7))
    no_gen = tdec.largernn_apply(tp, tcfg, rec, perms, training=True)
    assert not calls and torch.equal(ev, no_gen) and not torch.equal(a, ev)


def test_forward_ae_passes_training_and_generator_to_the_decoder(monkeypatch):
    _, tcfg = configs(decoder='TurboAE_rate3_rnn', encoder='Turboae_rate3_rnn', num_iteration=1,
                      dropout=0.5, **SMALL_RNN)
    tp = tae.init_ae(torch.Generator().manual_seed(0), tcfg)
    bits = (torch.rand((8, 12, 1), generator=torch.Generator().manual_seed(1)) < 0.5).float()
    noise = torch.zeros((8, 12, 3))
    perms = tae.make_perms(tcfg, 'cpu')
    seen = []
    inner = tdec.largernn_apply

    def spy(*a, **kw):
        seen.append((kw['training'], kw['generator']))
        return inner(*a, **kw)
    monkeypatch.setitem(tdec.DEC_REGISTRY, 'TurboAE_rate3_rnn', (tdec.largernn_init, spy))
    g = torch.Generator().manual_seed(2)
    tae.forward_ae(tp, tcfg, bits, noise, perms, training=True, generator=g)
    tae.forward_ae(tp, tcfg, bits, noise, perms, training=False, generator=g)
    assert seen == [(True, g), (False, g)]


def _jax_steps(jcfg, jp, batches):
    """JAX's value_and_grad(Trainer._loss) and optax updates, chained over
    the given (mode, bits, noise) batches."""
    jt = JaxTrainer(jcfg)
    par = jax.tree.map(jnp.asarray, jp)
    state = {'enc': jt.opt_enc.init(par['enc']), 'dec': jt.opt_dec.init(par['dec'])}
    losses = []
    for mode, bits, noise in batches:
        h, o = ('enc', 'dec') if mode == 'encoder' else ('dec', 'enc')
        merge = (lambda d, f: {'enc': d, 'dec': f}) if h == 'enc' else \
            (lambda d, f: {'enc': f, 'dec': d})
        with jax.default_matmul_precision('highest'):
            loss, g = jax.value_and_grad(jt._loss)(par[h], par[o], merge,
                                                   jax.random.PRNGKey(0), bits, noise)
        tx = jt.opt_enc if h == 'enc' else jt.opt_dec
        upd, state[h] = tx.update(g, state[h], par[h])
        par = {**par, h: optax.apply_updates(par[h], upd)}
        losses.append(float(loss))
    return losses, par


def test_three_train_steps_of_the_rate3_rnn_pair_match_jax():
    jcfg, tcfg = configs(encoder='Turboae_rate3_rnn', decoder='TurboAE_rate3_rnn',
                         num_iteration=2, batch_size=8, **SMALL_RNN)
    jp = _np_tree(jae.init_ae(jax.random.PRNGKey(7), jcfg))
    rng = np.random.RandomState(8)
    batches = []
    for mode in ('encoder', 'decoder', 'decoder'):
        bits = (rng.random_sample((8, 12, 1)) < 0.5).astype(np.float32)
        noise = rng.standard_normal((8, 12, 3)).astype(np.float32)
        batches.append((mode, bits, noise))
    ref_losses, ref_par = _jax_steps(jcfg, jp, batches)
    tr = Trainer(tcfg, 'cpu', params=from_jax(jp))
    losses = [tr._train_step(m, torch.from_numpy(b), torch.from_numpy(n)).item()
              for m, b, n in batches]
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert tr.opt['enc'].count == 1 and tr.opt['dec'].count == 2
    # Adam's steps are ~lr * sign(g): params within 1e-2 * lr of JAX's, or
    # within 2 lr where the sign of a near-zero gradient may differ
    for a, b in zip(tree_leaves(tr.params), tree_leaves(from_jax(_np_tree(ref_par)))):
        d = (a - b).abs()
        assert float(d.max()) <= 2.0 * 1e-3 * 1.001 and float(d.median()) <= 1e-2 * 1e-3


def test_main_cli_trains_and_reloads_the_rnn_pair(tmp_path, monkeypatch):
    from turboae_tpu_torch.cli import main as cli_main
    from turboae_tpu_torch.train.msgpack_io import load_msgpack
    monkeypatch.chdir(tmp_path)
    argv = ['--device', 'cpu', '-encoder', 'Turboae_rate3_rnn', '-decoder', 'TurboAE_rate3_rnn',
            '-num_epoch', '1', '-num_block', '8', '-batch_size', '8', '-block_len', '10',
            '-enc_num_unit', '6', '-dec_num_unit', '6', '-num_iteration', '2',
            '-num_train_dec', '1', '-snr_points', '1', '-dropout', '0.2']
    tr = cli_main.main(argv)
    ckpt = next((tmp_path / 'tmp').glob('model_*.msgpack'))
    saved = load_msgpack(str(ckpt))
    assert set(saved['params']['dec']['final']) == {'dec1_rnn', 'dec2_rnn', 'dec1_lin', 'dec2_lin'}
    assert int(saved['opt_state']['dec']['0']['count']) == 1
    back = cli_main.main([*argv[:6], '-num_epoch', '0', '-init_nw_weight', str(ckpt),
                          *argv[8:]])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params),
                                                  tree_leaves(tr.params)))


def test_eval_cli_takes_rnn_keys(tmp_path):
    """cli/eval_flagship.py at the Config's widths with the RNN pair, from a
    port-written checkpoint of a seeded init."""
    from turboae_tpu_torch.cli import eval_flagship
    from turboae_tpu_torch.config import Config
    cfg = Config(encoder='Turboae_rate3_rnn', decoder='TurboAE_rate3_rnn', block_len=8)
    ckpt = str(tmp_path / 'rnn.msgpack')
    save_checkpoint(ckpt, tae.init_ae(torch.Generator().manual_seed(0), cfg))
    out = eval_flagship.main(['--ckpt', ckpt, '--encoder', cfg.encoder, '--decoder', cfg.decoder,
                              '--block_len', '8', '--num_block', '2', '--batch_size', '2',
                              '--snr_points', '1', '--dtype', 'float32', '--device', 'cpu',
                              '--out', str(tmp_path / 'e.json')])
    assert out['n_blocks'] == [2] and 0.0 <= out['ber'][0] <= 1.0
    assert json.load(open(tmp_path / 'e.json'))['n_bits'] == [16]
