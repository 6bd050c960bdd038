"""FTAE in the port (models/ftae.py) against the JAX package's on the CPU:
every dec_type and cnn_type, every ftae_power_alloc mode (with learned
weights away from their ones), the ignore_feedback / ignore_prev_code
ablations, both FTAE checkpoints loaded whole at full width, and
checkpoints in the JAX layout both ways. Params from JAX's init (or the
committed files) converted, inputs from numpy at a fixed seed, the JAX side
at 'highest' matmul precision; f32 within 1e-5."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models import ftae as jftae
from turboae_tpu.train.checkpoint import load_checkpoint as jax_load
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.models import ftae as tftae
from turboae_tpu_torch.train.checkpoint import groups, load_checkpoint, save_checkpoint
from turboae_tpu_torch.train.convert import from_jax, to_jax
from turboae_tpu_torch.train.ftae_trainer import FTAETrainer
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.utils.tree import tree_leaves, tree_unflatten

from _torch_parity import ROOT, configs, rel_err, to_np

FTAE = os.path.join(ROOT, 'artifacts', 'ftae.msgpack')
FTAE_PA = os.path.join(ROOT, 'artifacts', 'ftae_pa.msgpack')
SMALL_FTAE = dict(enc_num_unit=8, dec_num_unit=8, enc_num_layer=2, dec_num_layer=2,
                  num_iter_ft=3, num_iteration=2, block_len=10)


def _jax_params(jcfg, seed=0, perturb=True):
    """JAX's init as numpy, with the power-allocation leaves moved off
    their ones so they matter."""
    jp = jax.tree.map(np.asarray, jftae.init_ftae(jax.random.PRNGKey(seed), jcfg))
    if perturb:
        rng = np.random.RandomState(seed + 1)
        for i in (1, 2, 3):
            enc = jp[f'fwd_enc{i}']
            if 'pw' in enc:
                enc['pw'] = rng.uniform(0.5, 1.5, enc['pw'].shape).astype(np.float32)
            if 'ps' in enc:
                enc['ps'] = np.float32(rng.uniform(0.5, 1.5))
    return jp


def _inputs(B, L, seed=2, fb_sigma=0.1):
    rng = np.random.RandomState(seed)
    bits = (rng.random_sample((B, L, 1)) < 0.5).astype(np.float32)
    fwd = rng.standard_normal((B, L, 3)).astype(np.float32)
    fb = (fb_sigma * rng.standard_normal((B, L, 3))).astype(np.float32)
    return bits, fwd, fb


def _both(jcfg, tcfg, jp, tp, B=6):
    bits, fwd, fb = _inputs(B, tcfg.block_len)
    with jax.default_matmul_precision('highest'):
        ref, rcodes = jftae.forward_ftae(jp, jcfg, jnp.asarray(bits), jnp.asarray(fwd),
                                         jnp.asarray(fb), jae.make_perms(jcfg))
    got, codes = tftae.forward_ftae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(fwd),
                                    torch.from_numpy(fb), tae.make_perms(tcfg, 'cpu'))
    assert got.shape == (B, tcfg.block_len, 1) and codes.shape == (B, tcfg.block_len, 3)
    return (got, codes), (ref, rcodes)


def _close(got, ref, tol=1e-5):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize('dec_type,cnn_type', [
    ('cnn', 'normal'), ('turboae_cnn', 'normal'), ('turboae_cnn', 'dense'),
    ('turboae_rnn', 'normal'), ('turboae_sharedcnn', 'normal'),
    ('turboae_sharedcnn', 'dense')])
@pytest.mark.parametrize('num_iteration', [1, 2])
def test_forward_ftae_matches_jax_for_each_decoder(dec_type, cnn_type, num_iteration):
    kw = dict(SMALL_FTAE, dec_type=dec_type, cnn_type=cnn_type, num_iteration=num_iteration)
    jcfg, tcfg = configs(**kw)
    jp = _jax_params(jcfg)
    tp = from_jax(jp)
    init = tftae.init_ftae(torch.Generator().manual_seed(0), tcfg)
    assert [t.shape for t in tree_leaves(init)] == [t.shape for t in tree_leaves(tp)]
    for a, b in zip(jax.tree.leaves(to_jax(tp)), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    (got, codes), (ref, rcodes) = _both(jcfg, tcfg, jp, tp)
    _close(codes, rcodes)
    _close(got, ref)


@pytest.mark.parametrize('channel_mode', ['block_norm', 'block_norm_ste'])
@pytest.mark.parametrize('alloc', ['none', 'pos', 'pos_phase'])
def test_forward_ftae_matches_jax_for_each_power_alloc(alloc, channel_mode):
    jcfg, tcfg = configs(**SMALL_FTAE, ftae_power_alloc=alloc, channel_mode=channel_mode)
    jp = _jax_params(jcfg, seed=3)
    tp = from_jax(jp)
    assert ('pw' in tp['fwd_enc2']) == (alloc != 'none')
    assert ('ps' in tp['fwd_enc3']) == (alloc == 'pos_phase')
    assert 'pw' not in tp['fb_enc1']
    (got, codes), (ref, rcodes) = _both(jcfg, tcfg, jp, tp)
    _close(codes, rcodes)
    _close(got, ref)
    if channel_mode == 'block_norm':
        # each phase keeps uniform whitening's power (n - 1) / n; under
        # pos_phase the three share it (their scalars have unit mean square)
        n = codes[..., 0].numel()
        p = (codes.double() ** 2).mean(dim=(0, 1)).numpy()
        if alloc != 'pos_phase':
            np.testing.assert_allclose(p, np.full(3, (n - 1) / n), rtol=1e-5)
        np.testing.assert_allclose(p.mean(), (n - 1) / n, rtol=1e-5)


@pytest.mark.parametrize('ignore_feedback,ignore_prev_code', [(True, False), (False, True),
                                                               (True, True)])
def test_forward_ftae_ablations_match_jax(ignore_feedback, ignore_prev_code):
    jcfg, tcfg = configs(**SMALL_FTAE, ignore_feedback=ignore_feedback,
                         ignore_prev_code=ignore_prev_code, ftae_power_alloc='pos')
    jp = _jax_params(jcfg, seed=4)
    (got, codes), (ref, rcodes) = _both(jcfg, tcfg, jp, from_jax(jp))
    _close(codes, rcodes)
    _close(got, ref)
    if ignore_prev_code:
        assert float(codes[:, :, :2].abs().max()) == 0.0       # the codes carry the zeros


def test_forward_ftae_bf16_matches_jax():
    jcfg, tcfg = configs(**SMALL_FTAE, dtype='bfloat16', dec_type='turboae_rnn')
    jp = _jax_params(jcfg, seed=5)
    (got, codes), (ref, rcodes) = _both(jcfg, tcfg, jp, from_jax(jp))
    assert rel_err(codes, rcodes) < 2e-2 and rel_err(got, ref) < 2e-2


def test_interleaved_phase3_reads_raw_inputs():
    """The quirk kept from the reference: with is_interleave, phase 3's
    encoder sees the permuted raw inputs, without the BPSK map."""
    _, tcfg = configs(**SMALL_FTAE)
    tp = tftae.init_ftae(torch.Generator().manual_seed(0), tcfg)
    x = torch.rand((3, 10, 5), generator=torch.Generator().manual_seed(1))
    perm = tae.make_perms(tcfg, 'cpu')['p1']
    seen = []
    from turboae_tpu_torch.ops import conv1d
    inner = conv1d.stack_apply

    def spy(layers, inp, **kw):
        seen.append(inp)
        return inner(layers, inp, **kw)
    conv1d.stack_apply = spy
    try:
        tftae._phase_enc_apply(tp['fwd_enc3'], tcfg, x, perm)
        tftae._phase_enc_apply(tp['fwd_enc3'], tcfg, x)
    finally:
        conv1d.stack_apply = inner
    assert torch.equal(seen[0], x[:, perm]) and torch.equal(seen[1], 2.0 * x - 1.0)


@pytest.mark.parametrize('path,alloc', [(FTAE, 'none'), (FTAE_PA, 'pos_phase')])
def test_committed_checkpoints_load_whole_and_match_jax(path, alloc):
    """Full width (block_len 50, 100 units, 6 iterations, 5-layer decoder
    stacks), batch 32, 0 dB, feedback at 40 dB. Both files' fb_enc2 has
    saturated its ELU: its outputs lie within ~3e-5 of -1, so whitening
    them amplifies one-ulp differences of the conv and the rounding of an
    f32 mean by ~1e5 and phase 3's code is not comparable element by
    element between two implementations (JAX on the CPU against the port;
    the port whitens in f64). Everything on either side of that is held
    at 1e-4: every phase encoder before its whitening, the codes of
    phases 1 and 2, and the decoder on JAX's received signal. The curve
    tests hold the whole path."""
    jcfg, tcfg = configs(block_len=50, ftae_power_alloc=alloc)
    template = tftae.init_ftae(torch.Generator().manual_seed(0), tcfg)
    stats = {}
    tp = load_checkpoint(path, template, stats=stats)
    # counted in the file's layout, where the scan's iterations are stacked
    assert stats['kept'] == 0 and stats['merged'] == len(jax.tree.leaves(to_jax(template)))
    jp = jax_load(path, jftae.init_ftae(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(6)
    bits = (rng.random_sample((32, 50, 1)) < 0.5).astype(np.float32)
    fwd = rng.standard_normal((32, 50, 3)).astype(np.float32)
    fb = (0.01 * rng.standard_normal((32, 50, 3))).astype(np.float32)
    jperm, tperm = jae.make_perms(jcfg), tae.make_perms(tcfg, 'cpu')
    with jax.default_matmul_precision('highest'):
        ref, rcodes = jftae.forward_ftae(jp, jcfg, jnp.asarray(bits), jnp.asarray(fwd),
                                         jnp.asarray(fb), jperm)
        received = jnp.asarray(rcodes) + jnp.asarray(fwd)
        ref_dec = jftae._ftae_dec_apply(jp['dec'], jcfg, received, jperm)
        x = rng.standard_normal((32, 50, 5)).astype(np.float32)
        ref_pre = {k: jax.nn.elu(jftae.cv.linear_apply(
            jp[k]['lin'], jftae.cv.stack_apply(jp[k]['cnn'], jnp.asarray(2 * x[..., :n] - 1))))
            for k, n in PHASE_INPUTS}
    got, codes = tftae.forward_ftae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(fwd),
                                    torch.from_numpy(fb), tperm)
    _close(codes[..., :2], np.asarray(rcodes)[..., :2], 1e-4)
    got_dec = tftae._ftae_dec_apply(tp['dec'], tcfg, torch.from_numpy(np.array(received)), tperm)
    _close(got_dec, ref_dec, 1e-4)
    for k, n in PHASE_INPUTS:
        pre = torch.nn.functional.elu(tftae.cv.linear_apply(
            tp[k]['lin'], tftae.cv.stack_apply(tp[k]['cnn'], torch.from_numpy(2 * x[..., :n] - 1))))
        assert rel_err(pre, ref_pre[k]) < 1e-5, k
    assert float((got.round() != torch.from_numpy(bits)).float().mean()) < 0.2


PHASE_INPUTS = (('fwd_enc1', 1), ('fwd_enc2', 3), ('fwd_enc3', 5), ('fb_enc1', 1),
                ('fb_enc2', 2))


def test_ftae_pa_round_trip_is_byte_identical(tmp_path):
    """ftae_pa.msgpack read with its Adam state (enc: fwd_enc1-3; dec:
    fb_enc1, fb_enc2 and dec) and written back comes out byte for byte."""
    _, tcfg = configs(block_len=50, ftae_power_alloc='pos_phase')
    tr = FTAETrainer(tcfg, 'cpu')
    params, opt, step = load_checkpoint(FTAE_PA, tr.params, tr.opt_state)
    saved = load_msgpack(FTAE_PA)
    assert step == 1200 and opt['enc']['count'] == int(saved['opt_state']['enc']['0']['count'])
    assert [t.shape for t in opt['dec']['mu']] == \
        [t.shape for t in tree_leaves(groups(params)['dec'])]
    out = str(tmp_path / 'back.msgpack')
    save_checkpoint(out, params, opt, step)
    with open(FTAE_PA, 'rb') as a, open(out, 'rb') as b:
        assert a.read() == b.read()


def test_port_written_ftae_checkpoint_loads_in_jax(tmp_path):
    jcfg, tcfg = configs(**SMALL_FTAE, ftae_power_alloc='pos_phase',
                         dec_type='turboae_rnn', batch_size=4)
    tr = FTAETrainer(tcfg, 'cpu')
    tr._train_step('encoder')
    tr._train_step('decoder')
    path = str(tmp_path / 'f.msgpack')
    save_checkpoint(path, tr.params, tr.opt_state, step=3)
    template = jax.tree.map(np.asarray, jftae.init_ftae(jax.random.PRNGKey(0), jcfg))
    from turboae_tpu.train.ftae_trainer import FTAETrainer as JFT
    jt = JFT(jcfg)
    stats = {}
    params, opt, step = jax_load(path, template, jt.opt_state, stats)
    assert step == 3 and stats['kept'] == 0
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(to_jax(tr.params))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(opt['enc'][0].count) == 1 and int(opt['dec'][0].count) == 1
    mu_dec = to_jax(tree_unflatten(groups(tr.params)['dec'], tr.opt['dec'].mu))
    for a, b in zip(jax.tree.leaves(opt['dec'][0].mu), jax.tree.leaves(mu_dec)):
        np.testing.assert_array_equal(np.asarray(a), b)
