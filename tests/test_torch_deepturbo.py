"""DeepTurbo in the port against the JAX package, on the CPU.

  - the classical trellis tables, and the turbo encoder on the device bit
    for bit against JAX's models/deepturbo.turbo_enc_apply and the host
    oracle classical/turbo.py:turbo_encode_batch (both trellises, L in
    {24, 100, 1000}, random messages), and the convolutional encoder's
    prefix composition against JAX's scan at lengths around powers of two,
    in operations that grow with log2 L;
  - artifacts/deepturbo.msgpack at full width (dense decoder stacks, 100
    units, 5 layers, 6 iterations), f32, batch 8: the port's forward against
    JAX's within 1e-5 (JAX at 'highest' matmul precision);
  - checkpoints: the committed file, read and written back by the port, is
    flax's byte for byte, its empty encoder half included, and loads in
    JAX's load_checkpoint with its step and Adam state.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.classical import convcode as jconv
from turboae_tpu.classical import trellis as jtrellis
from turboae_tpu.classical.turbo import turbo_encode_batch
from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models.deepturbo import turbo_enc_apply as j_turbo_enc
from turboae_tpu.train.checkpoint import load_checkpoint as jax_load
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu_torch.classical import convcode as tconv
from turboae_tpu_torch.classical import trellis as ttrellis
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.models.deepturbo import turbo_enc_apply
from turboae_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from turboae_tpu_torch.train.convert import to_jax
from turboae_tpu_torch.train.msgpack_io import load_msgpack
from turboae_tpu_torch.train.trainer import Trainer

from _torch_parity import ROOT, bits_noise, configs

DEEPTURBO = os.path.join(ROOT, 'artifacts', 'deepturbo.msgpack')
TRELLISES = {'Turbo_rate3_757': 'turbo757_trellis', 'Turbo_rate3_lte': 'turbo_lte_trellis'}


@pytest.mark.parametrize('encoder', sorted(TRELLISES))
def test_trellis_tables_equal_jax(encoder):
    got = getattr(ttrellis, TRELLISES[encoder])()
    ref = getattr(jtrellis, TRELLISES[encoder])()
    assert (got.total_memory, got.number_states, got.n) == (ref.total_memory,
                                                            ref.number_states, ref.n)
    np.testing.assert_array_equal(got.next_state_table, ref.next_state_table)
    np.testing.assert_array_equal(got.output_table, ref.output_table)
    np.testing.assert_array_equal(got.output_bits(), ref.output_bits())
    for v, w in ((5, 3), (13, 4), (11, 2)):         # the index wrap for wide values
        np.testing.assert_array_equal(ttrellis.dec2bitarray(v, w), jtrellis.dec2bitarray(v, w))


@pytest.mark.parametrize('code_type', ['default', 'rsc'])
def test_conv_encoder_equals_jax(code_type):
    tr_t, tr_j = ttrellis.turbo_lte_trellis(), jtrellis.turbo_lte_trellis()
    msgs = (np.random.RandomState(1).random_sample((7, 30)) < 0.5).astype(np.int32)
    ref = np.asarray(jconv.make_jax_encoder(tr_j, code_type)(jnp.asarray(msgs)))
    got = tconv.make_encoder(tr_t, code_type)(torch.from_numpy(msgs))
    assert got.dtype == torch.int64 and got.shape == (7, 33 * 2)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('L', [1, 2, 3, 5, 64, 65, 257])
@pytest.mark.parametrize('code_type', ['default', 'rsc'])
def test_conv_encoder_scan_equals_jax_at_any_length(code_type, L):
    """The encoder's states run as a prefix composition in log2 rounds:
    lengths around a power of two, and one step, give JAX's scan's bits."""
    tr_t, tr_j = ttrellis.turbo757_trellis(), jtrellis.turbo757_trellis()
    msgs = (np.random.RandomState(L).random_sample((5, L)) < 0.5).astype(np.int32)
    ref = np.asarray(jconv.make_jax_encoder(tr_j, code_type)(jnp.asarray(msgs)))
    got = tconv.make_encoder(tr_t, code_type)(torch.from_numpy(msgs))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize('encoder', sorted(TRELLISES))
def test_turbo_encoder_is_not_a_loop_over_positions(encoder):
    """A turbo encoder's call is a few hundred host operations (views
    included) that grow with log2 L (a round of the prefix composition),
    not a few a position (~3,500 at L=100 as a loop): at L=1000 at most half
    again as many as at L=100 (380 and 460 counted)."""
    from torch.profiler import ProfilerActivity, profile
    counts = []
    for L in (100, 1000):
        _, tcfg = configs(encoder=encoder, block_len=L)
        bits = torch.zeros((4, L, 1))
        perms = tae.make_perms(tcfg, 'cpu')
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            turbo_enc_apply({}, tcfg, bits, perms)
        counts.append(sum(e.count for e in prof.key_averages()))
    assert counts[0] < 600 and counts[1] <= 1.5 * counts[0], counts


@pytest.mark.parametrize('L', [24, 100, 1000])
@pytest.mark.parametrize('encoder', sorted(TRELLISES))
def test_turbo_encoder_bit_for_bit(encoder, L):
    jcfg, tcfg = configs(encoder=encoder, block_len=L)
    bits = (np.random.RandomState(L).random_sample((16, L, 1)) < 0.5).astype(np.float32)
    jp, tp = jae.make_perms(jcfg), tae.make_perms(tcfg, 'cpu')
    ref = np.asarray(j_turbo_enc({}, jcfg, jnp.asarray(bits), jp)[0])
    got, stats = turbo_enc_apply({}, tcfg, torch.from_numpy(bits), tp, stats='kept')
    assert stats == 'kept' and got.dtype == torch.float32 and got.shape == (16, L, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    trellis = getattr(jtrellis, TRELLISES[encoder])()
    oracle = turbo_encode_batch(bits[:, :, 0].astype(int), trellis, np.asarray(jp['p1']))
    np.testing.assert_array_equal(got.numpy(), 2.0 * oracle - 1.0)


def test_deepturbo_full_width_forward_matches_jax():
    jcfg, tcfg = configs(encoder='Turbo_rate3_757')
    jt = JaxTrainer(jcfg)
    jparams = jax_load(DEEPTURBO, jt.params)
    tp = load_checkpoint(DEEPTURBO, tae.init_ae(torch.Generator().manual_seed(0), tcfg))
    assert tp['enc'] == {} and len(tp['dec']['iters']) == 6
    assert [tuple(p['w'].shape) for p in tp['dec']['iters'][0]['dec1_cnn']] == \
        [(100, 7 + 100 * i, 5) for i in range(5)]
    bits, noise = bits_noise(np.random.RandomState(8), 8, 100, sigma=1.0)
    with jax.default_matmul_precision('highest'):
        ref, ref_codes, _ = jae.forward_ae(jparams, jcfg, jax.random.PRNGKey(0),
                                           jnp.asarray(bits), jnp.asarray(noise),
                                           jae.make_perms(jcfg), training=False)
    got, codes, _ = tae.forward_ae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                                   tae.make_perms(tcfg, 'cpu'), training=False)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # a decoder that decodes: at 0 dB the trained DeepTurbo errs on few bits
    assert np.mean(np.round(got.numpy()) != bits) < 0.05


def test_deepturbo_checkpoint_round_trips_through_jax(tmp_path):
    """Loaded with its Adam state into a port Trainer and written back, the
    committed file comes out byte for byte; a port-written file after a
    step loads in JAX's load_checkpoint with its step and counts."""
    _, tcfg = configs(encoder='Turbo_rate3_757', batch_size=4, num_train_enc=0)
    tr = Trainer(tcfg, 'cpu')
    assert tr.params['enc'] == {} and tr._leaves['enc'] == []
    tr.params, tr.opt_state, step = load_checkpoint(DEEPTURBO, tr.params, tr.opt_state)
    assert step == 522
    counts = {h: int(load_msgpack(DEEPTURBO)['opt_state'][h]['0']['count']) for h in ('enc', 'dec')}
    assert counts['enc'] == 0 and (tr.opt['enc'].count, tr.opt['dec'].count) == (0, counts['dec'])
    again = str(tmp_path / 'again.msgpack')
    save_checkpoint(again, tr.params, tr.opt_state, step=step)
    with open(again, 'rb') as f, open(DEEPTURBO, 'rb') as g:
        assert f.read() == g.read()

    tr._train_step('decoder')
    tr._train_step('encoder')                       # no params: counts, moves nothing
    path = str(tmp_path / 'dt.msgpack')
    save_checkpoint(path, tr.params, tr.opt_state, step=523)
    saved = load_msgpack(path)
    assert saved['params']['enc'] == {} and saved['opt_state']['enc']['1'] == {}
    assert saved['opt_state']['enc']['0']['mu'] == {} == saved['opt_state']['enc']['0']['nu']
    jcfg, _ = configs(encoder='Turbo_rate3_757')
    jt = JaxTrainer(jcfg)
    params, opt, jstep = jax_load(path, jt.params, jt.opt_state)
    assert jstep == 523 and params['enc'] == {}
    assert int(opt['dec'][0].count) == counts['dec'] + 1 and int(opt['enc'][0].count) == 1
    got = jax.tree.leaves(params['dec'])
    for a, b in zip(got, jax.tree.leaves(to_jax(tr.params)['dec'])):
        np.testing.assert_array_equal(np.asarray(a), b)
