"""The port's evaluation sweep on the converted crown checkpoint (CPU).

`sweep_counts` is deterministic given bits and noise: fed the same inputs as
the JAX forward, in f32, its exact error counts equal the JAX package's.
`sweep` draws its own bits and noise, so it is held to the crown's published
counts (artifacts/eval_crown_r4.json) by a two-proportion z statistic.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.config import Config as JaxConfig
from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models.channel_ae import init_ae
from turboae_tpu.train.checkpoint import load_checkpoint
from turboae_tpu_torch.cli import eval_flagship
from turboae_tpu_torch.config import Config as PortConfig
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.train.sweep import sweep, sweep_counts
from turboae_tpu_torch.utils.metrics import snr_db2sigma, two_proportion_z

from _torch_parity import CROWN, CROWN_EVAL, bits_noise


@pytest.fixture(scope='module')
def crown():
    template = init_ae(jax.random.PRNGKey(0), JaxConfig())
    jp = load_checkpoint(CROWN, template)
    return jp, eval_flagship.load_flagship(CROWN, 'cpu')


def _jax_forward(jp, bits, noise):
    jcfg = JaxConfig()
    with jax.default_matmul_precision('highest'):
        out, codes, _ = jae.forward_ae(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(bits),
                                       jnp.asarray(noise), jae.make_perms(jcfg), training=False)
    return np.asarray(out), np.asarray(codes)


def test_crown_f32_forward_matches_jax(crown):
    jp, tp = crown
    bits, noise = bits_noise(np.random.RandomState(0), 16, 100, snr_db2sigma(0.0))
    ref, ref_codes = _jax_forward(jp, bits, noise)
    got, codes, _ = tae.forward_ae(tp, PortConfig(), torch.from_numpy(bits),
                                   torch.from_numpy(noise), tae.make_perms(PortConfig(), 'cpu'),
                                   training=False)
    np.testing.assert_allclose(codes.numpy(), ref_codes, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_sweep_counts_equal_jax_counts(crown):
    jp, tp = crown
    bits, noise = bits_noise(np.random.RandomState(1), 48, 100, snr_db2sigma(-1.0))
    ref, _ = _jax_forward(jp, bits, noise)
    err = np.round(bits.reshape(48, -1)) != np.round(ref.reshape(48, -1))
    be, ke, pe = sweep_counts(tp, PortConfig(), torch.from_numpy(bits), torch.from_numpy(noise))
    assert int(ke) > 5                       # the point has errors to count
    assert int(be) == int(err.sum())
    assert int(ke) == int(err.any(axis=1).sum())
    np.testing.assert_array_equal(pe.numpy(), err.sum(axis=0))


def test_sweep_reproduces_crown_bler(crown):
    """bf16 sweep at 0 dB, 2000 blocks, against the crown's 9580/100000."""
    _, tp = crown
    cfg = PortConfig(batch_size=500, dtype='bfloat16')
    g = torch.Generator().manual_seed(0)
    res = sweep(tp, cfg, [0.0], num_block=2000, device='cpu', generator=g)
    assert set(res) == {'snr', 'ber', 'bler', 'bit_errors', 'blk_errors', 'pos_errors',
                        'n_bits', 'n_blocks'}
    assert res['n_blocks'] == 2000 and res['n_bits'] == 200000
    assert sum(res['pos_errors'][0]) == res['bit_errors'][0]
    with open(CROWN_EVAL) as f:
        ref = json.load(f)
    i = ref['snr'].index(0.0)
    z = two_proportion_z(res['blk_errors'][0], 2000, ref['blk_errors'][i], ref['n_blocks'][i])
    assert abs(z) < 4, z


def test_sweep_is_reproducible_from_its_generator(crown):
    _, tp = crown
    cfg = PortConfig(batch_size=50, dtype='bfloat16', use_fused_conv=True)
    runs = [sweep(tp, cfg, [-1.0], num_block=100, device='cpu',
                  generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert runs[0] == runs[1]


def test_eval_cli_writes_the_jax_schema(tmp_path, capsys):
    out = tmp_path / 'eval.json'
    eval_flagship.main(['--ckpt', CROWN, '--device', 'cpu', '--num_block', '200', '--batch_size', '100',
                        '--snr_points', '2', '--snr_test_start', '0', '--snr_test_end', '1',
                        '--deep_num_block', '300', '--deep_from_snr', '1', '--out', str(out),
                        '--ref', CROWN_EVAL])
    got = json.loads(out.read_text())
    with open(CROWN_EVAL) as f:
        ref = json.load(f)
    assert set(ref) <= set(got)
    assert got['snr'] == [0.0, 1.0] and got['n_blocks'] == [200, 300]
    assert len(got['z_bler_vs_ref']) == 2 and all(abs(z) < 4 for z in got['z_bler_vs_ref'])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
