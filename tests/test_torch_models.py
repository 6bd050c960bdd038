"""The port's encoder, decoder and forward_ae against the JAX package's, on
identical params, bits and noise (CPU, small flagship config).

f32 agrees to 1e-5 (JAX at 'highest' matmul precision). bf16 and the fused
kernel path agree to 1e-2 relative: bf16 rounds at the same places on both
sides but sums in another order, so single roundings may differ by one ulp.
The fused path runs the Pallas kernel in interpret mode on the JAX side and
the kernel's plain version on the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models.decoders import largecnn_apply as j_dec
from turboae_tpu.models.encoders import intercnn_apply as j_enc
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.models.decoders import largecnn_apply as t_dec
from turboae_tpu_torch.models.encoders import intercnn_apply as t_enc

from _torch_parity import SMALL, bits_noise, configs, rel_err, small_params

B = 6


def _check(got, ref, exact):
    if exact:
        np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert rel_err(got, ref) < 1e-2


def test_make_perms_matches_jax():
    jcfg, tcfg = configs(**SMALL)
    jp, tp = jae.make_perms(jcfg), tae.make_perms(tcfg, 'cpu')
    for k in ('p1', 'p2'):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    np.testing.assert_array_equal(tp['p1'][tp['p1_inv']].numpy(), np.arange(24))
    np.testing.assert_array_equal(tp['p2'][tp['p2_inv']].numpy(), np.arange(24))
    assert not np.array_equal(tp['p1'].numpy(), tp['p2'].numpy())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_encoder_matches_jax(dtype):
    jcfg, tcfg = configs(dtype=dtype, **SMALL)
    jp, tp = small_params(jcfg)
    bits, _ = bits_noise(np.random.RandomState(0), B, 24)
    with jax.default_matmul_precision('highest'):
        ref, _ = j_enc(jp['enc'], jcfg, jnp.asarray(bits), jae.make_perms(jcfg), training=False)
    got, _ = t_enc(tp['enc'], tcfg, torch.from_numpy(bits), tae.make_perms(tcfg, 'cpu'),
                   training=False)
    _check(got, ref, dtype == 'float32')


@pytest.mark.parametrize('dtype,fused', [('float32', False), ('bfloat16', False),
                                         ('float32', True), ('bfloat16', True)])
def test_decoder_matches_jax(dtype, fused):
    jcfg, tcfg = configs(dtype=dtype, use_fused_conv=fused, **SMALL)
    jp, tp = small_params(jcfg, seed=1)
    received = np.random.RandomState(1).standard_normal((B, 24, 3)).astype(np.float32)
    with jax.default_matmul_precision('highest'), pltpu.force_tpu_interpret_mode():
        ref = j_dec(jp['dec'], jcfg, jnp.asarray(received), jae.make_perms(jcfg))
    got = t_dec(tp['dec'], tcfg, torch.from_numpy(received), tae.make_perms(tcfg, 'cpu'))
    assert got.dtype == torch.float32 and got.shape == (B, 24, 1)
    _check(got, ref, dtype == 'float32' and not fused)


@pytest.mark.parametrize('dtype,rec_quantize', [('float32', False), ('bfloat16', False),
                                                ('float32', True)])
def test_forward_ae_matches_jax(dtype, rec_quantize):
    jcfg, tcfg = configs(dtype=dtype, rec_quantize=rec_quantize, **SMALL)
    jp, tp = small_params(jcfg, seed=2)
    bits, noise = bits_noise(np.random.RandomState(2), B, 24)
    with jax.default_matmul_precision('highest'):
        ref, ref_codes, _ = jae.forward_ae(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(bits),
                                           jnp.asarray(noise), jae.make_perms(jcfg),
                                           training=False)
    got, codes, _ = tae.forward_ae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                                   tae.make_perms(tcfg, 'cpu'), training=False)
    _check(codes, ref_codes, dtype == 'float32')
    _check(got, ref, dtype == 'float32')


def test_one_iteration_decoder_matches_jax():
    kw = dict(SMALL, num_iteration=1)
    jcfg, tcfg = configs(**kw)
    jp, tp = small_params(jcfg, seed=3)
    assert len(tp['dec']['iters']) == 1
    received = np.random.RandomState(3).standard_normal((B, 24, 3)).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref = j_dec(jp['dec'], jcfg, jnp.asarray(received), jae.make_perms(jcfg))
    got = t_dec(tp['dec'], tcfg, torch.from_numpy(received), tae.make_perms(tcfg, 'cpu'))
    _check(got, ref, True)
