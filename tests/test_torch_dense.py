"""Dense conv stacks, the dense CNN code and DeepTurbo's small forward: the
port against the JAX package on identical params, bits and noise (CPU), and
the model registries.

f32 agrees to 1e-5 (JAX at 'highest' matmul precision; summation order
only). bf16 agrees to 1e-2 relative: both sides round at the same places
but sum in another order, so single roundings may differ by one ulp; the
port's fused dense route (use_fused_conv in bf16) rounds once a layer and
is held to FUSED_BF16_TOL. The small config: 2 iterations, 2 layers, 12
units, L=24.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.models import channel_ae as jae
from turboae_tpu.models.decoders import largecnn_init as j_dec_init
from turboae_tpu.ops import conv1d as jcv
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.models import decoders as tdec
from turboae_tpu_torch.models import encoders as tenc
from turboae_tpu_torch.ops import conv1d as tcv
from turboae_tpu_torch.train.convert import _layer_from, from_jax, to_jax

from _torch_parity import bits_noise, configs, rel_err, small_params

# the fused bf16 route against JAX's unfused bf16: 5.2e-4 to 1.23e-3 over
# the three codes and four seeds; four times the largest
FUSED_BF16_TOL = 5e-3
DENSE_SMALL = dict(enc_num_unit=12, dec_num_unit=12, enc_num_layer=2, dec_num_layer=2,
                   num_iteration=2, block_len=24)
B = 6


def _dense_stack(rng, num_layer, cin, c, k):
    layers = []
    for i in range(num_layer):
        n_in = cin + i * c
        layers.append({'w': rng.uniform(-1, 1, (k, n_in, c)).astype(np.float32) / np.sqrt(n_in * k),
                       'b': rng.uniform(-0.3, 0.3, c).astype(np.float32)})
    return layers


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('num_layer,k', [(1, 5), (3, 5), (4, 3)])
def test_dense_stack_apply_matches_jax(num_layer, k, dtype):
    rng = np.random.RandomState(num_layer * 10 + k)
    layers = _dense_stack(rng, num_layer, 7, 16, k)
    x = rng.standard_normal((4, 20, 7)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == 'float32' else (jnp.bfloat16,
                                                                          torch.bfloat16)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jcv.dense_stack_apply(jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
                                               compute_dtype=jdt), np.float32)
    got = tcv.dense_stack_apply([_layer_from(l, 'cpu') for l in layers], torch.from_numpy(x),
                                compute_dtype=tdt)
    assert got.dtype == tdt and got.shape == (4, 20, 16)
    if dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    else:
        assert rel_err(got, ref) < 1e-2


def test_dense_stack_concat_order():
    """Layer i reads [x, out_0, ..., out_{i-1}]: a weight that reads only
    the channels of out_0 in the third layer sees out_0, not x or out_1."""
    gen = torch.Generator().manual_seed(0)
    layers = tcv.dense_stack_init(gen, 3, 2, 4, 1)
    assert [tuple(p['w'].shape) for p in layers] == [(4, 2, 1), (4, 6, 1), (4, 10, 1)]
    x = torch.randn((1, 5, 2), generator=gen)
    out0 = torch.nn.functional.elu(tcv.conv1d_apply(layers[0], x))
    w = torch.zeros((4, 10, 1))
    w[:, 2:6, 0] = torch.eye(4)                     # picks out_0's channels
    third = [layers[0], layers[1], {'w': w, 'b': torch.zeros(4)}]
    torch.testing.assert_close(tcv.dense_stack_apply(third, x), torch.nn.functional.elu(out0),
                               rtol=0, atol=0)


@pytest.mark.parametrize('encoder', ['TurboAE_rate3_cnn_dense', 'Turbo_rate3_757',
                                     'Turbo_rate3_lte'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('fused', [False, True])
def test_dense_forward_matches_jax(encoder, dtype, fused):
    """forward_ae of the dense CNN code and of DeepTurbo (fixed encoder,
    dense decoder) through convert.from_jax, with use_fused_conv off and on.
    JAX never fuses dense stacks. The port's f32 ignores the flag (1e-5).
    In bf16 the flag routes the decoder's dense stacks through the dense
    kernel's plain version on the CPU (kernels/conv_stack.py:
    dense_stack_bf16_plain), which rounds once a layer where JAX rounds
    the conv, the bias add and the ELU to bf16 in turn: a few more bf16
    steps over the 2 iterations, held to FUSED_BF16_TOL; unfused, JAX's
    1e-2. K2 never launches."""
    jcfg, tcfg = configs(encoder=encoder, decoder='TurboAE_rate3_cnn_dense'
                         if encoder.endswith('dense') else 'TurboAE_rate3_cnn', dtype=dtype,
                         use_fused_conv=fused, **DENSE_SMALL)
    jp, tp = small_params(jcfg, seed=4)
    if encoder.startswith('Turbo_'):
        assert jp['enc'] == {} and tp['enc'] == {}
    bits, noise = bits_noise(np.random.RandomState(4), B, 24)
    with jax.default_matmul_precision('highest'):
        ref, ref_codes, _ = jae.forward_ae(jp, jcfg, jax.random.PRNGKey(0), jnp.asarray(bits),
                                           jnp.asarray(noise), jae.make_perms(jcfg),
                                           training=False)
    from turboae_tpu_torch.kernels import conv_stack as ks
    before = ks.conv_stack_bf16.launches
    got, codes, _ = tae.forward_ae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                                   tae.make_perms(tcfg, 'cpu'), training=False)
    assert ks.conv_stack_bf16.launches == before
    assert got.shape == (B, 24, 1) and codes.shape == (B, 24, 3)
    if encoder.startswith('Turbo_'):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    if dtype == 'float32':
        np.testing.assert_allclose(codes.numpy(), np.asarray(ref_codes), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    else:
        tol = FUSED_BF16_TOL if fused else 1e-2
        assert rel_err(codes, ref_codes) < 1e-2 and rel_err(got, ref) < tol


def test_dense_decoder_keys_off_encoder_name():
    """As JAX tests/test_regressions.py pins it: the flagship encoder with the
    dense decoder's name gives plain stacks; the dense encoder with the
    flagship decoder's name gives dense stacks. The port's shapes equal
    JAX's in both cases."""
    gen = torch.Generator().manual_seed(0)
    for enc, dec, dense in (('TurboAE_rate3_cnn', 'TurboAE_rate3_cnn_dense', False),
                            ('TurboAE_rate3_cnn_dense', 'TurboAE_rate3_cnn', True),
                            ('Turbo_rate3_757', 'TurboAE_rate3_cnn', True)):
        jcfg, tcfg = configs(encoder=enc, decoder=dec, **DENSE_SMALL)
        init, _ = tdec.make_decoder(tcfg)
        got = init(gen, tcfg)
        cins = [tuple(p['w'].shape)[1] for p in got['iters'][0]['dec1_cnn']]
        assert cins == ([7, 19] if dense else [7, 12])
        ref = j_dec_init(jax.random.PRNGKey(0), jcfg)
        assert [t.shape for t in jax.tree.leaves(to_jax({'enc': {}, 'dec': got})['dec'])] == \
            [t.shape for t in jax.tree.leaves(ref)]


def test_dense_and_empty_halves_round_trip_bit_identical():
    for enc in ('TurboAE_rate3_cnn_dense', 'Turbo_rate3_757'):
        jcfg, _ = configs(encoder=enc, **DENSE_SMALL)
        jp, tp = small_params(jcfg, seed=5)
        back = to_jax(from_jax(to_jax(tp)))
        ref = jax.tree.leaves(jp)
        got = jax.tree.leaves(back)
        assert len(got) == len(ref) and jax.tree.structure(back) == jax.tree.structure(
            jax.tree.map(np.asarray, jp))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_every_jax_key_builds_in_the_port():
    """Both registries hold every JAX key, and each key's init builds params
    whose leaves have JAX's shapes (the 2D keys at img_size**2 = block_len)."""
    from turboae_tpu.models.decoders import DEC_REGISTRY
    from turboae_tpu.models.encoders import ENC_REGISTRY
    assert set(tenc.ENC_REGISTRY) == set(ENC_REGISTRY)
    assert set(tdec.DEC_REGISTRY) == set(DEC_REGISTRY)
    small = dict(DENSE_SMALL, block_len=16, img_size=4)
    for field, registry in (('encoder', ENC_REGISTRY), ('decoder', DEC_REGISTRY)):
        for key in registry:
            n = 2 if 'rate2' in key else 3
            jcfg, tcfg = configs(**{field: key}, code_rate_n=n, **small)
            jp, _ = small_params(jcfg)
            got = tae.init_ae(torch.Generator().manual_seed(0), tcfg)
            half = 'enc' if field == 'encoder' else 'dec'
            assert [t.shape for t in jax.tree.leaves(to_jax(got)[half])] == \
                [t.shape for t in jax.tree.leaves(jp[half])], key


def test_registries_refuse_unknown_keys_as_jax_does():
    for field, make in (('encoder', tenc.make_encoder), ('decoder', tdec.make_decoder)):
        _, tcfg = configs(**{field: 'no_such_code'})
        with pytest.raises(ValueError, match=f'unknown {field}'):
            make(tcfg)
