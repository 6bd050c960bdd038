"""The port's ops against the JAX package's, on identical inputs (CPU).

f32 results agree to 1e-5: both sides compute in f32, the JAX side at
'highest' matmul precision, and differ only in summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.ops import conv1d as jcv
from turboae_tpu.ops import interleave as jil
from turboae_tpu.ops.power import power_constraint as j_power
from turboae_tpu.ops.ste import ste_quantize as j_ste
from turboae_tpu.utils import metrics as jm
from turboae_tpu_torch.ops import conv1d as tcv
from turboae_tpu_torch.ops import interleave as til
from turboae_tpu_torch.ops.activations import activation
from turboae_tpu_torch.ops.power import power_constraint as t_power
from turboae_tpu_torch.ops.ste import ste_quantize as t_ste
from turboae_tpu_torch.train.convert import _layer_from
from turboae_tpu_torch.utils import metrics as tm

from _torch_parity import configs, rel_err


def _stack(rng, num_layer, cin, c, k):
    layers = []
    for i in range(num_layer):
        fan = (cin if i == 0 else c) * k
        layers.append({'w': rng.uniform(-1, 1, (k, cin if i == 0 else c, c)).astype(np.float32) / np.sqrt(fan),
                       'b': rng.uniform(-0.3, 0.3, c).astype(np.float32)})
    return layers


@pytest.mark.parametrize('num_layer,k', [(1, 5), (3, 5), (2, 1), (2, 3)])
def test_stack_apply_f32_matches_jax(num_layer, k):
    rng = np.random.RandomState(num_layer * 10 + k)
    layers = _stack(rng, num_layer, 7, 16, k)
    x = rng.standard_normal((4, 20, 7)).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jcv.stack_apply(jax.tree.map(jnp.asarray, layers), jnp.asarray(x)))
    got = tcv.stack_apply([_layer_from(l, 'cpu') for l in layers], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_stack_apply_bf16_matches_jax():
    rng = np.random.RandomState(1)
    layers = _stack(rng, 3, 7, 16, 5)
    x = rng.standard_normal((4, 20, 7)).astype(np.float32)
    ref = jcv.stack_apply(jax.tree.map(jnp.asarray, layers), jnp.asarray(x),
                          compute_dtype=jnp.bfloat16)
    got = tcv.stack_apply([_layer_from(l, 'cpu') for l in layers], torch.from_numpy(x),
                          compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16          # bf16 convs emit bf16
    assert rel_err(got, np.asarray(ref, np.float32)) < 1e-2


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_linear_apply_matches_jax(dtype):
    rng = np.random.RandomState(2)
    lin = {'w': rng.standard_normal((16, 5)).astype(np.float32),
           'b': rng.standard_normal(5).astype(np.float32)}
    x = rng.standard_normal((3, 10, 16)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == 'float32' else (jnp.bfloat16, torch.bfloat16)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jcv.linear_apply(jax.tree.map(jnp.asarray, lin), jnp.asarray(x), jdt))
    got = tcv.linear_apply(_layer_from(lin, 'cpu'), torch.from_numpy(x), tdt)
    assert got.dtype == torch.float32           # heads return f32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('seed', [0, 7])
def test_interleave_matches_jax(seed):
    p = til.rand_perm(30, seed)
    np.testing.assert_array_equal(p, jil.rand_perm(30, seed))
    np.testing.assert_array_equal(til.invert_perm(p), jil.invert_perm(p))
    x = np.random.RandomState(seed).standard_normal((3, 30, 4)).astype(np.float32)
    pt = torch.as_tensor(p)
    got = til.interleave(torch.from_numpy(x), pt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jil.interleave(jnp.asarray(x), p)))
    back = til.deinterleave(got, torch.as_tensor(til.invert_perm(p)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize('kw', [
    {},
    {'train_channel_mode': 'block_norm_ste'},
    {'enc_truncate_limit': 0.8},
    {'test_channel_mode': 'block_norm_ste'},
    {'no_code_norm': True},
])
@pytest.mark.parametrize('training', [True, False])
def test_power_constraint_matches_jax(kw, training):
    jcfg, tcfg = configs(**kw)
    x = np.random.RandomState(3).standard_normal((6, 24, 3)).astype(np.float32) * 2 + 0.5
    ref, _ = j_power(jnp.asarray(x), jcfg, training)
    got, _ = t_power(torch.from_numpy(x), tcfg, training)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('level', [2, 4])
def test_ste_forward_matches_jax(level):
    x = np.linspace(-2, 2, 41).astype(np.float32)
    ref = np.asarray(j_ste(jnp.asarray(x), 1.0, level, 0.01, 'both'))
    np.testing.assert_array_equal(t_ste(torch.from_numpy(x), 1.0, level).numpy(), ref)


@pytest.mark.parametrize('name', ['elu', 'relu', 'tanh', 'selu', 'sigmoid', 'prelu', 'linear'])
def test_activations_match_jax(name):
    from turboae_tpu.ops.activations import activation as j_act
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(activation(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(j_act(name)(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_metrics_match_jax():
    for snr in (-1.5, 0.0, 2.0):
        assert tm.snr_db2sigma(snr) == jm.snr_db2sigma(snr)
    rng = np.random.RandomState(4)
    bits = (rng.random_sample((8, 12, 1)) < 0.5).astype(np.float32)
    out = np.clip(bits + rng.standard_normal(bits.shape) * 0.4, 0, 1).astype(np.float32)
    be, ke, pe = tm.error_counts(torch.from_numpy(bits), torch.from_numpy(out))
    n_bits = bits.size
    assert int(be) / n_bits == pytest.approx(float(jm.errors_ber(bits, out)))
    assert int(ke) / 8 == pytest.approx(float(jm.errors_bler(bits, out)))
    np.testing.assert_allclose(pe.numpy() / 8, np.asarray(jm.errors_ber_pos(bits, out)), atol=1e-7)


def test_wilson_and_z():
    from scripts.eval_flagship import wilson_ci as j_wilson
    assert tm.wilson_ci(9580, 100000) == j_wilson(9580, 100000)
    assert tm.two_proportion_z(100, 1000, 100, 1000) == 0.0
    assert tm.two_proportion_z(150, 1000, 100, 1000) > 3
