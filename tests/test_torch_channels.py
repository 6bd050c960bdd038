"""The port's channels (channels/noise.py, channels/apply.py) and metric
helpers against the JAX package's, on the CPU.

Samplers draw from different streams (torch.Generator against jax.random), so
each statistic of tests/test_channels.py is computed on both sides with that
test's bounds. Everything deterministic is compared on identical inputs: the
application of every channel given the same noise (and, for fading, the
gain JAX draws from its key), the Gilbert-Elliott chain given the same
transition uniforms, forward_ae under every channel in f32 to 1e-5 relative
(JAX at 'highest' matmul precision), and the metric helpers exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.channels import apply as japply
from turboae_tpu.channels import noise as jnoise
from turboae_tpu.models import channel_ae as jae
from turboae_tpu.utils import metrics as jm
from turboae_tpu_torch.channels import apply as tapply
from turboae_tpu_torch.channels import noise as tnoise
from turboae_tpu_torch.models import channel_ae as tae
from turboae_tpu_torch.utils import metrics as tm

from _torch_parity import SMALL, configs, small_params, to_np

CHANNELS = ('awgn', 't-dist', 'radar', 'ge_awgn', 'bec', 'bsc', 'ge', 'fading')
SHAPE = (200, 50, 3)


# ------------------------------------------------------------ statistics
class _Jax:
    """The JAX package's samplers, behind the calls the cases make."""
    name = 'jax'

    def __init__(self):
        self.key = jax.random.PRNGKey(0)

    def _k(self):
        self.key, k = jax.random.split(self.key)
        return k

    def sample(self, shape, sigma, **spec):
        return np.asarray(jnoise.sample_noise(self._k(), shape, jnoise.NoiseSpec(**spec), sigma))

    def train_sigma(self, shape, lo, hi):
        return np.asarray(jnoise.train_sigma(self._k(), shape, lo, hi))

    def generate(self, shape, test_sigma=None, mode='encoder', **cfg):
        jcfg, _ = configs(**cfg)
        return np.asarray(jnoise.generate_noise(self._k(), shape, jcfg, test_sigma=test_sigma,
                                                mode=mode))

    def apply(self, codes, noise, channel):
        return np.asarray(japply.apply_channel(self._k(), jnp.asarray(codes), jnp.asarray(noise),
                                               channel))


class _Port:
    name = 'port'

    def __init__(self):
        self.g = torch.Generator().manual_seed(0)

    def sample(self, shape, sigma, **spec):
        return tnoise.sample_noise(shape, tnoise.NoiseSpec(**spec), sigma, self.g, 'cpu').numpy()

    def train_sigma(self, shape, lo, hi):
        return tnoise.train_sigma(shape, lo, hi, self.g, 'cpu').numpy()

    def generate(self, shape, test_sigma=None, mode='encoder', **cfg):
        _, tcfg = configs(**cfg)
        return tnoise.generate_noise(shape, tcfg, self.g, 'cpu', test_sigma=test_sigma,
                                     mode=mode).numpy()

    def apply(self, codes, noise, channel):
        return tapply.apply_channel(torch.from_numpy(codes), torch.from_numpy(noise), channel,
                                    self.g).numpy()


def _awgn_sigma(s):
    assert abs(s.sample(SHAPE, 0.5, channel='awgn').std() - 0.5) < 0.01


def _train_sigma_range(s):
    arr = s.train_sigma(SHAPE, -1.5, 2.0)
    assert arr.min() >= tm.snr_db2sigma(2.0) - 1e-6 and arr.max() <= tm.snr_db2sigma(-1.5) + 1e-6


def _t_dist_variance(s):
    # sqrt((v-2)/v) t_v has unit variance (reference channels.py:38)
    assert abs(s.sample((500, 100, 3), 1.0, channel='t-dist', vv=5.0).std() - 1.0) < 0.05


def _radar_burst_rate(s):
    n = s.sample((500, 100, 3), 0.1, channel='radar', radar_prob=0.05, radar_power=10.0)
    assert 0.02 < np.mean(np.abs(n) > 1.0) < 0.08


def _bsc_mask_prob(s):
    n = s.sample(SHAPE, 0.1, channel='bsc')
    assert set(np.unique(n)) <= {0.0, 1.0} and abs(n.mean() - 0.9) < 0.01


def _ge_awgn_two_states(s):
    std = s.generate((100, 200, 3), test_sigma=0.0, channel='ge_awgn').std()
    assert tm.snr_db2sigma(1.0) < std < tm.snr_db2sigma(-1.0)


def _ge_markov_semantics(s):
    # from good P(stay good) = 0.8, from bad P(return to good) = 0.8: the
    # stationary good share is 0.8 and P(state_t == state_t+1) = 0.68
    n = s.sample((200, 500, 1), 0.0, channel='ge')
    assert 0.77 < n.mean() < 0.83
    assert 0.64 < np.mean(n[:, :-1, 0] == n[:, 1:, 0]) < 0.72


def _apply_semantics(s):
    codes, noise = np.ones((2, 4, 3), np.float32), np.full((2, 4, 3), 0.25, np.float32)
    for channel, want in (('awgn', 1.25), ('bec', 0.25), ('bsc', -0.5), ('ge', -0.5)):
        np.testing.assert_allclose(s.apply(codes, noise, channel), want)


def _fading_gain_moments(s):
    rx = s.apply(np.ones((500, 100, 3), np.float32), np.zeros((500, 100, 3), np.float32),
                 'fading')
    # h = R / sqrt(3.14/2) with R Rayleigh(1): E[R] = sqrt(pi/2), E[R^2] = 2
    assert abs(rx.mean() - math.sqrt(math.pi / 2) / math.sqrt(3.14 / 2)) < 0.01
    assert abs((rx ** 2).mean() - 2.0 / (3.14 / 2)) < 0.02


STATS = [_awgn_sigma, _train_sigma_range, _t_dist_variance, _radar_burst_rate, _bsc_mask_prob,
         _ge_awgn_two_states, _ge_markov_semantics, _apply_semantics, _fading_gain_moments]


@pytest.mark.parametrize('side', [_Port, _Jax], ids=['port', 'jax'])
@pytest.mark.parametrize('case', STATS, ids=[f.__name__[1:] for f in STATS])
def test_channel_statistics(case, side):
    case(side())


@pytest.mark.parametrize('channel,p_enc,p_dec', [('bec', 'bec_p', 'bec_p_dec'),
                                                 ('bsc', 'bsc_p', 'bsc_p_dec'),
                                                 ('ge', 'bsc_p', 'bsc_p_dec')])
def test_training_probability_follows_the_phase(channel, p_enc, p_dec):
    """bec/bsc/ge train at the static probability of the phase (JAX
    noise.py:144-149): the keep share is 1 - p for bec/bsc; for ge the bad
    state keeps w.p. p, so the keep share is 0.8 + 0.2 p."""
    cfg = {'channel': channel, p_enc: 0.1, p_dec: 0.3}
    for s in (_Port(), _Jax()):
        for mode, p in (('encoder', 0.1), ('decoder', 0.3)):
            keep = s.generate((200, 100, 3), mode=mode, **cfg).mean()
            want = 0.8 + 0.2 * p if channel == 'ge' else 1.0 - p
            assert abs(keep - want) < 0.01, (s.name, mode, keep)


def test_t_dist_matches_jax_distribution():
    """vv=3, the robustness checkpoint's: unit variance is infinite-tailed
    there, so compare the quantiles of the port's and JAX's draws (2e5
    each; their standard error is below 0.01 between the 5 % and 95 %
    quantiles)."""
    n = 200000
    got = tnoise.student_t((n,), 3.0, torch.Generator().manual_seed(1), 'cpu').numpy()
    ref = np.asarray(jnoise._student_t(jax.random.PRNGKey(1), (n,), 3.0))
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(got, qs), np.quantile(ref, qs), atol=0.015)


# ------------------------------------------------------------ exact checks
def _jax_gain(key, shape):
    """The fading gain JAX's apply_channel draws from `key` (apply.py:28-31)."""
    k1, k2 = jax.random.split(key)
    return np.asarray(jnp.sqrt(jax.random.normal(k1, shape) ** 2 + jax.random.normal(k2, shape) ** 2)
                      / jnp.sqrt(3.14 / 2.0))


@pytest.fixture
def jax_gain(monkeypatch):
    """Make the port's fading gain the one JAX draws from the key given."""
    def use(key):
        monkeypatch.setattr(tapply, 'fading_gain', lambda shape, g, dev: torch.tensor(
            _jax_gain(key, tuple(shape)), device=dev))
    return use


@pytest.mark.parametrize('channel', CHANNELS + ('unknown',))
def test_apply_channel_equals_jax(channel, jax_gain):
    rng = np.random.RandomState(0)
    codes = rng.standard_normal((4, 10, 3)).astype(np.float32)
    noise = rng.standard_normal((4, 10, 3)).astype(np.float32)
    if channel in ('bec', 'bsc', 'ge'):
        noise = (noise > 0).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jax_gain(key)
    ref = np.asarray(japply.apply_channel(key, jnp.asarray(codes), jnp.asarray(noise), channel))
    got = tapply.apply_channel(torch.from_numpy(codes), torch.from_numpy(noise), channel,
                               torch.Generator()).numpy()
    np.testing.assert_array_equal(got, ref)


def test_fading_without_a_generator_raises():
    with pytest.raises(ValueError, match='generator'):
        tapply.apply_channel(torch.ones(1, 2, 3), torch.zeros(1, 2, 3), 'fading')


@pytest.mark.parametrize('p_gg,p_bb', [(0.8, 0.8), (0.9, 0.3), (0.3, 0.9)],
                         ids=['closed_form', 'loop_sticky', 'loop_flappy'])
def test_ge_chain_equals_jax_scan(p_gg, p_bb):
    """Given the uniforms JAX's _ge_scan draws from its key ((L, B, C), here
    moved to (B, L, C)), the port's chain emits the same values: by the
    closed form when p_gg == p_bb, by the loop over time otherwise."""
    b, l, c = 5, 40, 3
    rng = np.random.RandomState(1)
    eg = rng.standard_normal((b, l, c)).astype(np.float32)
    eb = rng.standard_normal((b, l, c)).astype(np.float32) + 10.0
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jnoise._ge_scan(key, (b, l, c), jnp.asarray(eg), jnp.asarray(eb), p_gg, p_bb))
    stay = np.swapaxes(np.asarray(jax.random.uniform(key, (l, b, c))), 0, 1)
    good = tnoise.ge_states(torch.from_numpy(stay.copy()), p_gg, p_bb)
    got = torch.where(good, torch.from_numpy(eg), torch.from_numpy(eb)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert good[:, 0].all() and not good.all()


def _channel_noise(channel, rng, shape):
    if channel in ('bec', 'bsc', 'ge'):
        return (rng.random_sample(shape) > 0.1).astype(np.float32)
    return (0.8 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize('channel', CHANNELS)
def test_forward_ae_equals_jax_under_every_channel(channel, jax_gain):
    """Small flagship config, f32, same params, bits and noise (a keep mask
    for bec/bsc/ge), and for fading JAX's gain: outputs and codes to 1e-5
    relative."""
    jcfg, tcfg = configs(channel=channel, **SMALL)
    jp, tp = small_params(jcfg)
    rng = np.random.RandomState(2)
    bits = (rng.random_sample((6, 24, 1)) < 0.5).astype(np.float32)
    noise = _channel_noise(channel, rng, (6, 24, 3))
    key = jax.random.PRNGKey(4)
    jax_gain(jax.random.split(key)[0])     # forward_ae's k_chan
    with jax.default_matmul_precision('highest'):
        ref, ref_codes, _ = jae.forward_ae(jp, jcfg, key, jnp.asarray(bits), jnp.asarray(noise),
                                           jae.make_perms(jcfg), training=False)
    got, codes, _ = tae.forward_ae(tp, tcfg, torch.from_numpy(bits), torch.from_numpy(noise),
                                   tae.make_perms(tcfg, 'cpu'), training=False,
                                   generator=torch.Generator())
    ref, ref_codes = np.asarray(ref), np.asarray(ref_codes)
    assert np.abs(to_np(codes) - ref_codes).max() <= 1e-5 * np.abs(ref_codes).max()
    assert np.abs(to_np(got) - ref).max() <= 1e-5 * np.abs(ref).max()


# ------------------------------------------------------------ metrics
def _metric_inputs():
    rng = np.random.RandomState(5)
    y = (rng.random_sample((64, 30, 1)) < 0.5).astype(np.float32)
    # estimates near the decision boundary, so every helper sees errors
    p = np.clip(y + rng.standard_normal(y.shape).astype(np.float32) * 0.3, 0, 1)
    mask = np.ones(30, np.float32)
    mask[[2, 7, 29]] = 0.0
    codes = rng.standard_normal((64, 30, 3)).astype(np.float32)
    return y, p, mask, codes


METRICS = {
    'errors_ber': lambda M, y, p, m, c: M.errors_ber(y, p),
    'errors_ber_pos': lambda M, y, p, m, c: M.errors_ber_pos(y, p),
    'errors_ber_punctured': lambda M, y, p, m, c: M.errors_ber_punctured(y, p, m),
    'errors_ber_list': lambda M, y, p, m, c: M.errors_ber_list(y, p),
    'errors_bler': lambda M, y, p, m, c: M.errors_bler(y, p),
    'errors_bler_punctured': lambda M, y, p, m, c: M.errors_bler(y, p, m),
    'code_power': lambda M, y, p, m, c: M.code_power(c),
}


@pytest.mark.parametrize('name', list(METRICS))
def test_metric_helpers_equal_jax(name):
    """Bit for bit where the sums are error counts (the port takes a mean
    as XLA does, sum times the reciprocal); code_power sums real values,
    which XLA orders its own way: there to 1e-6 relative (2 ulp)."""
    y, p, mask, codes = _metric_inputs()
    ref = np.asarray(METRICS[name](jm, *map(jnp.asarray, (y, p, mask, codes))))
    got = METRICS[name](tm, *map(torch.from_numpy, (y, p, mask, codes))).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if name == 'code_power':
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, ref)
    assert 0 < np.max(got)


@pytest.mark.parametrize('x', [0.1, 0.5, 1.0, 1.7])
def test_snr_conversions_equal_jax(x):
    assert tm.snr_sigma2db(x) == jm.snr_sigma2db(x)
    assert tm.snr_db2sigma(x) == jm.snr_db2sigma(x)
    assert abs(tm.snr_db2sigma(tm.snr_sigma2db(x)) - x) < 1e-12
