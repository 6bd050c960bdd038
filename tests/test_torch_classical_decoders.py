"""The port's classical layer against the JAX package's on the CPU, fed the
same host numpy inputs: the interleaver, the encoders, the host oracles (MAP,
Viterbi, BP, the turbo decoders), the device decoders (log-BCJR, turbo,
Viterbi, LDPC BP), the channel layer and the on-device Monte-Carlo engine.
Every JAX device function runs through jax.jit on the CPU with the highest
matmul precision; both sides compute in f32 there."""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turboae_tpu.classical import bcjr as jbcjr
from turboae_tpu.classical import channels as jchannels
from turboae_tpu.classical import convcode as jconv
from turboae_tpu.classical import interleavers as jinter
from turboae_tpu.classical import ldpc as jldpc
from turboae_tpu.classical import trellis as jtrellis
from turboae_tpu.classical import turbo as jturbo
from turboae_tpu_torch.classical import bcjr, channels, convcode, interleavers, ldpc, trellis, turbo
from turboae_tpu_torch.utils.metrics import two_proportion_z

from _torch_parity import ROOT

LLR_TOL = 2e-4          # f32 log-BCJR and turbo LLRs, absolute
LDPC_LLR_TOL = 1e-4     # f32 BP output LLRs, absolute
NEAR_ZERO = 1e-3        # decisions are compared where |LLR| exceeds this
DESIGN_FILES = ('96.3.963.txt', '96.33.964.txt')

CODES = {  # name: (memory, generators, feedback, code type)
    '757': ([2], [[7, 5]], 7, 'default'),
    'lte': ([3], [[13, 11]], 13, 'default'),
    '75': ([2], [[7, 5]], 0, 'default'),
    '756': ([2], [[7, 5, 6]], 0, 'default'),
    'rsc57': ([2], [[1, 7]], 5, 'rsc'),
}


def _trellises(name):
    m, g, fb, ct = CODES[name]
    return (jtrellis.Trellis(np.array(m), np.array(g), fb, ct),
            trellis.Trellis(np.array(m), np.array(g), fb, ct))


def _turbo_rx(code, B, L, snr_db, seed):
    """(bits, received (B, L, 3) float64, sigma, p_array) of a turbo code."""
    tj, _ = _trellises(code)
    rng = np.random.RandomState(seed)
    p = jinter.RandInterlv(L, 0).p_array
    msgs = rng.randint(0, 2, (B, L))
    sigma = 10 ** (-snr_db / 20)
    rx = 2.0 * jturbo.turbo_encode_batch(msgs, tj, p) - 1.0 + sigma * rng.randn(B, L, 3)
    return msgs, rx, sigma, p


def _t(x):
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------- interleaver, encoders
@pytest.mark.parametrize('length,seed', [(1, 0), (40, 0), (100, 0), (1000, 0), (100, 7)])
def test_rand_interlv_equals_jax(length, seed):
    got, ref = interleavers.RandInterlv(length, seed), jinter.RandInterlv(length, seed)
    np.testing.assert_array_equal(got.p_array, ref.p_array)
    x = np.random.RandomState(seed).randn(length)
    np.testing.assert_array_equal(got.interlv(x), ref.interlv(x))
    np.testing.assert_array_equal(got.deinterlv(x), ref.deinterlv(x))


@pytest.mark.parametrize('code', list(CODES))
@pytest.mark.parametrize('code_type', ['default', 'rsc'])
def test_conv_encode_equals_jax(code, code_type):
    tj, tp = _trellises(code)
    msgs = np.random.RandomState(1).randint(0, 2, (6, 37))
    got = convcode.conv_encode_batch(msgs, tp, code_type)
    np.testing.assert_array_equal(got, jconv.conv_encode_batch(msgs, tj, code_type))
    for i in (0, 5):
        np.testing.assert_array_equal(convcode.conv_encode(msgs[i], tp, code_type),
                                      jconv.conv_encode(msgs[i], tj, code_type))


@pytest.mark.parametrize('code', ['757', 'lte'])
def test_turbo_encode_equals_jax(code):
    tj, tp = _trellises(code)
    L = 40
    inter_j, inter_p = jinter.RandInterlv(L, 0), interleavers.RandInterlv(L, 0)
    msgs = np.random.RandomState(2).randint(0, 2, (8, L))
    got = turbo.turbo_encode_batch(msgs, tp, inter_p.p_array)
    np.testing.assert_array_equal(got, jturbo.turbo_encode_batch(msgs, tj, inter_j.p_array))
    for i in range(2):
        for a, b in zip(turbo.turbo_encode(msgs[i], tp, tp, inter_p),
                        jturbo.turbo_encode(msgs[i], tj, tj, inter_j)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- BCJR
@pytest.mark.parametrize('code', ['757', 'lte'])
def test_host_map_decode_equals_jax(code):
    tj, tp = _trellises(code)
    _, rx, sigma, _ = _turbo_rx(code, 1, 40, 0.0, 3)
    L_int = np.random.RandomState(4).randn(40) * 3
    for mode in ('compute', 'decode'):
        got = bcjr.map_decode(rx[0, :, 0], rx[0, :, 1], tp, sigma ** 2, L_int, mode)
        ref = jbcjr.map_decode(rx[0, :, 0], rx[0, :, 1], tj, sigma ** 2, L_int, mode)
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-9)
        np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize('code', ['757', 'lte'])
@pytest.mark.parametrize('prior', ['zero', 'moderate', 'beyond_20'])
def test_map_decoder_equals_jax(code, prior):
    """The log-BCJR on the device functions; 'beyond_20' puts |L_int| above
    20, where torch's softplus would switch to its linear branch (the port
    takes log1p-exact logaddexp, as JAX's softplus)."""
    tj, tp = _trellises(code)
    B, L = 8, 40
    _, rx, sigma, _ = _turbo_rx(code, B, L, -1.0, 5)
    rng = np.random.RandomState(6)
    L_int = {'zero': np.zeros((B, L)), 'moderate': 4 * rng.randn(B, L),
             'beyond_20': np.sign(rng.randn(B, L)) * rng.uniform(20, 40, (B, L))}[prior]
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax.jit(jbcjr.make_jax_map_decoder(tj))(
            jnp.asarray(rx[:, :, 0]), jnp.asarray(rx[:, :, 1]), sigma ** 2, jnp.asarray(L_int)))
    got = bcjr.make_map_decoder(tp)(_t(rx[:, :, 0]), _t(rx[:, :, 1]), sigma ** 2, _t(L_int))
    assert got.dtype == torch.float32 and got.shape == (B, L)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LLR_TOL)


@pytest.mark.parametrize('code', ['757', 'lte'])
def test_forward_step_at_t0_underflows_as_pinned(code):
    """At t=0 every state but 0 starts at -1e30, so the forward sum of some
    next states is exactly 0 and the 1e-38 floor (an f32 subnormal) is all
    there is under the log. PyTorch keeps it: log(1e-38) + max, finite. XLA
    on the CPU flushes it to 0: -inf. Such a state weighs e^-87 of the
    largest, so the LLRs of the first steps agree with JAX's all the same."""
    tj, tp = _trellises(code)
    B, L = 4, 3
    _, rx, sigma, _ = _turbo_rx(code, B, L, 0.0, 7)
    S = tp.number_states
    nst = torch.as_tensor(tp.next_state_table)
    ps, pu = convcode.predecessors(tp)
    lalpha = torch.full((B, S), bcjr.NEG)
    lalpha[:, 0] = 0.0
    lg = -torch.rand((B, S, 2), generator=torch.Generator().manual_seed(0))
    lp = torch.full((B, 2), -float(np.log(2.0)))
    new, app = bcjr.forward_step(lalpha, lg, lp, torch.zeros((B, S)), nst,
                                 torch.as_tensor(ps * 2 + pu))
    reached = set(tp.next_state_table[0])
    unreached = [s for s in range(S) if s not in reached]
    assert len(unreached) == S - 2
    assert bool(torch.isfinite(new).all()) and bool(torch.isfinite(app).all())
    # the unreached states sit at log(1e-38) below the largest term
    gap = new[:, unreached] - new[:, sorted(reached)].max(dim=1, keepdim=True).values
    assert float(gap.max()) < -80
    xla = jax.jit(lambda s, m: jnp.log(s + 1e-38) + m)(jnp.zeros(2, jnp.float32), jnp.float32(1.0))
    assert np.isneginf(np.asarray(xla)).all()
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax.jit(jbcjr.make_jax_map_decoder(tj))(
            jnp.asarray(rx[:, :, 0]), jnp.asarray(rx[:, :, 1]), sigma ** 2, jnp.zeros((B, L))))
    got = bcjr.make_map_decoder(tp)(_t(rx[:, :, 0]), _t(rx[:, :, 1]), sigma ** 2, _t(np.zeros((B, L))))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=LLR_TOL)


# ---------------------------------------------------------------- turbo
def _jax_turbo_llr(tj, p, iters, variant, rx, nv):
    """The statistic make_jax_turbo_decoder takes the sign of
    (turboae_tpu/classical/turbo.py:159-193), composed here from the JAX
    package's own log-BCJR: the JAX decoder returns only its bits."""
    map_dec = jbcjr.make_jax_map_decoder(tj)
    p = jnp.asarray(p)
    inv = jnp.zeros_like(p).at[p].set(jnp.arange(p.shape[0]))

    def damp(x):
        return x * 0.9 * jnp.exp(-0.01 * jnp.abs(x))

    def llr(s, p1, p2, nv):
        ws = 2.0 * s / nv
        L_int_1 = jnp.zeros_like(s)
        L_ext_1 = L_post_2 = L_int_1
        for _ in range(iters):
            L_ext_1 = map_dec(s, p1, nv, L_int_1) - L_int_1
            if variant != 'standard':
                L_ext_1 = L_ext_1 - ws
            if variant == 'hazzys_g':
                L_ext_1 = damp(L_ext_1)
            L_int_2 = L_ext_1[:, p]
            L_post_2 = map_dec(s[:, p], p2, nv, L_int_2)
            L_ext_2 = L_post_2 - L_int_2
            if variant == 'hazzys_g':
                L_ext_2 = damp(L_ext_2)
            L_int_1 = L_ext_2[:, inv]
            if variant != 'standard':
                L_int_1 = L_int_1 - ws
        return L_post_2[:, inv] if variant == 'standard' else L_ext_1 + L_int_1 + ws

    with jax.default_matmul_precision('highest'):
        return np.asarray(jax.jit(llr)(*(jnp.asarray(rx[:, :, i]) for i in range(3)), nv))


@pytest.mark.parametrize('code', ['757', 'lte'])
@pytest.mark.parametrize('variant', ['hazzys', 'hazzys_g', 'standard'])
def test_turbo_decoder_equals_jax(code, variant):
    """LLRs within LLR_TOL of the JAX package's log-BCJR iterated as its
    turbo decoder does; the bits equal make_jax_turbo_decoder's wherever
    |LLR| > NEAR_ZERO."""
    tj, tp = _trellises(code)
    B, L, iters = 8, 40, 6
    msgs, rx, sigma, p = _turbo_rx(code, B, L, -1.0, 8)
    with jax.default_matmul_precision('highest'):
        ref_bits = np.asarray(jax.jit(jturbo.make_jax_turbo_decoder(tj, p, iters, variant))(
            *(jnp.asarray(rx[:, :, i]) for i in range(3)), sigma ** 2))
    ref_llr = _jax_turbo_llr(tj, p, iters, variant, rx, sigma ** 2)
    firm = np.abs(ref_llr) > NEAR_ZERO
    np.testing.assert_array_equal((ref_llr > 0)[firm], ref_bits[firm].astype(bool))
    dec = turbo.make_turbo_decoder(tp, p, iters, variant)
    args = [_t(rx[:, :, i]) for i in range(3)]
    llr = dec.llr(*args, sigma ** 2).numpy()
    bits = dec(*args, sigma ** 2)
    assert bits.dtype == torch.int32 and bits.shape == (B, L)
    np.testing.assert_allclose(llr, ref_llr, rtol=0, atol=LLR_TOL)
    firm = np.abs(llr) > NEAR_ZERO
    np.testing.assert_array_equal(bits.numpy()[firm], ref_bits[firm])
    assert np.mean(bits.numpy() != msgs) < 0.1         # it decodes


@pytest.mark.parametrize('variant', ['hazzys', 'hazzys_g', 'standard'])
def test_host_turbo_decoders_equal_jax(variant):
    tj, tp = _trellises('757')
    _, rx, sigma, _ = _turbo_rx('757', 2, 30, 0.0, 9)
    fn = {'hazzys': 'hazzys_turbo_decode', 'hazzys_g': 'hazzys_g_turbo_decode',
          'standard': 'turbo_decode'}[variant]
    inter_j, inter_p = jinter.RandInterlv(30, 0), interleavers.RandInterlv(30, 0)
    for i in range(2):
        got = getattr(turbo, fn)(rx[i, :, 0], rx[i, :, 1], rx[i, :, 2], tp, sigma ** 2, 4, inter_p)
        ref = getattr(jturbo, fn)(rx[i, :, 0], rx[i, :, 1], rx[i, :, 2], tj, sigma ** 2, 4, inter_j)
        np.testing.assert_array_equal(got, ref)


def test_turbo_mc_ber_agrees_with_host_rx_decode():
    """make_turbo_mc draws bits and noise from a torch generator, so its
    counts are held by statistics, not equality: BER and BLER at -1 dB
    (B=512, L=40) within |z| < 4 of the port's decoder fed host-drawn
    symbols (tests/test_classical.py:178-200 does the same for JAX)."""
    _, tp = _trellises('757')
    B, L = 512, 40
    p = interleavers.RandInterlv(L, 0).p_array
    sigma = 10 ** (1.0 / 20)
    be, ble = turbo.make_turbo_mc(tp, p, 6, 'hazzys', batch=B)(
        torch.Generator().manual_seed(0), sigma)
    assert be.dtype == torch.int64 and be.dim() == 0
    msgs, rx, _, _ = _turbo_rx('757', B, L, -1.0, 3)
    dec = turbo.make_turbo_decoder(tp, p, 6, 'hazzys')(*(_t(rx[:, :, i]) for i in range(3)),
                                                      sigma ** 2).numpy()
    err = dec != msgs
    assert 0 < int(be) < B * L // 2
    assert abs(two_proportion_z(int(be), B * L, int(err.sum()), B * L)) < 4
    assert abs(two_proportion_z(int(ble), B, int(err.any(axis=1).sum()), B)) < 4


# ---------------------------------------------------------------- Viterbi
def _viterbi_rx(code, decoding_type, B=6, L=30, sigma=0.9, seed=10):
    tj, _ = _trellises(code)
    rng = np.random.RandomState(seed)
    msgs = rng.randint(0, 2, (B, L))
    coded = jconv.conv_encode_batch(msgs, tj)
    rx = (2.0 * coded - 1 + sigma * rng.randn(*coded.shape)).reshape(B, -1, tj.n)
    if decoding_type == 'hard':
        rx = (rx > 0).astype(float)
    return msgs, rx


@pytest.mark.parametrize('decoding_type', convcode.DECODING_TYPES)
@pytest.mark.parametrize('tb_depth', [None, 10])
def test_host_viterbi_equals_jax(decoding_type, tb_depth):
    tj, tp = _trellises('75')
    _, rx = _viterbi_rx('75', decoding_type, B=3)
    for r in rx:
        np.testing.assert_array_equal(
            convcode.viterbi_decode(r.reshape(-1), tp, tb_depth, decoding_type),
            jconv.viterbi_decode(r.reshape(-1), tj, tb_depth, decoding_type))


@pytest.mark.parametrize('code', ['75', '756'])
@pytest.mark.parametrize('decoding_type', convcode.DECODING_TYPES)
def test_viterbi_equals_jax(code, decoding_type):
    tj, tp = _trellises(code)
    msgs, rx = _viterbi_rx(code, decoding_type)
    ref = np.asarray(jax.jit(jconv.make_jax_viterbi(tj, decoding_type))(
        jnp.asarray(rx, dtype=jnp.float32)))
    got = convcode.make_viterbi(tp, decoding_type)(_t(rx))
    assert got.dtype == torch.int32 and got.shape == rx.shape[:2]
    np.testing.assert_array_equal(got.numpy(), ref)
    assert np.mean(got.numpy()[:, :30] != msgs) < 0.2


@pytest.mark.parametrize('received', ['all_zero', 'half_flipped'])
def test_viterbi_hard_ties_equal_jax(received):
    """Hard metrics are integers: received all zeros or with half the bits
    flipped, nearly every compare is a tie, which JAX's argmin and the port
    both give to the first predecessor."""
    tj, tp = _trellises('75')
    rng = np.random.RandomState(11)
    rx = np.zeros((4, 32, 2)) if received == 'all_zero' else \
        (rng.random_sample((4, 32, 2)) < 0.5).astype(float)
    ref = np.asarray(jax.jit(jconv.make_jax_viterbi(tj, 'hard'))(jnp.asarray(rx, dtype=jnp.float32)))
    np.testing.assert_array_equal(convcode.make_viterbi(tp, 'hard')(_t(rx)).numpy(), ref)


# ---------------------------------------------------------------- LDPC
@pytest.mark.parametrize('name', DESIGN_FILES)
def test_ldpc_design_files_and_params_equal_jax(name):
    ours = os.path.join(ldpc.DESIGNS, name)
    assert filecmp.cmp(ours, os.path.join(ROOT, 'turboae_tpu', 'classical', 'designs', name),
                       shallow=False)
    got, ref = ldpc.get_ldpc_code_params(ours), jldpc.get_ldpc_code_params(ours)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_gallager_design_equals_jax():
    got, ref = ldpc.gallager_ldpc_design(48, 3, 6, seed=3), jldpc.gallager_ldpc_design(48, 3, 6, seed=3)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _ldpc_llr(B, ebn0, seed):
    params = ldpc.get_ldpc_code_params(os.path.join(ldpc.DESIGNS, '96.33.964.txt'))
    nv = 1.0 / (2 * 0.5 * 10 ** (ebn0 / 10.0))
    return params, 2.0 * (1.0 + np.sqrt(nv) * np.random.RandomState(seed).randn(B, 96)) / nv


@pytest.mark.parametrize('alg', ['SPA', 'MSA'])
def test_host_ldpc_bp_decode_equals_jax(alg):
    params, llr = _ldpc_llr(2, 2.0, 12)
    for row in llr:
        got, ref = ldpc.ldpc_bp_decode(row, params, alg, 50), jldpc.ldpc_bp_decode(row, params, alg, 50)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-9)


@pytest.mark.parametrize('alg', ['SPA', 'MSA'])
def test_ldpc_decoder_equals_jax(alg):
    """n=96 at 1.5 dB, B=8: some blocks settle early (and are frozen), some
    never satisfy the parity in 100 iterations. MSA has no transcendental
    function and equals JAX's at any batch. SPA's does, and near its clip
    one ulp of tanh moves an LLR by up to ~1
    (test_spa_check_update_is_ill_conditioned_at_its_clip): over thousands
    of frames XLA's tanh and PyTorch's part some SPA LLRs by more than 1e-4
    and the bits of some frames that never converge, which is why the card
    is held to the CPU by SPA's bits on converged frames and its frame
    errors (chip_smoke.py's classical_parity)."""
    params, llr = _ldpc_llr(8, 1.5, 13)
    ref_bits, ref_llr = jax.jit(jldpc.make_jax_ldpc_decoder(params, alg, 100))(jnp.asarray(llr))
    bits, out = ldpc.make_ldpc_decoder(params, alg, 100)(_t(llr))
    assert bits.dtype == torch.int32 and out.dtype == torch.float32
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref_bits))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_llr), rtol=0, atol=LDPC_LLR_TOL)
    assert 0 < int((bits.numpy().sum(axis=1) > 0).sum()) < 8


def test_spa_check_update_is_ill_conditioned_at_its_clip():
    """SPA's check message is 2 atanh(prod / t), the ratio clipped at
    +-0.9999999 (f32 0.99999988, 2 ulps below 1). Between there and a few
    ulps lower, one ulp of the ratio moves the message by more than 0.1; and
    XLA's tanh and PyTorch's differ by an ulp at some inputs, so two f32
    devices part there while their decisions on converged frames agree."""
    r = torch.tensor([1 - 4 * 2.0 ** -24, 1 - 3 * 2.0 ** -24], dtype=torch.float32)
    step = 2.0 * torch.atanh(r)
    assert float(step[1] - step[0]) > 0.1
    assert float(torch.clamp(torch.tensor(1.0), -0.9999999, 0.9999999)) == 1 - 2 * 2.0 ** -24
    x = np.linspace(-40, 40, 20001).astype(np.float32)
    xla = np.asarray(jax.jit(lambda v: jnp.tanh(v / 2.0))(jnp.asarray(x)))
    port = torch.tanh(torch.as_tensor(x) / 2.0).numpy()
    assert (xla != port).any() and np.abs(xla - port).max() <= 2 * 2.0 ** -23


# ---------------------------------------------------------------- channels
@pytest.mark.parametrize('noise_type', [
    'awgn', 'bsc', 'bec', 'ge', 'ge_awgn', 'fading', 't-dist', 'radar', 'awgn+radar',
    'awgn+radar+denoise', 'hyeji_bursty+denoise', 'radar_saturate', 'radar_erasure',
    'mixture', 'mixture-normalized', 'mix_snr_turbo', 'random_snr_turbo', 'unknown'])
def test_corrupt_signal_equals_jax(noise_type):
    """The same np.random.seed gives the same received symbols: the port draws
    from the global numpy RNG in JAX's order."""
    x = np.random.RandomState(14).randint(0, 2, 300)
    sigma = 0.1 if noise_type in ('bsc', 'bec', 'ge') else 0.8
    kw = dict(sigma=sigma, vv=3.0, radar_power=5.0, radar_prob=0.05, snr_mixture=(0.5, 0, 0.2))
    np.random.seed(15)
    got = channels.corrupt_signal(x, noise_type, **kw)
    np.random.seed(15)
    ref = jchannels.corrupt_signal(x, noise_type, **kw)
    np.testing.assert_array_equal(got, ref)


def test_channel_helpers_equal_jax():
    x = np.random.RandomState(16).randint(0, 2, 200)
    for fn, args in (('awgn', (2.0 * x - 1, 3.0)), ('awgn', ((1 + 1j) * x, 3.0, 0.5)),
                     ('bsc', (x, 0.2)), ('bec', (x, 0.2))):
        np.random.seed(17)
        got = getattr(channels, fn)(*args)
        np.random.seed(17)
        np.testing.assert_array_equal(got, getattr(jchannels, fn)(*args))
    for a, b in zip(channels.get_test_sigmas(-1.5, 2.0, 8), jchannels.get_test_sigmas(-1.5, 2.0, 8)):
        np.testing.assert_array_equal(a, b)
    assert channels.snr_db2sigma(-1.0) == jchannels.snr_db2sigma(-1.0)
    assert channels.snr_sigma2db(0.7) == jchannels.snr_sigma2db(0.7)
