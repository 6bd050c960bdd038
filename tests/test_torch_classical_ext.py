"""The port's host-only classical modules against the JAX package's, on the
same inputs: the commpy modules (GF(2^m), cyclic codes, PSK/QAM, OFDM, MIMO,
filters, utilities) on the golden vectors of tests/test_classical_ext.py,
equal exactly for integer outputs and to 1e-12 for f64; and the C++ oracle
(`native`), whose decisions equal JAX's bit for bit and the port's numpy
oracle's."""
import numpy as np
import pytest

import turboae_tpu.classical.algcode as j_algcode
import turboae_tpu.classical.dsp as j_dsp
import turboae_tpu.classical.gfields as j_gfields
import turboae_tpu.classical.modem as j_modem
import turboae_tpu.classical.utilities as j_utilities
import turboae_tpu.native as j_native
from turboae_tpu.classical.trellis import Trellis as JTrellis
from turboae_tpu.classical.trellis import turbo757_trellis as j_turbo757
from turboae_tpu_torch import native
from turboae_tpu_torch.classical import algcode, dsp, gfields, modem, utilities
from turboae_tpu_torch.classical.convcode import conv_encode_batch, viterbi_decode
from turboae_tpu_torch.classical.interleavers import RandInterlv
from turboae_tpu_torch.classical.trellis import Trellis, turbo757_trellis
from turboae_tpu_torch.classical.turbo import (hazzys_g_turbo_decode, hazzys_turbo_decode,
                                               turbo_encode_batch)

BOTH = [pytest.param((gfields, algcode, modem, dsp, utilities), id='port'),
        pytest.param((j_gfields, j_algcode, j_modem, j_dsp, j_utilities), id='jax')]


def same(a, b):
    """Exactly for integer outputs, to 1e-12 for floating ones."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    if a.dtype.kind in 'fc':
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- commpy
@pytest.mark.parametrize('mods', BOTH)
def test_gf_golden_vectors(mods):
    gf = mods[0]
    m = 3
    y = np.array([6, 4, 3, 1, 2, 0, 5, 7])
    np.testing.assert_array_equal((gf.GF(np.arange(8), m) + gf.GF(y, m)).elements,
                                  [6, 5, 1, 2, 6, 5, 3, 0])
    np.testing.assert_array_equal((gf.GF(np.arange(7, -1, -1), m) * gf.GF(y, m)).elements,
                                  [4, 5, 4, 4, 6, 0, 5, 0])
    np.testing.assert_array_equal(gf.GF(np.arange(7), m).power_to_tuple().elements,
                                  [1, 2, 4, 3, 6, 7, 5])
    x = gf.GF(np.arange(1, 16), 4)
    np.testing.assert_array_equal(x.tuple_to_power().elements,
                                  [0, 1, 4, 2, 8, 5, 10, 3, 14, 9, 7, 6, 13, 11, 12])
    np.testing.assert_array_equal(x.order(), [1, 15, 15, 15, 15, 3, 3, 5, 15, 5, 15, 5, 15, 15, 5])
    np.testing.assert_array_equal(gf.GF(np.arange(16), 4).minpolys(),
                                  [2, 3, 19, 19, 19, 19, 7, 7, 31, 25, 31, 25, 31, 25, 25, 31])


@pytest.mark.parametrize('m', [3, 4, 5, 6])
def test_gf_port_equals_jax(m):
    rng = np.random.RandomState(m)
    a, b = rng.randint(0, 2 ** m, 40), rng.randint(0, 2 ** m, 40)
    assert gfields.polydivide(0b1011011, 0b1011) == j_gfields.polydivide(0b1011011, 0b1011)
    x, y = gfields.GF(a, m), gfields.GF(b, m)
    jx, jy = j_gfields.GF(a, m), j_gfields.GF(b, m)
    same((x + y).elements, (jx + jy).elements)
    same((x * y).elements, (jx * jy).elements)
    same(gfields.GF(np.arange(2 ** m), m).minpolys(), j_gfields.GF(np.arange(2 ** m), m).minpolys())
    same(gfields.GF(np.arange(1, 2 ** m), m).order(), j_gfields.GF(np.arange(1, 2 ** m), m).order())
    assert [c.elements.tolist() for c in x.cosets()] == [c.elements.tolist() for c in jx.cosets()]
    assert gfields.poly_to_string(0b10011) == j_gfields.poly_to_string(0b10011)
    assert gfields.polymultiply(5, 7, 3, 0b1011) == j_gfields.polymultiply(5, 7, 3, 0b1011)


@pytest.mark.parametrize('n,k,want', [
    (15, 4, [2479, 3171, 3929]),
    (31, 21, [1137, 1207, 1219, 1395, 1453, 1503, 1547, 1561, 1653, 1667, 1787, 1897,
              1903, 1975, 2013])])
def test_cyclic_code_genpoly_golden(n, k, want):
    got = algcode.cyclic_code_genpoly(n, k)
    same(got, j_algcode.cyclic_code_genpoly(n, k))
    assert sorted(got) == want


@pytest.mark.parametrize('which', ['psk2', 'psk4', 'psk8', 'qam16', 'qam64'])
def test_modems_port_equal_jax(which):
    kind, m = which[:3], int(which[3:])
    port = (modem.PSKModem if kind == 'psk' else modem.QAMModem)(m)
    ref = (j_modem.PSKModem if kind == 'psk' else j_modem.QAMModem)(m)
    same(port.constellation, ref.constellation)
    rng = np.random.RandomState(m)
    bits = rng.randint(0, 2, 12 * port.num_bits_symbol)
    sym = port.modulate(bits)
    same(sym, ref.modulate(bits))
    np.testing.assert_array_equal(port.demodulate(sym, 'hard'), bits)   # the round trip
    noisy = sym + 0.3 * (rng.randn(len(sym)) + 1j * rng.randn(len(sym)))
    same(port.demodulate(noisy, 'hard'), ref.demodulate(noisy, 'hard'))
    same(port.demodulate(noisy, 'soft', noise_var=0.5),
         ref.demodulate(noisy, 'soft', noise_var=0.5))


def test_soft_demod_llr_sign():
    bits = np.array([0, 1, 0, 1])
    llr = modem.PSKModem(2).demodulate(modem.PSKModem(2).modulate(bits), 'soft', noise_var=0.5)
    assert np.all((llr > 0) == bits.astype(bool))       # log(P(bit=1)/P(bit=0))


def test_ofdm_and_mimo_port_equal_jax():
    rng = np.random.RandomState(3)
    nsc, nfft, cp = 8, 16, 4
    x = rng.randn(nsc, 3) + 1j * rng.randn(nsc, 3)
    tx = modem.ofdm_tx(x, nfft, nsc, cp)
    same(tx, j_modem.ofdm_tx(x, nfft, nsc, cp))
    rx = modem.ofdm_rx(tx, nfft, nsc, cp)
    same(rx, j_modem.ofdm_rx(tx, nfft, nsc, cp))
    np.testing.assert_allclose(rx, x, atol=1e-10)
    const = modem.PSKModem(4).constellation
    h = rng.randn(2, 2) + 1j * rng.randn(2, 2)
    sent = np.array([const[1], const[2]])
    y = h @ sent + 0.05 * rng.randn(2)
    got = modem.mimo_ml(y, h, const)
    same(got, j_modem.mimo_ml(y, h, const))
    np.testing.assert_allclose(modem.mimo_ml(np.eye(2) @ sent, np.eye(2), const), sent)


@pytest.mark.parametrize('alpha', [0.35, 0.5, 1.0])
def test_filters_and_sequences_port_equal_jax(alpha):
    for name in ('rcosfilter', 'rrcosfilter', 'gaussianfilter'):
        t, h = getattr(dsp, name)(64, alpha, 1.0, 8.0)
        jt, jh = getattr(j_dsp, name)(64, alpha, 1.0, 8.0)
        same(t, jt)
        same(h, jh)
        assert len(h) == 64 and np.isfinite(h).all()
    same(dsp.rectfilter(16, 1.0, 8.0)[1], j_dsp.rectfilter(16, 1.0, 8.0)[1])
    seq = dsp.pnsequence(4, '1000', '1001', 15)
    same(seq, j_dsp.pnsequence(4, '1000', '1001', 15))
    assert set(np.unique(seq)) <= {0, 1} and seq.sum() in (7, 8)   # an m-sequence of order 4
    zc = dsp.zcsequence(1, 13)
    same(zc, j_dsp.zcsequence(1, 13))
    np.testing.assert_allclose(np.abs(zc), 1.0)
    w = np.exp(1j * np.linspace(0, 3, 10))
    same(dsp.add_frequency_offset(w, 10.0, alpha), j_dsp.add_frequency_offset(w, 10.0, alpha))


def test_utilities_port_equal_jax():
    rng = np.random.RandomState(4)
    a, b = rng.randint(0, 2, 50), rng.randint(0, 2, 50)
    assert utilities.hamming_dist(a, b) == j_utilities.hamming_dist(a, b) == int((a != b).sum())
    x, y = rng.randn(20), rng.randn(20)
    assert utilities.euclid_dist(x, y) == j_utilities.euclid_dist(x, y)
    same(utilities.upsample(x, 3), j_utilities.upsample(x, 3))
    same(utilities.dec2bitarray(37, 8), j_utilities.dec2bitarray(37, 8))
    assert utilities.bitarray2dec(utilities.dec2bitarray(37, 8)) == 37


# ---------------------------------------------------------------- native
@pytest.mark.parametrize('variant', ['hazzys', 'hazzys_g'])
def test_native_turbo_equals_jax_native_and_the_numpy_oracle(variant):
    B, L, sigma = 12, 40, 10 ** (0.5 / 20)
    trellis, inter = turbo757_trellis(), RandInterlv(L, 0)
    rng = np.random.RandomState(5)
    msgs = rng.randint(0, 2, (B, L))
    rx = 2.0 * turbo_encode_batch(msgs, trellis, inter.p_array) - 1.0 + sigma * rng.randn(B, L, 3)
    args = (rx[:, :, 0], rx[:, :, 1], rx[:, :, 2])
    got = native.native_turbo_decode_batch(*args, trellis, sigma ** 2, 6, inter.p_array,
                                           variant=variant, num_threads=3)
    jtrellis = j_turbo757()
    ref = j_native.native_turbo_decode_batch(*args, jtrellis, sigma ** 2, 6, inter.p_array,
                                             variant=variant, num_threads=3)
    assert got.dtype == np.int32 and got.shape == (B, L)
    np.testing.assert_array_equal(got, ref)
    host = hazzys_g_turbo_decode if variant == 'hazzys_g' else hazzys_turbo_decode
    oracle = np.stack([host(*(a[i] for a in args), trellis, sigma ** 2, 6, inter)
                       for i in range(B)])
    np.testing.assert_array_equal(got, oracle)
    assert 0 < (got != msgs).sum() < B * L // 4          # noisy enough to err, and it decodes


@pytest.mark.parametrize('metric', ['hard', 'unquantized', 'tdist3', 'tdist5'])
def test_native_viterbi_equals_jax_native_and_the_numpy_oracle(metric):
    trellis = Trellis(np.array([2]), np.array([[7, 5]]))
    jtrellis = JTrellis(np.array([2]), np.array([[7, 5]]))
    rng = np.random.RandomState(6)
    msgs = rng.randint(0, 2, (6, 30))
    coded = conv_encode_batch(msgs, trellis, 'default')
    T = coded.shape[1] // 2
    rx = (2.0 * coded - 1.0 + 0.9 * rng.randn(*coded.shape)).reshape(6, T, 2)
    if metric == 'hard':
        rx = (rx > 0).astype(float)
    for i in range(6):
        got = native.native_viterbi(rx[i], trellis, metric)
        np.testing.assert_array_equal(got, j_native.native_viterbi(rx[i], jtrellis, metric))
        np.testing.assert_array_equal(
            got, viterbi_decode(rx[i].reshape(-1), trellis, decoding_type=metric))


def test_native_build_raises_on_a_compiler_failure(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match='g\\+\\+ failed on .*no_such.cpp'):
        native.build(tmp_path / 'no_such.cpp')
    bad = tmp_path / 'bad.cpp'
    bad.write_text('extern "C" int f( {')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed on .*bad.cpp'):
        native.load_native(bad)
    monkeypatch.setenv('PATH', str(tmp_path))
    with pytest.raises(RuntimeError, match='g\\+\\+ not found'):
        native.build()
