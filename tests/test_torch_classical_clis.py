"""The port's three classical benchmark CLIs on the CPU (--device cpu),
against the JAX package's on tiny seeded runs: the port's `torch` engine
against JAX's `jax` engine and `numpy` against `numpy`, equal error counts
at every point. The `torch_mc` engine draws from a torch generator, so it
is held by its own run's bookkeeping (full batches, early stop)."""
import contextlib
import io
import os

import pytest
import torch

from turboae_tpu.cli import conv_benchmark as jconv_cli
from turboae_tpu.cli import ldpc_benchmark as jldpc_cli
from turboae_tpu.cli import turbo_benchmark as jturbo_cli
from turboae_tpu_torch.classical import ldpc
from turboae_tpu_torch.classical import turbo as tturbo
from turboae_tpu_torch.cli import conv_benchmark, ldpc_benchmark, turbo_benchmark

NEAR_ZERO = 1e-3

TURBO = ['-block_len', '20', '-num_block', '40', '-batch_size', '20', '-snr_test_start', '-1',
         '-snr_test_end', '1', '-snr_points', '3', '-seed', '3']
CONV = ['-block_len', '30', '-num_block', '50', '-snr_test_start', '0', '-snr_test_end', '4',
        '-snr_points', '3', '-seed', '1']
LDPC = ['-ebn0_start', '1.5', '-points', '1', '-batch', '8', '-max_frames', '16',
        '-target_frame_errors', '100', '-n_iters', '30', '-seed', '2']


def quiet(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        return fn(argv), out.getvalue()


def jax_counts(rates, n_per_point):
    """JAX's CLIs return rates of exact counts over known totals."""
    return [round(r * n) for r, n in zip(rates, n_per_point)]


# ---------------------------------------------------------------- turbo
@pytest.mark.parametrize('extra', [[], ['-noise_type', 't-dist', '-vv', '3'],
                                   ['-code', 'lte', '-variant', 'hazzys_g']],
                         ids=['awgn', 't-dist', 'lte-hazzys_g'])
def test_turbo_cli_torch_equals_jax(extra, monkeypatch):
    """Equal bit and block error counts at every point. A gap of at most one
    bit a point is allowed only where the port's decision statistic sat
    within NEAR_ZERO of 0 in that run (f32 summation order can flip such a
    bit); the run records the smallest |LLR| to say so."""
    real, smallest = tturbo.make_turbo_decoder, []

    def recording(*a, **kw):
        dec = real(*a, **kw)

        def decode(*args):
            llr = dec.llr(*args)
            smallest.append(float(llr.abs().min()))
            return (llr > 0).to(torch.int32)
        return decode
    monkeypatch.setattr(tturbo, 'make_turbo_decoder', recording)
    (_, jber, jbler), _ = quiet(jturbo_cli.main, TURBO + extra + ['-engine', 'jax'])
    got, text = quiet(turbo_benchmark.main, TURBO + extra + ['--device', 'cpu'])
    assert got['device'] == 'cpu' and '[device] cpu' in text and text.count('[testing]') == 3
    assert got['n_blocks'] == [40, 40, 40] and smallest
    ref_bits = jax_counts(jber, [40 * 20] * 3)
    ref_blocks = jax_counts(jbler, [40] * 3)
    if (got['bit_errors'], got['block_errors']) != (ref_bits, ref_blocks):
        assert min(smallest) < NEAR_ZERO
        assert all(abs(a - b) <= 1 for a, b in zip(got['bit_errors'], ref_bits))
        assert all(abs(a - b) <= 1 for a, b in zip(got['block_errors'], ref_blocks))
    assert 0 < max(got['bers']) < 0.1                    # it decodes


def test_turbo_cli_numpy_equals_jax():
    argv = TURBO + ['-num_block', '4', '-batch_size', '2', '-engine', 'numpy']
    (_, jber, jbler), _ = quiet(jturbo_cli.main, argv)
    got, _ = quiet(turbo_benchmark.main, argv + ['--device', 'cpu'])
    assert (got['bers'], got['blers']) == (jber, jbler)


def test_turbo_cli_torch_mc_full_batches_and_early_stop():
    """Full batches on the device; -target_bit_err ends a point after the
    batch that reaches it (-1 dB: the first batch of 64 already does)."""
    argv = ['-block_len', '20', '-num_block', '200', '-batch_size', '64', '-snr_test_start', '-1',
            '-snr_test_end', '6', '-snr_points', '2', '-engine', 'torch_mc', '--device', 'cpu']
    got, _ = quiet(turbo_benchmark.main, argv + ['-target_bit_err', '10'])
    assert got['n_blocks'][0] == 64 and got['bit_errors'][0] >= 10
    assert got['n_blocks'][1] == 256                       # 4 full batches pass the cap of 200
    again, _ = quiet(turbo_benchmark.main, argv + ['-target_bit_err', '10'])
    assert again['bit_errors'] == got['bit_errors']        # seeded from -seed


# ---------------------------------------------------------------- Viterbi
@pytest.mark.parametrize('extra', [
    [], ['-enc3', '6', '-fair', '1'], ['-code_type', 'rsc', '-feedback', '7', '-enc1', '1'],
    ['-channel', 'bsc', '-decoding_type', 'hard', '-snr_test_start', '0.05', '-snr_test_end', '0.15'],
    ['-channel', 't-dist', '-decoding_type', 'tdist3', '-vv', '3'],
    ['-channel', 'radar', '-decoding_type', 'tdist5']],
    ids=['awgn', 'rate3-fair', 'rsc', 'bsc-hard', 't-dist', 'radar-tdist5'])
def test_conv_cli_equals_jax(extra):
    (_, jber, jbler), _ = quiet(jconv_cli.main, CONV + extra + ['-engine', 'jax'])
    got, text = quiet(conv_benchmark.main, CONV + extra + ['--device', 'cpu'])
    assert (got['bers'], got['blers']) == (jber, jbler) and '[device] cpu' in text
    few = CONV + extra + ['-num_block', '8', '-engine', 'numpy']
    (_, jber, jbler), _ = quiet(jconv_cli.main, few)
    got, _ = quiet(conv_benchmark.main, few + ['--device', 'cpu'])
    assert (got['bers'], got['blers']) == (jber, jbler)


def test_conv_cli_tb_depth_takes_the_numpy_oracle():
    argv = CONV + ['-num_block', '8', '-tb_depth', '10']
    (_, jber, _), jtext = quiet(jconv_cli.main, argv + ['-engine', 'jax'])
    got, text = quiet(conv_benchmark.main, argv + ['--device', 'cpu'])
    line = '[conv_benchmark] -tb_depth 10: using numpy engine'
    assert line in jtext and line in text and got['bers'] == jber


# ---------------------------------------------------------------- LDPC
@pytest.mark.parametrize('alg', ['SPA', 'MSA'])
@pytest.mark.parametrize('engine', ['torch', 'numpy'])
def test_ldpc_cli_equals_jax(alg, engine):
    """16 frames at 1.5 dB, 30 iterations: equal counts. Over thousands of
    frames SPA's f32 tanh near its clip parts a few frames that never
    converge (tests/test_torch_classical_decoders.py); MSA stays equal."""
    design = os.path.join(ldpc.DESIGNS, '96.33.964.txt')
    argv = LDPC + ['-alg', alg, '-design', design]
    (_, jfer, jber), _ = quiet(jldpc_cli.main, argv + ['-engine', 'jax' if engine == 'torch' else engine])
    got, _ = quiet(ldpc_benchmark.main, argv + ['-engine', engine, '--device', 'cpu'])
    assert (got['fers'], got['bers']) == (jfer, jber)
    assert got['frames'] == [16] and 0 < got['frame_errors'][0] < 16


def test_ldpc_cli_default_design_and_generated_design():
    """By default the copied (96, 48) design; '-design ""' generates one from
    -seed, as JAX's default does."""
    got, _ = quiet(ldpc_benchmark.main, LDPC + ['--device', 'cpu'])
    (_, jfer, _), _ = quiet(jldpc_cli.main, LDPC + ['-engine', 'jax', '-design', os.path.join(
        ldpc.DESIGNS, '96.33.964.txt')])
    assert got['fers'] == jfer
    argv = LDPC + ['-n', '48', '-design', '']
    (_, jfer, jber), _ = quiet(jldpc_cli.main, argv + ['-engine', 'jax'])
    got, _ = quiet(ldpc_benchmark.main, argv + ['--device', 'cpu'])
    assert (got['fers'], got['bers']) == (jfer, jber)


# ---------------------------------------------------------------- engines
@pytest.mark.parametrize('cli', [turbo_benchmark.main, conv_benchmark.main, ldpc_benchmark.main],
                         ids=['turbo', 'conv', 'ldpc'])
def test_native_engine_is_refused_until_ported(cli, capsys):
    with pytest.raises(SystemExit):
        cli(['-engine', 'native', '--device', 'cpu'])
    assert "invalid choice: 'native'" in capsys.readouterr().err
