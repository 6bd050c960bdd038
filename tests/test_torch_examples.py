"""The port's examples (examples/torch_*.py) against the JAX package's
(examples/*.py) on the CPU: each port example hands its port CLI the argv
that its JAX counterpart hands the JAX CLI, word for word; under `-engine
native` (the C++ oracle, bit-exact across the two packages) the classical
examples give JAX's counts exactly; the noiseless round trip is exact and
its decisions, host and batched, are JAX's; DeepTurbo trains at a tiny
width; and without a GPU every example raises. `--device cpu` is appended
here, never written into an example."""
import math
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from turboae_tpu.classical.convcode import conv_encode as jax_conv_encode
from turboae_tpu.classical.convcode import viterbi_decode as jax_viterbi_decode
from turboae_tpu.classical.trellis import Trellis as JaxTrellis
from turboae_tpu.cli import conv_benchmark as jconv_cli
from turboae_tpu.cli import main as jmain_cli
from turboae_tpu.cli import turbo_benchmark as jturbo_cli
from turboae_tpu_torch.cli import conv_benchmark, turbo_benchmark
from turboae_tpu_torch.cli import main as main_cli
from turboae_tpu_torch.train.trainer import Trainer

from _torch_parity import ROOT

CPU = ['--device', 'cpu']
# example -> (the JAX CLI its JAX file calls, the port CLI its torch_ file calls)
CLI_EXAMPLES = {'turbo_example': (jturbo_cli, turbo_benchmark),
                'viterbi_bawgn': (jconv_cli, conv_benchmark),
                'fading_viterbi': (jconv_cli, conv_benchmark),
                'deepturbo': (jmain_cli, main_cli)}
ALL_EXAMPLES = list(CLI_EXAMPLES) + ['conv_encode_decode']
# trailing flags of the native-engine runs: a tiny depth at every block length
NATIVE = ['-num_block', '20', '-snr_points', '2', '-engine', 'native']


def path_of(name, port):
    return os.path.join(ROOT, 'examples', f'torch_{name}.py' if port else f'{name}.py')


def port_example(name, monkeypatch):
    """The port example's module globals, loaded without running its
    __main__ block."""
    monkeypatch.setattr(sys, 'path', list(sys.path))
    return runpy.run_path(path_of(name, port=True))


def run_as_main(path, argv, monkeypatch):
    """Runs a file as `python <path> <argv...>` would."""
    monkeypatch.setattr(sys, 'path', list(sys.path))
    monkeypatch.setattr(sys, 'argv', [path, *argv])
    runpy.run_path(path, run_name='__main__')


def record_argv(cli, monkeypatch):
    calls = []
    monkeypatch.setattr(cli, 'main', lambda argv=None: calls.append(list(argv)))
    return calls


def record_results(cli, monkeypatch):
    real, results = cli.main, []

    def recording(argv=None):
        results.append(real(argv))
        return results[-1]
    monkeypatch.setattr(cli, 'main', recording)
    return results


@pytest.mark.parametrize('name', list(CLI_EXAMPLES))
def test_example_hands_its_cli_the_jax_argv(name, monkeypatch):
    """Both files run as scripts with their CLI's main recorded: the port's
    argv is JAX's, with the trailing flags passed on in the same place
    (turbo_example: one argv a block length, three in all)."""
    jcli, tcli = CLI_EXAMPLES[name]
    jax_calls = record_argv(jcli, monkeypatch)
    run_as_main(path_of(name, port=False), [], monkeypatch)
    port_calls = record_argv(tcli, monkeypatch)
    run_as_main(path_of(name, port=True), CPU, monkeypatch)
    assert len(jax_calls) == (3 if name == 'turbo_example' else 1)
    assert port_calls == [argv + CPU for argv in jax_calls]


@pytest.mark.parametrize('name', ['turbo_example', 'viterbi_bawgn', 'fading_viterbi'])
def test_native_engine_counts_equal_jax(name, monkeypatch, capsys):
    """At a tiny depth under `-engine native` on both sides the port's example
    gives the JAX example's rates, which are exact counts over equal totals,
    at every point of every block length."""
    jcli, _ = CLI_EXAMPLES[name]
    extra = NATIVE + (['-num_threads', '2'] if name == 'turbo_example' else [])
    jax_results = record_results(jcli, monkeypatch)
    run_as_main(path_of(name, port=False), extra, monkeypatch)
    got = port_example(name, monkeypatch)['main'](extra + CPU)
    got = got if name == 'turbo_example' else [got]
    assert len(got) == len(jax_results) == (3 if name == 'turbo_example' else 1)
    for port, (_, jber, jbler) in zip(got, jax_results):
        assert (port['bers'], port['blers']) == (list(jber), list(jbler))
        assert port['n_blocks'] == [20, 20] and 0 < max(port['bers']) < 0.5   # it decodes
    capsys.readouterr()


def test_conv_round_trip_is_exact_and_equals_jax(monkeypatch, capsys):
    """Ten noiseless 1000-bit messages: no bit error, the batched decoder's
    decisions equal the host decoder's, and both equal JAX's host decoder on
    the same numpy messages."""
    out = port_example('conv_encode_decode', monkeypatch)['main'](CPU)
    assert out['bit_errors'] == [0] * 10
    assert out['messages'].shape == (10, 1000) and out['decoded'].shape == (10, 1002)
    trellis = JaxTrellis(np.array([2]), np.array([[5, 7]]))
    jax_decoded = np.stack([
        jax_viterbi_decode(jax_conv_encode(m, trellis).astype(float), trellis,
                           decoding_type='hard') for m in out['messages']])
    np.testing.assert_array_equal(out['decoded'], jax_decoded)
    np.testing.assert_array_equal(out['batched'], jax_decoded)
    np.testing.assert_array_equal(jax_decoded[:, :1000], out['messages'])
    assert 'identical decisions' in capsys.readouterr().out


def test_deepturbo_example_trains_at_a_tiny_width(monkeypatch, tmp_path):
    """The DeepTurbo example through cli/main.py at a tiny width: every
    phase-epoch's loss finite, a checkpoint written, the closing test run.
    Training parity with JAX is tests/test_torch_deepturbo_train.py's."""
    monkeypatch.chdir(tmp_path)
    real, losses = Trainer.train_epoch, []

    def recording(self, *a, **kw):
        losses.append(real(self, *a, **kw))
        return losses[-1]
    monkeypatch.setattr(Trainer, 'train_epoch', recording)
    trainer = port_example('deepturbo', monkeypatch)['main'](
        ['-num_block', '16', '-batch_size', '8', '-block_len', '24', '-dec_num_unit', '12',
         '-dec_num_layer', '2', '-num_iteration', '2', '-num_epoch', '1', *CPU])
    assert trainer.cfg.encoder == 'Turbo_rate3_757' and trainer.cfg.num_train_enc == 0
    assert len(losses) == 5 and all(math.isfinite(v) for v in losses)
    assert len(list((tmp_path / 'tmp').glob('model_*.msgpack'))) == 1
    assert len(trainer.last_test['ber']) == 4


@pytest.mark.parametrize('name', ALL_EXAMPLES)
def test_example_raises_without_gpu(name, monkeypatch, tmp_path):
    """The examples default to the GPU, as the port's CLIs do, and never fall
    back to the CPU."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        port_example(name, monkeypatch)['main']()
    assert not list(tmp_path.iterdir())          # nothing was started on the CPU
