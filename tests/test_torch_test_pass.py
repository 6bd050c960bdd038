"""The port's Trainer.test and legacy noise against the JAX package's, on
the CPU (small flagship config, f32).

Trainer.test is fed the very batches JAX's test draws: its key chain is
replayed (JAX train/trainer.py:315-333, 352-366, 576-607) and the port's
`_test_batch` hands out the same bits and noise in the same order. Then the
main-pass BER/BLER, the positional-BER ranking that picks the punctured
positions, and the punctured BER/BLER are equal, as printed by both sides.
"""
import re

import jax
import numpy as np
import pytest
import torch

from turboae_tpu.channels.noise import sample_noise as j_sample, spec_from_cfg as j_spec
from turboae_tpu.train.trainer import Trainer as JaxTrainer
from turboae_tpu.train.trainer import _sample_bits
from turboae_tpu.utils.metrics import snr_db2sigma
from turboae_tpu_torch.train import sweep as tsweep
from turboae_tpu_torch.train.trainer import Trainer

from _torch_parity import SMALL, configs, small_params

CFG = dict(SMALL, batch_size=16, num_block=32, snr_points=2, snr_test_start=-1.0,
           snr_test_end=1.0, num_ber_puncture=3, print_pos_ber=True)


def _jax_batches(jt, jcfg, snrs, num_batches):
    """The (bits, noise) of every batch JAX's test() draws, from its key."""
    key = jt.key
    shape_b = (jcfg.batch_size, jcfg.block_len, jcfg.code_rate_k)
    shape_n = (jcfg.batch_size, jcfg.block_len, jcfg.code_rate_n)
    out = []
    for snr in snrs:
        for _ in range(2 * num_batches):          # main pass, then punctured pass
            key, k = jax.random.split(key)
            k_bits, k_noise, _ = jax.random.split(k, 3)
            out.append((np.asarray(_sample_bits(k_bits, shape_b)),
                        np.asarray(j_sample(k_noise, shape_n, j_spec(jcfg), snr_db2sigma(snr)))))
    return out


def _printed(text):
    """{(kind, snr): (ber, bler)} and the positional argmax lists of test()'s
    output."""
    res = {}
    for kind, snr, ber, bler in re.findall(
            r'^(Punctured Test|Test) SNR (\S+) with ber\s+(\S+) with bler (\S+)$', text, re.M):
        res[(kind, float(snr))] = (float(ber), float(bler))
    argmax = re.findall(r'^positional argmax (\[.*\])$', text, re.M)
    return res, argmax


def test_test_pass_equals_jax_on_identical_batches(capsys):
    jcfg, tcfg = configs(**CFG)
    jp, tp = small_params(jcfg, seed=3)
    jt = JaxTrainer(jcfg)
    jt.params = jax.tree.map(jax.numpy.asarray, jp)
    batches = iter(_jax_batches(jt, jcfg, [-1.0, 1.0], 2))
    with jax.default_matmul_precision('highest'):
        jt.test(verbose=True)
    ref, ref_arg = _printed(capsys.readouterr().out)

    tr = Trainer(tcfg, 'cpu', params=tp)
    tr._test_batch = lambda sigma, fixed_unit=None: tuple(torch.tensor(a) for a in next(batches))
    snrs, ber, bler = tr.test(verbose=True)
    got, got_arg = _printed(capsys.readouterr().out)
    assert next(batches, None) is None             # every batch used, in order
    assert snrs == [-1.0, 1.0] and len(ref) == 4
    assert got_arg == ref_arg                      # the same punctured positions
    assert got == ref
    assert [got[('Test', s)] for s in snrs] == list(zip(ber, bler))
    assert tr.last_test['bler_punc'] == [got[('Punctured Test', s)][1] for s in snrs]
    assert any(0 < b < 1 for b in ber) and abs(tr.last_test['encoder_power'] - 1.0) < 1e-2


def test_legacy_noise_draws_one_realization():
    """Under legacy_noise the main pass scales one unit realization by each
    point's sigma: two batches, and two points, see the same noise up to
    the scale; the punctured pass draws fresh noise, as in JAX."""
    _, tcfg = configs(**CFG, legacy_noise=True)
    tr = Trainer(tcfg, 'cpu', params=small_params(configs(**CFG)[0])[1])
    seen = []
    inner = tr._eval_batch

    def record(bits, noise, punc_mask=None, stats=None):
        seen.append((punc_mask is None, noise.clone()))
        return inner(bits, noise, punc_mask, stats)
    tr._eval_batch = record
    tr.test(verbose=False)
    main = [n for is_main, n in seen if is_main]
    punc = [n for is_main, n in seen if not is_main]
    assert len(main) == len(punc) == 4
    s0, s1 = snr_db2sigma(-1.0), snr_db2sigma(1.0)
    assert torch.equal(main[0], main[1]) and torch.equal(main[2], main[3])
    torch.testing.assert_close(main[2] / s1, main[0] / s0, rtol=1e-6, atol=1e-6)
    assert not torch.equal(punc[0], punc[1])


def test_sweep_legacy_noise_draws_once(monkeypatch):
    _, tcfg = configs(**CFG, legacy_noise=True)
    tp = small_params(configs(**CFG)[0])[1]
    seen, draws = [], []
    inner_counts, inner_sample = tsweep.sweep_counts, tsweep.sample_noise
    monkeypatch.setattr(tsweep, 'sweep_counts',
                        lambda p, cfg, bits, noise, *a: seen.append(noise) or inner_counts(
                            p, cfg, bits, noise, *a))
    monkeypatch.setattr(tsweep, 'sample_noise',
                        lambda *a: draws.append(a) or inner_sample(*a))
    res = tsweep.sweep(tp, tcfg, [-1.0, 1.0], num_block=48, device='cpu',
                       generator=torch.Generator().manual_seed(0))
    assert len(draws) == 1 and len(seen) == 6 and res['n_blocks'] == 48
    unit = seen[0] / snr_db2sigma(-1.0)
    for i, n in enumerate(seen):
        torch.testing.assert_close(n, unit * snr_db2sigma(-1.0 if i < 3 else 1.0))


@pytest.mark.parametrize('channel', ['radar', 'bec', 'bsc'])
def test_legacy_noise_refuses_non_multiplicative_channels(channel):
    _, tcfg = configs(**CFG, legacy_noise=True, channel=channel)
    tp = small_params(configs(**CFG)[0])[1]
    with pytest.raises(ValueError, match='legacy_noise'):
        Trainer(tcfg, 'cpu', params=tp).test(verbose=False)
    with pytest.raises(ValueError, match='legacy_noise'):
        tsweep.sweep(tp, tcfg, [0.1], num_block=16, device='cpu')


@pytest.mark.parametrize('channel', ['bec', 'bsc', 'ge'])
def test_mask_channels_test_at_the_raw_probability(channel):
    """For bec/bsc/ge a test point's 'SNR' is a probability used as it is
    (JAX trainer.py:453-455, 571-574): bec/bsc erase or flip with it, so the
    keep share is 1 - p; ge's bad state keeps with it, so the share is
    0.8 + 0.2 p."""
    _, tcfg = configs(**dict(CFG, snr_test_start=0.0, snr_test_end=0.5), channel=channel)
    tr = Trainer(tcfg, 'cpu', params=small_params(configs(**CFG)[0], seed=1)[1])
    noises = []
    inner = tr._eval_batch
    tr._eval_batch = lambda bits, noise, punc_mask=None, stats=None: noises.append(noise) or inner(
        bits, noise, punc_mask, stats)
    tr.test(verbose=False)
    for p, batch in ((0.0, noises[0:2]), (0.5, noises[4:6])):
        want = 0.8 + 0.2 * p if channel == 'ge' else 1.0 - p
        assert abs(torch.stack(batch).mean().item() - want) < 0.05
