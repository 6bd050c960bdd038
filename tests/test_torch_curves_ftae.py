"""FTAE's committed curve re-measured by the port on the CPU through
cli/eval_ftae.py: artifacts/ftae.msgpack (uniform power, feedback at
40 dB, bf16, block_len 50) at -1 and 0 dB, 2,000 blocks a point, the BLER
two-proportion z against the exact counts of artifacts/eval_ftae.json
(200,000 blocks a point) must satisfy |z| < 4 (standard errors ~0.010 and
~0.0044 at BLER 0.30 and 0.04); and in float32 at -1 dB, with the guard
refusing a mode the file does not match. ~5 s a point on one thread."""
import os

import pytest

from turboae_tpu_torch.cli import eval_ftae

from _torch_parity import ROOT


@pytest.mark.parametrize('snr,lo,hi', [(-1.0, 0.2, 0.45), (0.0, 0.01, 0.1)])
def test_ftae_curve_point(snr, lo, hi):
    args = eval_ftae.parse(['--ckpt', os.path.join(ROOT, 'artifacts', 'ftae.msgpack'),
                            '--device', 'cpu', '--num_block', '2000', '--batch_size', '500',
                            '--snrs', str(snr),
                            '--ref', os.path.join(ROOT, 'artifacts', 'eval_ftae.json')])
    out = eval_ftae.evaluate(args)
    assert out['n_blocks'] == 2000 and out['dtype'] == 'bfloat16'
    assert out['fb_channel_low'] == 40.0
    assert lo < out['bler'][0] < hi, out
    assert abs(out['z_bler_vs_ref'][0]) < 4, out


def test_ftae_curve_point_f32_and_guard():
    """The same file in float32 at -1 dB, as chip_smoke.py's
    ftae_uniform_curve holds it on the card (the bf16 curve there is printed,
    not held); the guard refuses --ftae_power_alloc pos, since the file has
    no 'pw' leaf."""
    ckpt = os.path.join(ROOT, 'artifacts', 'ftae.msgpack')
    ref = os.path.join(ROOT, 'artifacts', 'eval_ftae.json')
    base = ['--ckpt', ckpt, '--device', 'cpu', '--num_block', '2000', '--batch_size', '500',
            '--snrs', '-1', '--ref', ref]
    with pytest.raises(SystemExit, match="has NO 'pw'"):
        eval_ftae.evaluate(eval_ftae.parse(base + ['--ftae_power_alloc', 'pos']))
    out = eval_ftae.evaluate(eval_ftae.parse(base + ['--dtype', 'float32']))
    assert out['n_blocks'] == 2000 and out['dtype'] == 'float32'
    assert 0.2 < out['bler'][0] < 0.45, out
    assert abs(out['z_bler_vs_ref'][0]) < 4, out
