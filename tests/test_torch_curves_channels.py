"""Committed curves of the radar and fading codes re-measured by the port
on the CPU at -1 dB, 1,000 blocks each, through cli/eval_flagship.py:
|z| < 4 for the BLER against the committed exact counts (see
tests/test_torch_curves_awgn.py)."""
from _torch_parity import eval_point


def test_radar_curve_at_minus_1_db():
    out = eval_point('flagship_radar.msgpack', 'eval_radar.json', -1.0, 1000,
                     '--channel', 'radar')
    assert out['channel'] == 'radar' and 0.5 < out['bler'][0] < 0.9
    assert abs(out['z_bler_vs_ref'][0]) < 4, out


def test_fading_curve_at_minus_1_db():
    out = eval_point('flagship_fading.msgpack', 'eval_fading.json', -1.0, 1000,
                     '--channel', 'fading')
    assert out['channel'] == 'fading' and 0.5 < out['bler'][0] < 0.9
    assert abs(out['z_bler_vs_ref'][0]) < 4, out
