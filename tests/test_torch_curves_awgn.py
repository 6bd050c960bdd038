"""Committed curves re-measured by the port on the CPU, at one high-BLER
point each, through cli/eval_flagship.py: the BLER two-proportion z against
the committed exact counts must satisfy |z| < 4 (1,000 blocks: the standard
error is ~0.016 at BLER 0.45, ~0.01 at 0.10).

Here the binary (STE) code on AWGN and the t-dist robustness code; the other
curves are in tests/test_torch_curves_*.py, so that test workers share them.
"""
from _torch_parity import eval_point


def test_binary_curve_at_minus_1_db():
    out = eval_point('flagship_binary.msgpack', 'eval_binary.json', -1.0, 1000,
                     '--test_channel_mode', 'block_norm_ste')
    assert out['n_blocks'] == [1000] and 0.2 < out['bler'][0] < 0.7
    assert abs(out['z_bler_vs_ref'][0]) < 4, out


def test_atn_curve_at_minus_1_5_db():
    out = eval_point('flagship_atn.msgpack', 'eval_atn.json', -1.5, 1000,
                     '--channel', 't-dist', '--vv', '3')
    assert out['channel'] == 't-dist' and 0.03 < out['bler'][0] < 0.3
    assert abs(out['z_bler_vs_ref'][0]) < 4, out
