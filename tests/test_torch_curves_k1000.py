"""The K=1000 code's committed curve re-measured by the port on the CPU at
0 dB, 200 blocks, through cli/eval_flagship.py --block_len 1000: |z| < 4 for
the BLER against the committed exact counts (the standard error is ~0.03 at
BLER 0.27; see tests/test_torch_curves_awgn.py)."""
from _torch_parity import eval_point


def test_k1000_curve_at_0_db():
    out = eval_point('flagship_k1000.msgpack', 'eval_k1000.json', 0.0, 200,
                     '--block_len', '1000')
    assert out['n_bits'] == [200 * 1000] and 0.1 < out['bler'][0] < 0.5
    assert abs(out['z_bler_vs_ref'][0]) < 4, out
