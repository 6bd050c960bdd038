"""DeepTurbo's committed curve re-measured by the port on the CPU at its
highest-BLER point, through cli/eval_flagship.py with --encoder
Turbo_rate3_757 (the turbo encoder on the device, the dense decoder in
bf16): the BLER two-proportion z against the exact counts of
artifacts/eval_deepturbo.json must satisfy |z| < 4 (1,000 blocks: the
standard error is ~0.015 at BLER 0.65). ~15 s on one thread."""
from _torch_parity import eval_point


def test_deepturbo_curve_at_minus_1_5_db():
    out = eval_point('deepturbo.msgpack', 'eval_deepturbo.json', -1.5, 1000,
                     '--encoder', 'Turbo_rate3_757')
    assert out['n_blocks'] == [1000] and out['dtype'] == 'bfloat16'
    assert 0.5 < out['bler'][0] < 0.8
    assert abs(out['z_bler_vs_ref'][0]) < 4, out
