"""End-to-end classical Turbo-757 example at several block lengths, on the GPU.

Mirrors reference commpy/examples/turboex.py, as examples/turbo_example.py
does, through the PyTorch port's cli/turbo_benchmark.py with the same flags.
The port decodes on the GPU by default (-engine torch); -engine torch_mc also
draws the bits and the noise there, -engine native runs the C++ oracle on
the host.

Run: python examples/torch_turbo_example.py [-engine torch|torch_mc|native]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turboae_tpu_torch.cli import turbo_benchmark


def main(extra=()):
    """The curve at K = 50, 100 and 1000; returns the CLI's result of each."""
    results = []
    for k in (50, 100, 1000):
        print(f'===== block_len {k} =====')
        results.append(turbo_benchmark.main(['-block_len', str(k), '-num_block', '500',
                                             '-snr_test_start', '-1', '-snr_test_end', '2',
                                             '-snr_points', '4'] + list(extra)))
    return results


if __name__ == '__main__':
    main(sys.argv[1:])
