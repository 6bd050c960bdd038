"""Viterbi over the binary-input AWGN channel, on the GPU.

Mirrors reference commpy/examples/BAWGN_viterbi.py, as
examples/viterbi_bawgn.py does, through the PyTorch port's
cli/conv_benchmark.py with the same flags: rate-1/2 [7,5] code,
soft-decision (unquantized) decoding, BER vs SNR.

Run: python examples/torch_viterbi_bawgn.py [-engine torch|native]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turboae_tpu_torch.cli import conv_benchmark


def main(extra=()):
    """Returns the CLI's result."""
    return conv_benchmark.main(['-enc1', '7', '-enc2', '5', '-M', '2', '-num_block', '2000',
                                '-snr_test_start', '0', '-snr_test_end', '6',
                                '-snr_points', '4'] + list(extra))


if __name__ == '__main__':
    main(sys.argv[1:])
