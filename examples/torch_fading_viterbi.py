"""Viterbi over an i.i.d. Rayleigh-fading binary-input AWGN channel, on the GPU.

Mirrors reference commpy/examples/fading_BAWGN_viterbi.py, as
examples/fading_viterbi.py does, through the PyTorch port's
cli/conv_benchmark.py with the same flags: rate-1/2 [5,7] code, K=1000,
soft (euclidean) decoding of the faded and noisy observations, BER vs SNR.

Run: python examples/torch_fading_viterbi.py [-engine torch|native]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turboae_tpu_torch.cli import conv_benchmark


def main(extra=()):
    """Returns the CLI's result."""
    return conv_benchmark.main(['-enc1', '5', '-enc2', '7', '-M', '2', '-channel', 'fading',
                                '-block_len', '1000', '-num_block', '100',
                                '-snr_test_start', '0', '-snr_test_end', '10',
                                '-snr_points', '6'] + list(extra))


if __name__ == '__main__':
    main(sys.argv[1:])
