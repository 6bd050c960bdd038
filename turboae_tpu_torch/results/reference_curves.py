"""Published reference BER/BLER curves, which the selection CLIs rank
checkpoints against (the port's copy of turboae_tpu/results/reference_curves.py).

Transcribed benchmark DATA (not code) from the reference repo's result tables
and committed logs; each table cites its source. The port keeps its own copy
because it imports nothing of the JAX package; tests/test_torch_train_clis.py
holds the two copies equal.
"""

# Classical Turbo-757, K=50, rate 1/3, 6 iterations (results/fbresults.py:20-23)
TURBO757_K50 = {
    'snr': [-2.0, -1.0, 0.0, 1.0, 2.0, 3.0, 4.0],
    'ber': [9.88e-2, 3.90e-2, 8.18e-3, 8.04e-4, 2.56e-5, 2.64e-6, 4.8e-7],
}

# Classical Turbo-757, K=1000, 6 iterations (results/fbresults.py:27-37,
# turbo757_bl1000_i6_ber — digit-exact; an earlier transcription of this
# table was wrong from -1.0 dB on and is fixed here)
TURBO757_K1000 = {
    'snr': [-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
    'ber': [2.843181e-2, 2.09208e-3, 1.0128e-4, 2.224e-5, 7.15e-6, 2.52e-6,
            1.03e-6, 3.6e-7, 1.8e-7, 4.3e-8, 1.4e-8, 0.0],
}

# TurboAE-CNN (enc2/dec5 maxBCE run), K=100, AWGN (tmp/114255_log.txt)
TURBOAE_CNN_K100 = {
    'snr': [-1.5, 0.0, 2.0, 4.0],
    'ber': [8.94e-2, 4.57e-3, 3.02e-5, 4.0e-7],
    'bler': [7.09e-1, 1.17e-1, 2.10e-3, 2e-5],
}

# Same run, FULL final 12-point arrays (tmp/114255_log.txt:3034-3035, plain
# — no punctured pass exists in that log; 50k blocks/point)
TURBOAE_CNN_K100_FULL = {
    'snr': [-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
    'ber': [8.940097e-2, 4.291539e-2, 1.565200e-2, 4.572600e-3, 1.144800e-3,
            3.452000e-4, 1.186000e-4, 3.020000e-5, 9.800000e-6, 3.400000e-6,
            8.000000e-7, 4.000000e-7],
    'bler': [7.0886e-1, 4.8004e-1, 2.6308e-1, 1.1666e-1, 4.610e-2, 1.736e-2,
             7.560e-3, 2.100e-3, 7.600e-4, 3.000e-4, 6.0e-5, 2.0e-5],
    'num_block': 50000,
}

# Fine-tuned TurboAE (tmp/724820_log.txt)
TURBOAE_CNN_K100_FINETUNED = {
    'snr': [0.0, 2.0],
    'ber': [4.38e-3, 2.08e-5],
}

# DeepCode feedback reference, K=50 (results/fbresults.py:41-44)
DEEPCODE_K50 = {
    'snr': [-2.0, -1.0, 0.0, 1.0, 2.0],
    'ber': [9.09e-3, 1.30e-4, 2.0e-6, 1.0e-7, 4.0e-8],
}

# Convolutional code BT5 S=2 rate 1/2 (results/fbresults.py:56-58)
CONV_BT5_RATE2 = {
    'snr': [0.0, 2.0, 4.0, 6.0],
    'ber': [1.06e-1, 1.40e-2, 4.10e-4, 3.4e-6],
}

# Uncoded rate-2 hard decision (results/fbresults.py:48-54)
UNCODED_RATE2 = {
    'snr': [0.0, 2.0, 4.0, 6.0],
    'ber': [7.75e-2, 3.77e-2, 1.08e-2, 2.5e-3],
}

# LDPC (96,48) Gallager SPA FER (commpy/channelcoding/tests/test_ldpc.py:37-62)
LDPC_96_48_FER = {
    'ebn0': [2.0, 2.5],
    'fer': [0.2, 0.1],
}
