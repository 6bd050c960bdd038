"""Encode/decode round-trip demo for convolutional codes, with the PyTorch port.

Mirrors reference commpy/examples/conv_encode_decode.py, as
examples/conv_encode_decode.py does: rate-1/2 [5,7] code, random 1000-bit
messages, noiseless hard-decision Viterbi must be error-free over repeated
trials. Then the batched decoder (classical/convcode.make_viterbi) decodes
the same coded messages at once on the GPU and must give identical decisions.

Run: python examples/torch_conv_encode_decode.py [--device cuda]
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turboae_tpu_torch.classical.convcode import conv_encode, make_viterbi, viterbi_decode
from turboae_tpu_torch.classical.trellis import Trellis
from turboae_tpu_torch.classical.utilities import hamming_dist


def main(extra=()):
    """Returns the messages, the host decoder's and the batched decoder's
    decisions (each (10, 1000 + memory)) and each trial's bit errors."""
    import torch

    from turboae_tpu_torch.utils.device import resolve_device
    p = argparse.ArgumentParser()
    p.add_argument('--device', default='cuda')
    dev = resolve_device(p.parse_args(list(extra)).device)
    trellis = Trellis(np.array([2]), np.array([[5, 7]]))
    rng = np.random.RandomState(0)
    messages, coded, decoded, errors = [], [], [], []
    for trial in range(10):
        message_bits = rng.randint(0, 2, 1000)
        coded_bits = conv_encode(message_bits, trellis)
        decoded_bits = viterbi_decode(coded_bits.astype(float), trellis,
                                      decoding_type='hard')
        errs = hamming_dist(message_bits, decoded_bits[:len(message_bits)])
        status = 'No Bit Errors :)' if errs == 0 else f'{errs} bit errors!'
        print(f'trial {trial}: {status}')
        assert errs == 0, 'noiseless round trip must be exact'
        messages.append(message_bits)
        coded.append(coded_bits)
        decoded.append(decoded_bits)
        errors.append(errs)

    received = torch.as_tensor(np.stack(coded).reshape(len(coded), -1, trellis.n),
                               dtype=torch.float32, device=dev)
    batched = make_viterbi(trellis, 'hard')(received).cpu().numpy()
    decoded = np.stack(decoded)
    same = bool((batched == decoded).all())
    print(f'batched decoder on {dev}: {"identical" if same else "DIFFERENT"} decisions')
    assert same, 'the batched decoder must give the host decoder\'s decisions'
    return {'messages': np.stack(messages), 'decoded': decoded, 'batched': batched,
            'bit_errors': errors}


if __name__ == '__main__':
    main(sys.argv[1:])
