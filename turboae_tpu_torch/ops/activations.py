"""Activation menu shared by encoders and decoders (JAX: ops/activations.py).
'linear' and unknown names pass through."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_ACTS = {
    'tanh': torch.tanh,
    'elu': F.elu,
    'relu': F.relu,
    'selu': F.selu,
    'sigmoid': torch.sigmoid,
    # jax.nn.leaky_relu's default slope is 0.01, as torch's
    'prelu': F.leaky_relu,
}


def activation(name: str):
    return _ACTS.get(name, lambda x: x)
