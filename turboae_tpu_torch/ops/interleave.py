"""Interleaver permutations (JAX: ops/interleave.py:20-72).

Permutations are ALWAYS drawn on the host from numpy's MT19937 RandomState,
never from a torch RNG: the reference's interleaver is that generator's
permutation, and the JAX package uses the same one.

Under a mesh that shards time (dist/mesh.py) `interleave` and `deinterleave`
gather their input along time and keep this rank's positions of the result:
out[:, i] = x_global[:, p[i]] for i in [s, e). Their inputs are narrow (the
received systematic bits, the priors), so the gather is small beside the
conv stacks' activations, which stay sharded. (In JAX the permutation lowers
to an all-to-all.) The 2D codes run whole (dist/mesh.py:whole_time), so
`interleave_2d` never sees a sharded tensor.
"""
from __future__ import annotations

import numpy as np
import torch
from numpy.random import mtrand

from ..dist import mesh as dm


def rand_perm(block_len: int, seed: int) -> np.ndarray:
    """MT19937 permutation, identical to commpy RandInterlv(length, seed).p_array."""
    return mtrand.RandomState(seed).permutation(np.arange(block_len))


def invert_perm(p_array) -> np.ndarray:
    p = np.asarray(p_array)
    inv = np.zeros(len(p), dtype=np.int64)
    inv[p] = np.arange(len(p))
    return inv


def interleave(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Permute the time axis of a (B, L, C) tensor: out[:, i] = x[:, p[i]].

    `p` is an int64 index tensor on x's device, of the block's length.
    """
    s, e = dm.time_slice(x.shape[1])
    return torch.index_select(dm.gather_time(x), 1, p[s:e])


def deinterleave(x: torch.Tensor, p_inv: torch.Tensor) -> torch.Tensor:
    """Inverse of `interleave`; takes the INVERSE permutation (see invert_perm)."""
    return interleave(x, p_inv)


def interleave_2d(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Permute the pixels of a (B, C, H, W) image, flattened row-major:
    out[:, :, i] = x[:, :, p[i]] on the (B, C, H * W) view (JAX :56-64)."""
    b, c, h, w = x.shape
    return torch.index_select(x.reshape(b, c, h * w), 2, p).reshape(b, c, h, w)


def deinterleave_2d(x: torch.Tensor, p_inv: torch.Tensor) -> torch.Tensor:
    """Inverse of `interleave_2d`; takes the INVERSE permutation (JAX :67-72)."""
    return interleave_2d(x, p_inv)
