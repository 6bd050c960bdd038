"""A flax checkpoint's params (the JAX layout) -> the reference's tree.

The JAX layout: a conv layer {'w': (K, Cin, Cout), 'b'}, a head
{'w': (in, out), 'b'}, lists as dicts keyed '0', '1', ..., and the decoder's
iterations as {'scan': <the first n - 1 iterations stacked on a leading
axis>, 'final': <the last>}."""
from __future__ import annotations

import numpy as np
import torch

from . import model
from .msgpack import load


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if a.ndim == 3:            # conv (K, Cin, Cout) -> (Cout, Cin, K)
        a = a.transpose(2, 1, 0)
    elif a.ndim == 2:          # head (in, out) -> (out, in)
        a = a.T
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _get(tree, key):
    if isinstance(tree, list):
        return tree[int(key)]
    return tree[key] if key in tree else tree[str(key)]


def from_checkpoint(path: str, arch: dict, device) -> dict:
    """The reference tree of the checkpoint's 'params', f32 on `device`."""
    params = load(path)['params']
    n_iter = arch['num_iteration']
    leaves = []
    for spec_path, _, _ in model.param_specs(arch):
        if spec_path[0] == 'enc':
            node = params['enc']
            for key in spec_path[1:]:
                node = _get(node, key)
            leaves.append(_leaf(node, device))
            continue
        it, rest = spec_path[2], spec_path[3:]
        node = _get(params['dec'], 'final' if it == n_iter - 1 else 'scan')
        for key in rest:
            node = _get(node, key)
        a = np.asarray(node)
        leaves.append(_leaf(a if it == n_iter - 1 else a[it], device))
    return model.build_tree(arch, leaves)
