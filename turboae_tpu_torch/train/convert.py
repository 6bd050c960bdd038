"""Parameter conversion between the JAX package's layout and the port's.

JAX params (a nested dict of arrays, as `init_ae` makes them or as a msgpack
checkpoint holds them, where lists appear as dicts keyed '0', '1', ...):
  enc/b{1,2,3}/cnn/<j>/{w (K, Cin, Cout), b}, enc/b{1,2,3}/lin/{w (in, out), b}
  dec/scan/{dec1,dec2}_{cnn/<j>,lin}/...  stacked over the first n-1 iterations
  dec/final/...                           the last iteration
where a dense stack's layer j has Cin + j * Cout input channels, and a fixed
encoder (DeepTurbo's) has the empty half enc = {}.
Port params: the same tree with conv weights (Cout, Cin, K), linear weights
(out, in), lists as lists, and the decoder as dec/iters/[it_0 .. it_{n-1}].
`from_jax` and `to_jax` are exact inverses: a round trip is bit-identical.
`half_from_jax` and `half_to_jax` convert one half, as an optimizer state
of one phase (a tree of moments shaped like that half's params) needs.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_DEC_KEYS = ('dec1_cnn', 'dec2_cnn', 'dec1_lin', 'dec2_lin')


def _as_list(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [tree[str(i)] for i in range(len(tree))]
    return list(tree)


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _conv_from(layer, device, i=None):
    w, b = np.asarray(layer['w']), np.asarray(layer['b'])
    if i is not None:
        w, b = w[i], b[i]
    return {'w': _t(w, device).permute(2, 1, 0).contiguous(), 'b': _t(b, device)}


def _lin_from(lin, device, i=None):
    w, b = np.asarray(lin['w']), np.asarray(lin['b'])
    if i is not None:
        w, b = w[i], b[i]
    return {'w': _t(w, device).t().contiguous(), 'b': _t(b, device)}


def _iter_from(tree, device, i=None) -> Dict[str, Any]:
    return {
        'dec1_cnn': [_conv_from(l, device, i) for l in _as_list(tree['dec1_cnn'])],
        'dec2_cnn': [_conv_from(l, device, i) for l in _as_list(tree['dec2_cnn'])],
        'dec1_lin': _lin_from(tree['dec1_lin'], device, i),
        'dec2_lin': _lin_from(tree['dec2_lin'], device, i),
    }


def half_from_jax(half: str, tree, device='cpu'):
    """One half ('enc' or 'dec') of a JAX param tree in the port's layout."""
    if half == 'enc':
        return {name: {'cnn': [_conv_from(l, device) for l in _as_list(br['cnn'])],
                       'lin': _lin_from(br['lin'], device)}
                for name, br in tree.items()}
    scan = tree['scan']
    n_scan = 0
    if scan is not None and scan.get('dec1_lin') is not None:
        n_scan = np.asarray(scan['dec1_lin']['w']).shape[0]
    iters = [_iter_from(scan, device, i) for i in range(n_scan)]
    iters.append(_iter_from(tree['final'], device))
    return {'iters': iters}


def from_jax(params, device='cpu') -> Dict[str, Any]:
    """JAX param tree -> port param tree of f32 tensors on `device`."""
    return {h: half_from_jax(h, params[h], device) for h in ('enc', 'dec')}


def _conv_to(layer):
    return {'w': _n(layer['w'].permute(2, 1, 0)), 'b': _n(layer['b'])}


def _lin_to(lin):
    return {'w': _n(lin['w'].t()), 'b': _n(lin['b'])}


def _iter_to(it):
    return {'dec1_cnn': [_conv_to(l) for l in it['dec1_cnn']],
            'dec2_cnn': [_conv_to(l) for l in it['dec2_cnn']],
            'dec1_lin': _lin_to(it['dec1_lin']),
            'dec2_lin': _lin_to(it['dec2_lin'])}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack([t[j] for t in trees]) for j in range(len(trees[0]))]
    return np.stack(trees)


def half_to_jax(half: str, tree):
    """One half ('enc' or 'dec') of a port param tree in the JAX layout."""
    if half == 'enc':
        return {name: {'cnn': [_conv_to(l) for l in br['cnn']], 'lin': _lin_to(br['lin'])}
                for name, br in tree.items()}
    *scan_iters, final = [_iter_to(it) for it in tree['iters']]
    scan = _stack(scan_iters) if scan_iters else {k: None for k in _DEC_KEYS}
    return {'scan': scan, 'final': final}


def to_jax(params) -> Dict[str, Any]:
    """Port param tree -> JAX param tree of numpy arrays (lists as lists)."""
    return {h: half_to_jax(h, params[h]) for h in ('enc', 'dec')}
