"""Parameter conversion between the JAX package's layout and the port's.

JAX params (a nested dict of arrays, as its inits make them or as a msgpack
checkpoint holds them, where lists appear as dicts keyed '0', '1', ...):
  - a conv layer {w (K, Cin, Cout), b}, a 2D conv layer {w (K, K, Cin, Cout),
    b} and a linear head {w (in, out), b}, told apart by the weight's rank
    (one more in a node stacked over iterations), not by the key: the 2D
    codes' 'lin' heads are 1x1 Conv2d layers;
  - one direction of an RNN layer {w_ih (In, G*H), w_hh (H, G*H), b_ih, b_hh};
  - an iterative decoder {'scan': <iteration tree stacked over the first
    n-1 iterations>, 'final': <the last iteration>}, the scan's entries None
    when n = 1;
  - every other node (branches, FTAE's phase encoders with their 'pw' (L, 1)
    and 'ps' () leaves, nbcjr's and FTAE's flat decoders) as it is.
The AE's tree is {'enc', 'dec'} (a fixed encoder's half is {}), the
modulation AE's {'enc', 'dec', 'mod', 'demod'}; FTAE's is
{'fwd_enc1', 'fwd_enc2', 'fwd_enc3', 'fb_enc1', 'fb_enc2', 'dec'}.
Port params: the same trees with conv weights (Cout, Cin, K) or
(Cout, Cin, K, K), linear and RNN
weights (out, in), lists as lists, and an iterative decoder as
{'iters': [it_0 .. it_{n-1}]}. A dict's keys come out in one fixed order
(_ORDER: the order the port's inits write), whatever order the file has.
`from_jax` and `to_jax` are exact inverses: a round trip is bit-identical.
They take any subtree, as an optimizer state of one phase (a tree of
moments shaped like that phase's params) needs.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

_RNN_DIR = ('w_ih', 'w_hh', 'b_ih', 'b_hh')
_ORDER = {k: i for i, k in enumerate((
    'enc', 'fwd_enc1', 'fwd_enc2', 'fwd_enc3', 'fb_enc1', 'fb_enc2', 'dec', 'mod', 'demod',
    'iters', 'dec1_cnn', 'dec2_cnn', 'dec1_rnn', 'dec2_rnn', 'dec1_lin', 'dec2_lin',
    'dec1_out', 'dec2_out', 'dec1', 'dec2', 'lin1', 'lin2', 'cnn', 'rnn', 'lin', 'out', 'pw',
    'ps', 'layer', 'final',
    'fwd', 'bwd', *_RNN_DIR, 'w', 'b'))}


def _sorted_keys(d) -> List[str]:
    return sorted(d, key=lambda k: (_ORDER.get(k, len(_ORDER)), k))


def _as_list(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [tree[str(i)] for i in range(len(tree))]
    return list(tree)


def _is_list(tree) -> bool:
    return isinstance(tree, (list, tuple)) or (
        isinstance(tree, dict) and len(tree) > 0 and set(tree) == {str(i) for i in range(len(tree))})


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _n(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


# a weight's axes from the JAX layout to the port's, by its rank:
# conv1d (K, Cin, Cout), conv2d (K, K, Cin, Cout), linear (in, out)
_FROM_AXES = {3: (2, 1, 0), 4: (3, 2, 0, 1), 2: (1, 0)}
_TO_AXES = {3: (2, 1, 0), 4: (2, 3, 1, 0), 2: (1, 0)}


def _layer_from(layer, device, i=None):
    """A conv layer or a linear head (iteration i of a stacked one)."""
    w, b = np.asarray(layer['w']), np.asarray(layer['b'])
    if i is not None:
        w, b = w[i], b[i]
    return {'w': _t(w, device).permute(_FROM_AXES[w.ndim]).contiguous(), 'b': _t(b, device)}


def _from(tree, device, i=None):
    """A JAX node (iteration i of a stacked one) in the port's layout."""
    if tree is None:
        return None
    if _is_list(tree):
        return [_from(v, device, i) for v in _as_list(tree)]
    if isinstance(tree, dict):
        if set(tree) == {'w', 'b'}:
            return _layer_from(tree, device, i)
        if set(tree) == set(_RNN_DIR):
            out = {}
            for k in _RNN_DIR:
                a = np.asarray(tree[k]) if i is None else np.asarray(tree[k])[i]
                out[k] = _t(a, device).t().contiguous() if k.startswith('w') else _t(a, device)
            return out
        if set(tree) == {'scan', 'final'} and isinstance(tree['final'], dict) \
                and 'w' not in tree['final']:
            scan = tree['scan']
            stacked = _leaves(scan)
            n_scan = np.asarray(stacked[0]).shape[0] if stacked else 0
            return {'iters': [_from(scan, device, j) for j in range(n_scan)]
                    + [_from(tree['final'], device)]}
        return {k: _from(tree[k], device, i) for k in _sorted_keys(tree)}
    a = np.asarray(tree)
    return _t(a if i is None else a[i], device)


def _leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    return [tree]


def from_jax(tree, device='cpu') -> Dict[str, Any]:
    """JAX param tree (or subtree) -> port tree of f32 tensors on `device`."""
    return _from(tree, device)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], list):
        return [_stack([t[j] for t in trees]) for j in range(len(trees[0]))]
    return np.stack(trees)


def _to(tree):
    if isinstance(tree, list):
        return [_to(v) for v in tree]
    if isinstance(tree, dict):
        if set(tree) == {'iters'}:
            *scan_iters, final = [_to(it) for it in tree['iters']]
            scan = _stack(scan_iters) if scan_iters else {k: None for k in final}
            return {'scan': scan, 'final': final}
        if set(tree) == {'w', 'b'}:
            w = tree['w']
            return {'w': _n(w.permute(_TO_AXES[w.dim()])), 'b': _n(tree['b'])}
        if set(tree) == set(_RNN_DIR):
            return {k: _n(tree[k].t() if k.startswith('w') else tree[k]) for k in _RNN_DIR}
        return {k: _to(v) for k, v in tree.items()}
    return _n(tree)


def to_jax(tree) -> Dict[str, Any]:
    """Port param tree (or subtree) -> JAX tree of numpy arrays (lists as lists)."""
    return _to(tree)
