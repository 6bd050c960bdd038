"""Checkpoints: params, optimizer state and step, with resume
(JAX: train/checkpoint.py:19-83).

Files are flax msgpack in the JAX package's tree layout, written and read by
the port's own msgpack_io, so the two packages read each other's files:
  {'params': JAX param tree, 'step': int,
   'opt_state': {group: {'0': inner state, '1': {}}}}
with one group an optimizer (`groups`: the AE's 'enc' and 'dec'), where
the inner state is optax's: Adam {'count': int32 0-d, 'mu', 'nu'} (trees
shaped like that group's params), SGD with momentum {'trace'}; '1' is
the empty state of optax's learning-rate scaling. Lookahead over Adam
(JAX train/optimizers.py:20-48) stores, in place of that pair,
  {'inner': {'0': Adam's state, '1': {}}, 'slow': a tree shaped like the
   half's params, 'count': int32 0-d}.
A fixed encoder (DeepTurbo's) has the empty half params/enc = {} and the
state {'0': {'count', 'mu': {}, 'nu': {}}, '1': {}}.

FTAE's params have no halves: its optimizer state's 'enc' steps the forward
encoders {'fwd_enc1', 'fwd_enc2', 'fwd_enc3'} and its 'dec' the feedback
encoders and the decoder {'fb_enc1', 'fb_enc2', 'dec'} (JAX
train/ftae_trainer.py:26-27), each moment a tree of those keys. The
modulation AE {'enc', 'dec', 'mod', 'demod'} has one optimizer a phase,
the groups 'encoder', 'decoder', 'mod' and 'demod' (JAX
train/mod_trainer.py:23-43), whose moment trees are keyed {'enc'},
{'dec'}, {'mod'} and {'demod'}. The JAX training scripts store the epoch in
'step' (scripts/train_flagship.py:245); the port's CLIs do too.

Port side, params are the port's param tree and an optimizer state is
{group: optimizer.state()}, lists in tree_leaves order of that group's
params. A moment tree read from a file is put in the
params' key order before its leaves are listed.

`load_checkpoint` merges only the leaves whose paths and shapes match the
template (the reference's strict=False load, main.py:168-174) and counts
them in stats['merged'] and stats['kept'].
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..utils.tree import tree_leaves, tree_unflatten
from .convert import from_jax, to_jax
from .msgpack_io import load_msgpack, save_msgpack

_MOMENTS = ('mu', 'nu', 'trace')
FTAE_GROUPS = {'enc': ('fwd_enc1', 'fwd_enc2', 'fwd_enc3'),
               'dec': ('fb_enc1', 'fb_enc2', 'dec')}
MOD_GROUPS = {'encoder': ('enc',), 'decoder': ('dec',), 'mod': ('mod',), 'demod': ('demod',)}


def groups(params) -> dict:
    """{group: the params one optimizer steps}: the AE's halves 'enc' and
    'dec', FTAE's forward encoders and the rest, or the modulation AE's four
    phases."""
    for marker, table in (('fwd_enc1', FTAE_GROUPS), ('mod', MOD_GROUPS)):
        if marker in params:
            return {h: {k: params[k] for k in keys} for h, keys in table.items()}
    return {h: params[h] for h in ('enc', 'dec')}


def _opt_to_jax(half: str, params_half, state: dict) -> dict:
    if 'inner' in state:                    # Lookahead
        return {'inner': _opt_to_jax(half, params_half, state['inner']),
                'slow': to_jax(tree_unflatten(params_half, state['slow'])),
                'count': np.asarray(state['count'], np.int32)}
    inner = {}
    for k, v in state.items():
        if k == 'count':
            inner[k] = np.asarray(v, np.int32)
        elif k in _MOMENTS:
            inner[k] = to_jax(tree_unflatten(params_half, v))
        else:
            raise ValueError(f'unknown optimizer state entry {k!r}')
    return {'0': inner, '1': {}}


def save_checkpoint(path: str, params: Any, opt_state: Optional[dict] = None,
                    step: int = 0) -> None:
    """Write params (port tree), the optimizer state of each half and step."""
    payload = {'params': to_jax(params), 'step': int(step)}
    if opt_state is not None:
        g = groups(params)
        payload['opt_state'] = {h: _opt_to_jax(h, g[h], s) for h, s in opt_state.items()}
    save_msgpack(path, payload)


def _leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_leaf_count(v) for v in tree)
    return 0 if tree is None else 1


def _merge(tpl, got, stats: dict):
    """JAX load_checkpoint's merge (checkpoint.py:53-76) on numpy trees."""
    def keep(t):
        stats['kept'] += _leaf_count(t)
        return t

    if isinstance(tpl, dict) and isinstance(got, dict):
        return {k: _merge(tpl[k], got[k], stats) if k in got else keep(tpl[k]) for k in tpl}
    if isinstance(tpl, (list, tuple)) and isinstance(got, (list, dict)):
        if isinstance(got, dict):          # msgpack keys lists by index
            got = [got.get(str(i)) for i in range(len(tpl))]
        got = list(got) + [None] * (len(tpl) - len(got))
        return [keep(t) if g is None else _merge(t, g, stats) for t, g in zip(tpl, got)]
    if isinstance(got, np.ndarray) and tpl is not None and np.shape(tpl) == got.shape:
        stats['merged'] += 1
        return got
    return keep(tpl)


def _like(tpl, tree):
    """`tree` with its dicts' keys in `tpl`'s order (a missing key raises)."""
    if isinstance(tpl, dict):
        return {k: _like(v, tree[k]) for k, v in tpl.items()}
    if isinstance(tpl, (list, tuple)):
        return [_like(a, b) for a, b in zip(tpl, tree)]
    return tree


def _moments_from_jax(half: str, what: str, tree, params_half, device) -> list:
    """A tree shaped like the half's params, as a list in tree_leaves order."""
    try:
        out = tree_leaves(_like(params_half, from_jax(tree, device)))
    except (KeyError, TypeError) as e:
        raise ValueError(f'{half} {what}: the tree does not match the params ({e!r})')
    if [tuple(t.shape) for t in out] != [tuple(t.shape) for t in tree_leaves(params_half)]:
        raise ValueError(f'{half} {what}: the shapes do not match the params')
    return out


def _opt_from_jax(half: str, saved: dict, params_half, template: dict, device) -> dict:
    if ('inner' in template) != ('inner' in saved):
        raise ValueError(f'{half}: the file holds optimizer state {sorted(saved)}, '
                         f'the optimizer has {sorted(template)}')
    if 'inner' in template:                 # Lookahead
        return {'inner': _opt_from_jax(half, saved['inner'], params_half, template['inner'],
                                       device),
                'slow': _moments_from_jax(half, 'slow', saved['slow'], params_half, device),
                'count': int(np.asarray(saved['count']))}
    inner = saved['0']
    if set(inner) != set(template):
        raise ValueError(f'{half}: the file holds optimizer state {sorted(inner)}, '
                         f'the optimizer has {sorted(template)}')
    out = {}
    for k in template:
        if k == 'count':
            out[k] = int(np.asarray(inner[k]))
        else:
            out[k] = _moments_from_jax(half, k, inner[k], params_half, device)
    return out


def load_checkpoint(path: str, params_template: Any, opt_state_template: Optional[dict] = None,
                    stats: Optional[dict] = None, device=None):
    """Params merged into the template (a port tree, not changed), on
    `device` (default: the template's). With an optimizer-state template and
    a file that holds optimizer state: (params, opt_state, step), the state
    shaped like the template's and checked against the loaded params."""
    payload = load_msgpack(path)
    loaded = payload.get('params', payload)
    if stats is None:
        stats = {}
    stats.setdefault('merged', 0)
    stats.setdefault('kept', 0)
    if device is None:
        device = tree_leaves(params_template)[0].device
    params = from_jax(_merge(to_jax(params_template), loaded, stats), device)
    if opt_state_template is not None and 'opt_state' in payload:
        g = groups(params)
        opt = {h: _opt_from_jax(h, payload['opt_state'][h], g[h], t, device)
               for h, t in opt_state_template.items()}
        return params, opt, payload.get('step', 0)
    return params
