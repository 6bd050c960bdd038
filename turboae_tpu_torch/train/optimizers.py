"""Optimizers (JAX: train/optimizers.py:20-56): Adam, SGD with momentum and
Lookahead over Adam, with optax's arithmetic.

Each optimizer owns a list of parameter tensors and updates them IN PLACE
(the JAX package returns new arrays; in place here saves a copy of the
params per step). `step(grads)` takes the gradients in the same order.

  - Adam (optax.adam defaults): b1 0.9, b2 0.999, eps 1e-8 added OUTSIDE the
    square root, bias-corrected moments:
        mu = b1 mu + (1 - b1) g,  nu = b2 nu + (1 - b2) g^2,
        p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps);
  - SGD (optax.sgd with momentum, not Nesterov): t = g + momentum t, p -= lr t;
  - Lookahead over Adam (k 5, alpha 0.5): the Adam step gives fast weights;
    when count % k == 0, step 0 included, slow += alpha (fast - slow) and
    fast <- slow; count goes up on every step. The slow weights are copies.

The updates use torch._foreach_* ops: one launch per op over all tensors.

Inside a captured CUDA graph (train/trainer.py, steps_per_call > 1) a step
cannot read the host: Adam's bias corrections depend on its count and
Lookahead's sync on count % k. There `staged(n)` gives, on the host, the
values of the next n steps (Adam: the f32 reciprocals of 1 - b1^t and
1 - b2^t, each correction in optax's f32 arithmetic; Lookahead: those of
its inner Adam, then alpha on a sync step and 0 elsewhere), one row a
step; the trainer copies them to the device and points `slot` at a step's
row before that step is captured, and the step reads its values from
there. With `slot` None (eager) they are host numbers, as before.
`advance(n)` adds the n steps a replay took to the host's counts. On the
card, torch._foreach_div by a host number multiplies by its f32 reciprocal
(on the CPU it divides), so a step that multiplies by the staged
reciprocals is the eager step bit for bit there.
An optimizer over no tensors (DeepTurbo's fixed encoder) counts its steps
and launches nothing: torch._foreach_* refuses empty lists.
`state()` gives an optimizer's state as plain data, with its per-leaf lists
in the params' order, and `load_state(state)` copies such state in;
train/checkpoint.py maps it to and from optax's layout.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in f32, as optax computes it: in f64 it would differ
    by ~1e-5 relative at b2 = 0.999, since f32(0.999) is not 0.999."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = list(params), lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.slot: Optional[torch.Tensor] = None

    def staged(self, n: int) -> np.ndarray:
        """(n, 2) f32: 1 / (1 - b1^t) and 1 / (1 - b2^t) of the next n steps."""
        bc = np.array([[_bias_correction(self.b1, t), _bias_correction(self.b2, t)]
                       for t in range(self.count + 1, self.count + n + 1)],
                      np.float32).reshape(n, 2)
        return np.float32(1.0) / bc

    def advance(self, n: int):
        self.count += n

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        self.count += 1
        if not self.params:
            return
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        if self.slot is None:
            denom = torch._foreach_div(self.nu, _bias_correction(self.b2, self.count))
            upd = torch._foreach_div(self.mu, _bias_correction(self.b1, self.count))
        else:
            denom = torch._foreach_mul(self.nu, self.slot[1])
            upd = torch._foreach_mul(self.mu, self.slot[0])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-self.lr)

    def state(self) -> dict:
        """{'count': steps taken, 'mu': [...], 'nu': [...]}, optax's
        ScaleByAdamState."""
        return {'count': self.count, 'mu': self.mu, 'nu': self.nu}

    @torch.no_grad()
    def load_state(self, state: dict):
        self.count = int(state['count'])
        _copy_into(self.mu, state['mu'])
        _copy_into(self.nu, state['nu'])


class SGD:
    def __init__(self, params: List[torch.Tensor], lr: float, momentum: float = 0.0):
        self.params, self.lr, self.momentum = list(params), lr, momentum
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.slot: Optional[torch.Tensor] = None

    def staged(self, n: int) -> np.ndarray:
        """(n, 0): a step of SGD reads nothing of its count."""
        return np.zeros((n, 0), np.float32)

    def advance(self, n: int):
        pass

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        if not self.params:
            return
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        torch._foreach_add_(self.params, self.trace, alpha=-self.lr)

    def state(self) -> dict:
        """{'trace': [...]}, optax's TraceState."""
        return {'trace': self.trace}

    @torch.no_grad()
    def load_state(self, state: dict):
        _copy_into(self.trace, state['trace'])


class Lookahead:
    """Lookahead over Adam (JAX lookahead(optax.adam(lr), k, alpha))."""

    def __init__(self, params: List[torch.Tensor], lr: float, k: int = 5,
                 alpha: float = 0.5):
        self.params, self.k, self.alpha = list(params), k, alpha
        self.inner = Adam(self.params, lr)
        self.slow = [p.detach().clone() for p in self.params]
        self.count = 0
        self.slot: Optional[torch.Tensor] = None

    def staged(self, n: int) -> np.ndarray:
        """(n, 3) f32: the inner Adam's two columns, then alpha where the
        step syncs (count % k == 0 before it) and 0 elsewhere."""
        sync = [self.alpha if (self.count + i) % self.k == 0 else 0.0 for i in range(n)]
        return np.concatenate([self.inner.staged(n), np.float32(sync)[:, None]], axis=1)

    def advance(self, n: int):
        self.count += n
        self.inner.advance(n)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        sync = self.count % self.k == 0
        self.count += 1
        self.inner.slot = None if self.slot is None else self.slot[:2]
        if not self.params:
            self.inner.step(grads)
            return
        before = [p.clone() for p in self.params]
        self.inner.step(grads)              # params are now the fast weights
        fast = self.params
        if self.slot is not None:
            # the sync as arithmetic: a = alpha on a sync step, else 0;
            # slow += a (fast - slow), and the update takes slow's side
            # exactly where a > 0 (a weight of 0 or 1 adds an exact zero)
            a = self.slot[2]
            torch._foreach_add_(self.slow, torch._foreach_mul(torch._foreach_sub(fast, self.slow), a))
            on = (a > 0).to(a.dtype)
            upd = torch._foreach_mul(torch._foreach_sub(self.slow, before), on)
            torch._foreach_add_(upd, torch._foreach_mul(torch._foreach_sub(fast, before), 1.0 - on))
        else:
            if sync:                        # slow += alpha (fast - slow); fast <- slow
                torch._foreach_add_(self.slow, torch._foreach_sub(fast, self.slow),
                                    alpha=self.alpha)
                fast = self.slow
            # JAX's trainer adds the update fast - p to p, which may round
            # to another value than fast: the same arithmetic here
            upd = torch._foreach_sub(fast, before)
        torch._foreach_copy_(self.params, before)
        torch._foreach_add_(self.params, upd)

    def state(self) -> dict:
        """{'inner': Adam's state, 'slow': [...], 'count': steps taken}, the
        JAX lookahead's state."""
        return {'inner': self.inner.state(), 'slow': self.slow, 'count': self.count}

    @torch.no_grad()
    def load_state(self, state: dict):
        self.inner.load_state(state['inner'])
        _copy_into(self.slow, state['slow'])
        self.count = int(state['count'])


def _copy_into(dst: List[torch.Tensor], src) -> None:
    """Copy src's tensors into dst's, which keep their device and dtype."""
    src = list(src)
    if len(src) != len(dst) or any(tuple(a.shape) != tuple(b.shape) for a, b in zip(dst, src)):
        raise ValueError('optimizer state does not match the params: '
                         f'{[tuple(t.shape) for t in src]} vs {[tuple(t.shape) for t in dst]}')
    for a, b in zip(dst, src):
        a.copy_(torch.as_tensor(b))


def make_optimizer(cfg, lr: float, params: List[torch.Tensor]):
    """SGD for 'sgd', Lookahead(Adam) for 'lookahead', Adam for any other
    name, as the JAX package chooses."""
    if cfg.optimizer == 'sgd':
        return SGD(params, lr, momentum=cfg.momentum)
    if cfg.optimizer == 'lookahead':
        return Lookahead(params, lr, k=5, alpha=0.5)
    return Adam(params, lr)
