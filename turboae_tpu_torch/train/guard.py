"""Divergence detection and learning-rate backoff for long training runs
(a copy of the JAX package's framework-free train/guard.py:24-99; the port
imports nothing of that package).

  - DivergenceGuard flags an epoch whose loss is NaN/inf or explodes against
    the recent median. The training CLI then reloads the last good
    checkpoint and retries with halved learning rates.
  - BestTracker keeps the best checkpoint by a validation metric, so the end
    of a run is the best epoch seen, not the last one.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional


class DivergenceGuard:
    """Flag loss explosions against a rolling median of recent healthy epochs.

    An epoch is divergent when any tracked loss is non-finite, exceeds
    hard_max, or (after `warmup` healthy epochs) exceeds
    max(ratio * median(recent), median(recent) + min_jump). The additive
    min_jump keeps near-zero late-training losses from tripping on benign
    noise. Divergent epochs are not folded into the history.
    """

    def __init__(self, window: int = 10, ratio: float = 3.0,
                 min_jump: float = 0.5, warmup: int = 3,
                 hard_max: Optional[float] = 5.0):
        self.window = window
        self.ratio = ratio
        self.min_jump = min_jump
        self.warmup = warmup
        # trips even inside the warmup window: BCE-family losses start at
        # ln 2 = 0.693, so 5.0 is far above any healthy epoch
        self.hard_max = hard_max
        self._hist: List[float] = []

    def _median(self) -> float:
        h = sorted(self._hist[-self.window:])
        n = len(h)
        return h[n // 2] if n % 2 else 0.5 * (h[n // 2 - 1] + h[n // 2])

    def check(self, losses) -> bool:
        """Feed one epoch's loss(es); returns True when the epoch diverged."""
        if isinstance(losses, dict):
            vals = [float(v) for v in losses.values()]
        elif isinstance(losses, (list, tuple)):
            vals = [float(v) for v in losses]
        else:
            vals = [float(losses)]
        if any(not math.isfinite(v) for v in vals):
            return True
        worst = max(vals)
        if self.hard_max is not None and worst > self.hard_max:
            return True
        if len(self._hist) >= self.warmup:
            med = self._median()
            if worst > max(self.ratio * med, med + self.min_jump):
                return True
        self._hist.append(worst)
        return False

    def reset(self):
        """Forget the history (after a backoff restarts from a checkpoint)."""
        self._hist.clear()


class BestTracker:
    """Keep the best (lowest) value of a validation metric seen so far."""

    def __init__(self):
        self.best: Optional[float] = None
        self.best_epoch: Optional[int] = None

    def update(self, value: float, epoch: int) -> bool:
        """True when `value` is a new best (the caller then snapshots)."""
        if not math.isfinite(value):
            return False
        if self.best is None or value < self.best:
            self.best = value
            self.best_epoch = epoch
            return True
        return False


def backoff_lrs(lrs: Dict[str, float], factor: float = 0.5) -> Dict[str, float]:
    """Halve every phase's learning rate after a divergence trip."""
    return {k: v * factor for k, v in lrs.items()}
