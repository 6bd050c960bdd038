"""Observability: a stdout tee, structured JSONL metrics and a profiler
trace (JAX: utils/logging.py:19-69).

The CLIs keep the reference's human-readable prints (main.py:17-27) and
MetricsLogger adds one JSON object per event, the JAX package's schema:
{'ts': unix seconds, 'event': name, **fields}. trace() is the counterpart of
jax.profiler: a torch.profiler capture of the CPU and, when a card is
present, its CUDA kernels, written as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Optional

import torch


class Tee:
    """stdout tee (reference main.py:17-27)."""

    def __init__(self, path: str):
        self.terminal = sys.stdout
        self.log = open(path, 'w')

    def write(self, msg):
        self.terminal.write(msg)
        self.log.write(msg)

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def isatty(self):
        return self.terminal.isatty()

    def fileno(self):
        return self.terminal.fileno()


class MetricsLogger:
    """Append-only JSONL metrics; a logger without a path writes nothing."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = open(path, 'a') if path else None

    def log(self, event: str, **fields):
        if self._f is None:
            return
        rec = {'ts': time.time(), 'event': event, **fields}
        self._f.write(json.dumps(rec) + '\n')
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


@contextlib.contextmanager
def trace(log_dir: str = 'logs/torch-trace'):
    """torch.profiler capture of the block, written to
    <log_dir>/trace.json (open in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
