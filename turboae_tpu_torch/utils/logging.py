"""Observability: a stdout tee, structured JSONL metrics, a profiler
trace and the host's spans (JAX: utils/logging.py:19-69).

The CLIs keep the reference's human-readable prints (main.py:17-27) and
MetricsLogger adds one JSON object per event, the JAX package's schema:
{'ts': unix seconds, 'event': name, **fields}. trace() is the counterpart of
jax.profiler: a torch.profiler capture of the CPU and, when a card is
present, its CUDA kernels, written as a Chrome trace.

Spans: `with span(name):` marks a phase of the host (the evaluation sweep's
names are listed in PERF.md §3). A span keeps its name, its start and end
from time.time_ns(), the index of its parent in `spans()` (-1 for a root)
and a batch id, the sequence number of its root span: on the evaluation
path the root is `sweep`, one a batch, so all spans of a batch share it.
time.time_ns() is the clock of torch.profiler's trace (kineto gives its
events in Unix nanoseconds), so a gap in the device's work can be named by
the innermost span open at its start.

Spans are recorded only while a torch.profiler session runs: the
outermost span reads the profiler's Python flag, the spans inside it only
whether one is open. Outside a session a span costs that read and a shared
no-op. They are kept in memory (`spans()`, `clear_spans()`) for one
thread, the one that runs the model.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


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


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int           # 0 while the span is open
    parent: int           # index in spans(), -1 for a root
    batch: int            # sequence number of its root span


# Five entries a span, (name, start_ns, end_ns, parent, batch), in opening
# order: a flat list of strs and ints, so that no container outlives its
# span. Each would count toward the garbage collector's next pass: with a
# list a span, those passes took 0.7-1.1 ms of a 2000-block batch of the
# crown's sweep on an H100 machine's host.
_flat: list = []
_open: List[int] = []     # indices of the open spans, innermost last
_roots = 0


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ('name', 'at')

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _roots
        if _open:
            parent = _open[-1]
            batch = _flat[5 * parent + 4]
        else:
            parent, batch = -1, _roots
            _roots += 1
        self.at = len(_flat)
        _open.append(self.at // 5)
        _flat.extend((self.name, 0, 0, parent, batch))
        _flat[self.at + 1] = time.time_ns()
        return None

    def __exit__(self, *exc):
        _flat[self.at + 2] = time.time_ns()
        _open.pop()
        return False


def span(name: str):
    """Context manager: the block as a span, recorded while a profiler
    session runs (see the module's docstring)."""
    if _open or _profiler._is_profiler_enabled:
        return _On(name)
    return _OFF


def spans() -> List[Span]:
    """The spans recorded since the last clear_spans(), in opening order."""
    return [Span(*_flat[i:i + 5]) for i in range(0, len(_flat), 5)]


def clear_spans():
    global _roots
    if _open:
        raise RuntimeError(f'{len(_open)} spans are open')
    _flat.clear()
    _roots = 0


@contextlib.contextmanager
def trace(log_dir: str = 'logs/torch-trace'):
    """torch.profiler capture of the block, written to
    <log_dir>/trace.json (open in chrome://tracing or Perfetto), and the
    spans it recorded to <log_dir>/spans.jsonl, one JSON object each."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    clear_spans()
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
    with open(os.path.join(log_dir, 'spans.jsonl'), 'w') as f:
        for s in spans():
            f.write(json.dumps(s._asdict()) + '\n')
