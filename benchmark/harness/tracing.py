"""The harness's own spans around its calls into the program, and the
device trace of a traced run.

Spans: `Spans.span(name)` times the block on the host clock. Outside a
traced slice it adds the block's seconds to the name's total and count;
inside one it also keeps (name, start, end) on the profiler's clock, so
that the device's idle gaps can be named by what the host was doing.

The traced slice: torch.profiler with CUDA activity only (CPU-op recording
slows the eager host path twofold and would distort the idle share), kept
in memory and summarised (`Slice.summary`): the device events (kernels,
copies, sets) from the profiler's kineto results, clipped to the slice's
host window. The profiler's clock is the host's wall clock in nanoseconds;
its offset from time.time_ns() is read off the cudaDeviceSynchronize that
opens the slice.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

from . import yardstick as Y
from .host import sync


class Spans:
    def __init__(self):
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.timeline: Optional[List[Tuple[str, int, int]]] = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        w0 = time.time_ns() if self.timeline is not None else 0
        try:
            yield
        finally:
            if self.timeline is not None:
                self.timeline.append((name, w0, time.time_ns()))
            else:
                self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0
                self.count[name] = self.count.get(name, 0) + 1

    def mean_ms(self, name: str) -> Optional[float]:
        n = self.count.get(name, 0)
        return 1e3 * self.total[name] / n if n else None


class Slice:
    """A traced stretch of the window: start() ... stop(), then summary()."""

    def __init__(self, spans: Spans, device):
        self.spans, self.device = spans, device
        self.prof = None
        self.active = False

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.active = True
        self.spans.timeline = []
        self.sync_host = time.time_ns()
        sync(self.device)
        self.t0 = time.time_ns()

    def stop(self):
        import torch
        sync(self.device)
        self.t1 = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.active = False
        self.timeline, self.spans.timeline = self.spans.timeline, None

    def summary(self) -> dict:
        """{'window_s', 'busy_s', 'events': [(name, start, end)] on the
        device, clipped, 'idle_by_span': {host span: idle seconds},
        'device_ops': {name: seconds}}."""
        events, offset = [], None
        for e in self.prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            s = e.start_ns()
            if kind.endswith('CUDA'):
                events.append((e.name(), s, s + e.duration_ns()))
            elif offset is None and e.name() == 'cudaDeviceSynchronize':
                offset = s - self.sync_host
        offset = offset or 0
        lo, hi = self.t0 + offset, self.t1 + offset
        events = [(n, max(s, lo), min(e, hi)) for n, s, e in events if e > lo and s < hi]
        busy = Y.union(((s, e) for _, s, e in events), lo, hi)
        timeline = [(n, s + offset, e + offset) for n, s, e in self.timeline]
        idle: Dict[str, float] = {}
        for s, e in Y.gaps(busy, lo, hi):
            name = Y.span_at(timeline, s)
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
        ops: Dict[str, float] = {}
        for n, s, e in events:
            ops[n] = ops.get(n, 0.0) + (e - s) / 1e9
        self.prof = None
        return {'window_s': (hi - lo) / 1e9, 'busy_s': Y.covered(busy) / 1e9,
                'events': events, 'idle_by_span': idle, 'device_ops': ops}
