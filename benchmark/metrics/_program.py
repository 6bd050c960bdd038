"""The program's own spans in a traced run, for the readers that use them.

The program records its spans (turboae_tpu_torch/utils/logging.py: `span`,
`spans`) only while a profiler session runs: in a benchmark run, the traced
slice alone. A span is (name, start_ns, end_ns, parent index, batch id), on
time.time_ns(), the clock of the device trace (kineto gives its events in
Unix nanoseconds). Each batch is one `sweep` span, the program's
`train/sweep.py:sweep_counts`, and the root of its batch's spans. A
program without the recorder, or a run without a trace, gives no spans,
and every reader then None.
"""
import bisect
from typing import Dict, List, Optional

from benchmark.harness import yardstick as Y


def spans(run) -> List[tuple]:
    """The program's spans in the traced slice, [] where there are none."""
    from turboae_tpu_torch.utils import logging as program_log
    read = getattr(program_log, 'spans', None)
    if run.trace is None or read is None:
        return []
    return [tuple(s) for s in read()]


def batches(sp: List[tuple]) -> int:
    """The traced batches: the number of `sweep` spans."""
    return sum(1 for s in sp if s[0] == 'sweep')


def outermost(sp: List[tuple], name: str) -> List[tuple]:
    """The spans called `name` with no ancestor of that name."""
    out = []
    for s in sp:
        p = s[3]
        while p >= 0 and sp[p][0] != name:
            p = sp[p][3]
        if s[0] == name and p < 0:
            out.append(s)
    return out


def host_ms_per_batch(run, name: str) -> Optional[float]:
    """Host milliseconds inside the outermost `name` spans, over the traced
    batches; None without a `sweep` span."""
    sp = spans(run)
    n = batches(sp)
    if not n:
        return None
    return sum(e - s for _, s, e, _, _ in outermost(sp, name)) / 1e6 / n


def idle_by_span(run) -> Dict[str, float]:
    """Seconds of the device's idle gaps between the slice's first and last
    device event, each named by the innermost program span open at the
    gap's start (yardstick.span_at over that batch's spans; 'harness'
    outside every batch); {} without a `sweep` span."""
    sp = spans(run)
    events = run.trace['events'] if batches(sp) else []
    if not events:
        return {}
    lo, hi = min(s for _, s, _ in events), max(e for _, _, e in events)
    busy = Y.union(((s, e) for _, s, e in events), lo, hi)
    by_batch: Dict[int, List[tuple]] = {}
    for name, s, e, _, b in sp:
        by_batch.setdefault(b, []).append((name, s, e))
    roots = sorted((s, e, b) for _, s, e, p, b in sp if p < 0)
    starts = [r[0] for r in roots]
    idle: Dict[str, float] = {}
    for s, e in Y.gaps(busy, lo, hi):
        i = bisect.bisect_right(starts, s) - 1
        inside = i >= 0 and s < roots[i][1]
        name = Y.span_at(by_batch[roots[i][2]], s) if inside else 'harness'
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
    return idle
