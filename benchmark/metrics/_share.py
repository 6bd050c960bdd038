"""Arithmetic the per-layer readers share (a file of its own, so that a
reader added later can use it unchanged)."""
from benchmark.harness import yardstick as Y


def mfu_pct(run, flops: float):
    """flops done over the untraced stretch's seconds, as a percentage of
    the bf16 dense peak of every card the run uses; None off the table."""
    peak = Y.peak(run.device_name, 'bfloat16')
    if peak is None or not run.rest_seconds or not flops:
        return None
    return 100.0 * flops / run.rest_seconds / (peak * run.chips)


def idle_pct(run):
    t = run.trace
    if t is None or not t['window_s']:
        return None
    return 100.0 * (1.0 - t['busy_s'] / t['window_s'])
