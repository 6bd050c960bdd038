"""The device's idle time whose gap begins inside a program `wait` span, as
a percentage of the traced slice's window_s: the part of
device_idle_pct.eval that the host's waits for the device leave."""
from benchmark.metrics._program import idle_by_span


def read(run):
    idle = idle_by_span(run)
    if not idle or not run.trace['window_s']:
        return None
    return 100.0 * idle.get('wait', 0.0) / run.trace['window_s']
