"""Host milliseconds a batch spent waiting for the device: the program's
`wait` spans in the traced slice, summed, over its `sweep` spans."""
from benchmark.metrics._program import host_ms_per_batch


def read(run):
    return host_ms_per_batch(run, 'wait')
