"""Host milliseconds inside the dense stacks a batch: the program's
outermost `dense` spans (ops/conv1d.py:dense_stack_apply) in the traced
slice, summed, over its `sweep` spans. None where the program records no
`dense` span."""
from benchmark.metrics._program import host_ms_per_batch, outermost, spans


def read(run):
    if not outermost(spans(run), 'dense'):
        return None
    return host_ms_per_batch(run, 'dense')
