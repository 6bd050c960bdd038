"""Host milliseconds inside K2's wrapper a batch: the program's outermost
`k2` spans (kernels/conv_stack.py:conv_stack_bf16) in the traced slice,
summed, over its `sweep` spans."""
from benchmark.metrics._program import host_ms_per_batch


def read(run):
    return host_ms_per_batch(run, 'k2')
