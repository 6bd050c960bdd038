"""Megabytes that one dense stack's running concatenation writes: the
program's counters `dense_stack_apply.copy_bytes` over
`dense_stack_apply.calls` (ops/conv1d.py), over the whole run. None where
the program has no such counters or made no call."""


def read(run):
    from turboae_tpu_torch.ops import conv1d
    calls = getattr(conv1d.dense_stack_apply, 'calls', 0)
    copied = getattr(conv1d.dense_stack_apply, 'copy_bytes', None)
    if not calls or copied is None:
        return None
    return copied / calls / 1e6
