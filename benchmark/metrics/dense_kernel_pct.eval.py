"""Share of the dense stacks that ran as one launch of the program's dense
kernel: its launch counter `dense_stack_bf16.launches`
(kernels/conv_stack.py) over `dense_stack_apply.calls` (ops/conv1d.py),
over the whole run, in %. None where the program has no such launch
counter or made no dense call."""


def read(run):
    from turboae_tpu_torch.kernels import conv_stack
    from turboae_tpu_torch.ops import conv1d
    launches = getattr(getattr(conv_stack, 'dense_stack_bf16', None), 'launches', None)
    calls = getattr(conv1d.dense_stack_apply, 'calls', 0)
    if launches is None or not calls:
        return None
    return 100.0 * launches / calls
