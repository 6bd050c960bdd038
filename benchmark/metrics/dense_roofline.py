"""The decoder's dense stacks' share of their roofline: the least time a
batch's 2 * num_iteration dense stacks need (each the larger of its FLOPs
over the bf16 peak and its bytes over the bandwidth, _dense.py) over the
device's busy seconds a traced batch (the slice's busy_s over its program
`sweep` spans). The whole batch's busy time is the denominator, so no
kernel's name is matched and the share cannot pass 100 %. Read only for a
configuration whose plain reference is `deepturbo`; None without a trace,
a `sweep` span or the card in the peak table."""
from benchmark.harness import yardstick as Y
from benchmark.metrics._dense import dense_stack_work
from benchmark.metrics._program import batches, spans


def read(run):
    a = run.arch
    if run.trace is None or a.get('reference') != 'deepturbo':
        return None
    n = batches(spans(run))
    if not n or not run.trace['busy_s']:
        return None
    flops, nbytes = dense_stack_work(run.traffic['batch_size'], a['block_len'],
                                     2 + a['num_iter_ft'], a['dec_num_unit'],
                                     a['dec_kernel_size'], a['dec_num_layer'])
    bound = Y.bound_s(flops, nbytes, run.device_name)
    if bound is None:
        return None
    return 100.0 * 2 * a['num_iteration'] * bound / (run.trace['busy_s'] / n)
