"""K2's share of its roofline: the least time one launch's work needs at
the cell's shape (B, L, 2 + num_iter_ft -> dec_num_unit, kernel
dec_kernel_size, dec_num_layer layers; no halo) over the mean device time
of the traced kernels named conv_stack_bf16_kernel."""
from benchmark.harness import yardstick as Y


def read(run):
    if run.trace is None:
        return None
    times = [e - s for n, s, e in run.trace['events'] if 'conv_stack_bf16_kernel' in n]
    if not times:
        return None
    a = run.arch
    flops, nbytes = Y.conv_stack_work(run.traffic['batch_size'], a['block_len'],
                                      2 + a['num_iter_ft'], a['dec_num_unit'],
                                      a['dec_kernel_size'], a['dec_num_layer'])
    bound = Y.bound_s(flops, nbytes, run.device_name)
    if bound is None:
        return None
    return 100.0 * bound / (sum(times) / len(times) / 1e9)
