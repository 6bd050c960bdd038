"""The GRU stacks' share of their roofline: the least time a batch's
3 encoder and 2 * num_iteration decoder biGRU stacks need (each the larger
of its FLOPs over the bf16 peak and its bytes over the bandwidth, _rnn.py)
over the device's busy seconds a traced batch (the slice's busy_s over its
program `sweep` spans). The whole batch's busy time is the denominator, so
no kernel's name is matched and the share cannot pass 100 %. Read only for
a configuration whose plain reference is `turboae_rnn`; None without a
trace, a `sweep` span or the card in the peak table."""
from benchmark.harness import yardstick as Y
from benchmark.metrics._program import batches, spans
from benchmark.metrics._rnn import birnn_work
from benchmark.reference.turboae_rnn import DEC_LAYERS


def read(run):
    a = run.arch
    if run.trace is None or a.get('reference') != 'turboae_rnn':
        return None
    n = batches(spans(run))
    if not n or not run.trace['busy_s']:
        return None
    B, L = run.traffic['batch_size'], a['block_len']
    enc = Y.bound_s(*birnn_work(B, L, a['code_rate_k'], a['enc_num_unit'], a['enc_num_layer']),
                    run.device_name)
    dec = Y.bound_s(*birnn_work(B, L, 2 + a['num_iter_ft'], a['dec_num_unit'], DEC_LAYERS),
                    run.device_name)
    if enc is None or dec is None:
        return None
    return 100.0 * (3 * enc + 2 * a['num_iteration'] * dec) / (run.trace['busy_s'] / n)
