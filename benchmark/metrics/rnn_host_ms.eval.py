"""Host milliseconds inside the GRU stacks a batch: the program's outermost
`rnn` spans (ops/gru.py:birnn_apply) in the traced slice, summed, over its
`sweep` spans. None where the program records no `rnn` span."""
from benchmark.metrics._program import host_ms_per_batch, outermost, spans


def read(run):
    if not outermost(spans(run), 'rnn'):
        return None
    return host_ms_per_batch(run, 'rnn')
