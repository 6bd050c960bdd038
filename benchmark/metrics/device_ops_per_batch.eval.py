"""Device operations (kernels, copies, sets) of the traced slice over its
program `sweep` spans: the eager host's dispatch load a batch, the
harness's own draw and accumulation included."""
from benchmark.metrics._program import batches, spans


def read(run):
    n = batches(spans(run))
    if not n:
        return None
    return len(run.trace['events']) / n
