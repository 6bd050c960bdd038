"""Host milliseconds inside the trellis encoder a batch: the program's
`trellis` spans (models/deepturbo.py:turbo_enc_apply, the loop over
positions of classical/convcode.py:make_encoder) in the traced slice,
summed, over its `sweep` spans. None where the program records no
`trellis` span."""
from benchmark.metrics._program import host_ms_per_batch, outermost, spans


def read(run):
    if not outermost(spans(run), 'trellis'):
        return None
    return host_ms_per_batch(run, 'trellis')
