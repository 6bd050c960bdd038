"""Megabytes copied into cuDNN's flat weight buffers a GRU stack: the
program's counters `birnn_apply.pack_bytes` over `birnn_apply.calls`
(ops/gru.py), over the whole run. None where the program has no such
counters or made no call."""


def read(run):
    from turboae_tpu_torch.ops import gru
    calls = getattr(gru.birnn_apply, 'calls', 0)
    packed = getattr(gru.birnn_apply, 'pack_bytes', None)
    if not calls or packed is None:
        return None
    return packed / calls / 1e6
