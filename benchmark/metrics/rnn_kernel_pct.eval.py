"""Share of the GRU stacks' layers that ran as one launch of the program's
GRU kernel: its launch counter `gru_bf16.launches` (kernels/gru.py) over
`birnn_apply.layers` (ops/gru.py), over the whole run, in %. None where the
program has no such kernel or launch counter, or made no layer call."""
import importlib


def read(run):
    from turboae_tpu_torch.ops import gru
    try:
        kernels = importlib.import_module('turboae_tpu_torch.kernels.gru')
    except ImportError:
        return None
    launches = getattr(getattr(kernels, 'gru_bf16', None), 'launches', None)
    layers = getattr(gru.birnn_apply, 'layers', 0)
    if launches is None or not layers:
        return None
    return 100.0 * launches / layers
