"""The faults a sweep cell's timed path can have, planted in the program
under test for the readings of faults (tools/readings.py) and for the CPU
tests that see `correct` come out false:

  - 'half': half of each batch left out, the rest standing for the whole
    (the counts of the first half doubled);
  - 'answer': the decision at one position of every block inverted where
    the decoder produces it.

`plant(fault)` returns a function that takes the fault out again.
"""
from __future__ import annotations


def plant(fault: str):
    import turboae_tpu_torch.train.sweep as sweep_mod
    undo = []

    def put(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == 'half':
        counts = sweep_mod.sweep_counts

        def half_counts(params, cfg, bits, noise, perms=None, generator=None):
            h = bits.shape[0] // 2
            return tuple(t * 2 for t in counts(params, cfg, bits[:h], noise[:h], perms,
                                               generator))
        put(sweep_mod, 'sweep_counts', half_counts)
    elif fault == 'answer':
        errors = sweep_mod.error_counts

        def altered(bits, out):
            out = out.clone()
            out[:, 0] = 1.0 - out[:, 0]
            return errors(bits, out)
        put(sweep_mod, 'error_counts', altered)
    elif fault != 'none':
        raise ValueError(f'no fault {fault!r}')

    def remove():
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
    return remove
