"""BER-curve plotting (JAX: results/plot.py; reference results/fbresults.py
made reusable).

plot_curves(runs) takes {label: {'snr': [...], 'ber': [...]}} dicts (ours or
the published reference tables in results/reference_curves.py) and writes a
semilogy comparison figure. matplotlib is imported when a figure is drawn,
never at import: where it is not installed, plot_curves raises an
ImportError that names it, and parse_log, which needs nothing, still works.
"""
from __future__ import annotations

import ast
from typing import Dict


def plot_curves(runs: Dict[str, dict], out_path: str = 'ber_curves.png',
                ylabel: str = 'BER', title: str = 'BER vs SNR') -> str:
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError('plot_curves draws with matplotlib, which is not installed') from e
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for label, data in runs.items():
        key = 'ber' if 'ber' in data else 'fer'
        ax.semilogy(data['snr'], data[key], marker='o', label=label)
    ax.set_xlabel('SNR (dB)')
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, which='both', alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def parse_log(path: str) -> dict:
    """The final SNR, BER and BLER arrays of a training log (the
    'final results on SNRs' block that Trainer.test prints; reference
    tmp/readlines.py pattern)."""
    snr, ber, bler = None, None, None
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        if line.startswith('final results on SNRs'):
            snr = ast.literal_eval(line.split('SNRs', 1)[1].strip())
        elif line.startswith('BER') and snr is not None and ber is None:
            ber = ast.literal_eval(line.split('BER', 1)[1].strip())
        elif line.startswith('BLER') and ber is not None and bler is None:
            bler = ast.literal_eval(line.split('BLER', 1)[1].strip())
    return {'snr': snr, 'ber': ber, 'bler': bler}
