"""Host milliseconds inside the harness's calls to sweep_counts, over the
window's untraced batches (their total over their count)."""


def read(run):
    return run.spans.mean_ms('sweep_counts')
