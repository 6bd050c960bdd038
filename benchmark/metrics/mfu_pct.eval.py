"""Closed-form forward FLOPs of the untraced batches' blocks over their
seconds, as a share of the card's bf16 dense peak (yardstick.PEAKS)."""
from benchmark.harness import yardstick as Y
from benchmark.metrics._share import mfu_pct


def read(run):
    blocks = run.rest_units * run.traffic['batch_size']
    return mfu_pct(run, Y.forward_flops(run.arch, run.arch['block_len']) * blocks)
