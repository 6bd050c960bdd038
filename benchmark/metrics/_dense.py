"""The work of one dense conv stack (ops/conv1d.py:dense_stack_apply in the
program, DenseSameShapeConv1d in the reference repository), counted by
yardstick.conv_stack_work's rule."""
from typing import Tuple


def dense_stack_work(B: int, L: int, cin: int, c: int, k: int, num_layer: int,
                     itemsize: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) one dense stack needs over B rows of L positions,
    layer i reading cin + i * c channels: the input, the weights and the
    output read or written once in `itemsize` bytes, f32 biases; no halo,
    no intermediate activation and no concatenation."""
    n_w = k * c * sum(cin + i * c for i in range(num_layer))
    flops = 2 * B * L * n_w
    nbytes = (B * L * cin + n_w + B * L * c) * itemsize + num_layer * c * 4
    return flops, nbytes
