"""The work of one bidirectional GRU stack (ops/gru.py:birnn_apply in the
program, torch.nn.GRU(bidirectional=True) in the reference repository),
counted by yardstick.conv_stack_work's rule."""
from typing import Tuple


def birnn_work(B: int, L: int, n_in: int, H: int, layers: int,
               itemsize: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) one biGRU stack needs over B rows of L positions:
    each layer's two directions take 2 B L (In 3H + H 3H) FLOPs (In = n_in
    for the first layer, 2H after); each layer's input, weights and biases
    and output read or written once in `itemsize` bytes; no gate
    activation, no hidden state kept between steps."""
    flops = nbytes = 0
    for i in range(layers):
        fan = n_in if i == 0 else 2 * H
        n_w = 2 * (3 * H * fan + 3 * H * H + 2 * 3 * H)
        flops += 2 * 2 * B * L * (fan * 3 * H + H * 3 * H)
        nbytes += (B * L * fan + n_w + B * L * 2 * H) * itemsize
    return flops, nbytes
