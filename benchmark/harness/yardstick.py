"""The benchmark's frozen arithmetic: closed-form FLOPs, the peak table,
K2's per-launch work and the union of device intervals. Nothing here reads the package under test, so a change to the
program cannot move the yardstick.

FLOPs count the products of the convolutions and linear heads (2 per
multiply-add), as torch.utils.flop_counter counts them; elementwise work is
not counted. A conv layer Cin -> Cout of kernel K over a block of length L
is 2 L K Cin Cout, a head 2 L in out. Each configuration's plain reference
(benchmark/reference/<reference>.py, named by the configuration's file)
gives its forward's count by that rule, `forward_flops(arch, block_len)`.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM5 at its 700 W limit, dense (no sparsity):
# bf16 on the tensor cores, f32 outside them, HBM3 bandwidth. Keyed by
# torch.cuda.get_device_name(); a card not in the table gives no share.
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bfloat16': 989.4e12, 'float32': 66.9e12,
                              'bytes_per_s': 3.35e12},
}


def peak(device_name: str, key: str) -> Optional[float]:
    return PEAKS.get(device_name, {}).get(key)


# ------------------------------------------------------------------ FLOPs
def reference(arch: dict):
    """The plain reference module that the configuration names."""
    return importlib.import_module(f'benchmark.reference.{arch["reference"]}')


def forward_flops(arch: dict, block_len: int) -> int:
    """FLOPs of one block's forward, as the configuration's reference counts them."""
    return reference(arch).forward_flops(arch, block_len)


# ---------------------------------------------------------- K2's roofline
def conv_stack_work(B: int, L: int, cin: int, c: int, k: int, num_layer: int,
                    itemsize: int = 2) -> Tuple[int, int]:
    """(FLOPs, bytes) one launch of a fused conv stack needs over B rows of
    L positions: the input, the weights and the output read or written once
    in `itemsize` bytes, f32 biases; no halo, no intermediate activation."""
    n_w = k * cin * c + (num_layer - 1) * k * c * c
    flops = 2 * B * L * n_w
    nbytes = (B * L * cin + n_w + B * L * c) * itemsize + num_layer * c * 4
    return flops, nbytes


def bound_s(flops: int, nbytes: int, device_name: str, dtype: str = 'bfloat16'
            ) -> Optional[float]:
    """The least time the card needs: the larger of FLOPs over the peak and
    bytes over the bandwidth; None for a card not in PEAKS."""
    f, b = peak(device_name, dtype), peak(device_name, 'bytes_per_s')
    if f is None or b is None:
        return None
    return max(flops / f, nbytes / b)


# --------------------------------------------------------- device intervals
Interval = Tuple[int, int]


def union(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The union of [start, end) intervals clipped to [lo, hi), sorted."""
    out: List[List[int]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The idle intervals of [lo, hi) that `busy` (a union) leaves."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def span_at(spans: Sequence[Tuple[str, int, int]], t: int) -> str:
    """The innermost host span (name, start, end) running at time t."""
    best, width = 'harness', None
    for name, s, e in spans:
        if s <= t < e and (width is None or e - s < width):
            best, width = name, e - s
    return best


def top(items: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])[:n]]
