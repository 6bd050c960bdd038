"""Fused same-length Conv1d stacks: the ports of the Pallas kernels K1 and
K2, and K3 for DenseNet-style stacks. All three run on Hopper's warpgroup
tensor cores (wgmma: B from a ring of weight chunks that a producer warp
fills by bulk copies on mbarriers; A from registers in K1 and K2, by
descriptor from a channel-blocked buffer in K3) over a block of batch rows
laid out in one buffer, with their weights packed in wgmma's swizzled
layout. Their sources share one header, `csrc/hopper.cuh`: the register
rule, the mbarrier, bulk-copy and wgmma helpers, K2's and K3's ELU and bf16
products, and the launchers' prelude.

  - K1, `conv_stack_f32`, replaces `turboae_tpu/kernels/conv_stack.py::
    _fused_forward` (Pallas body `_stack_kernel`, exposed as
    `fused_stack_apply`). CUDA source `csrc/conv_stack_f32.cu`. Every layer is
    ELU(sum_k h[l + k - K//2] @ W[k] + b) with zero padding, f32 in and out,
    f32 bias and ELU, by 3xTF32 (wgmma m64nNk8 TF32: each operand split into
    two TF32 parts, three products per product, ~1e-6 from exact f32;
    `K1Plan`, `k1_plan`); `pack_weights` packs TF32 big and small planes.
  - K2, `conv_stack_bf16`, replaces `_fused_forward_im2col` (Pallas body
    `_stack_kernel_im2col`, exposed as `fused_stack_apply_bf16`). CUDA source
    `csrc/conv_stack_bf16.cu`. x is rounded to bf16; bf16 operands, f32
    accumulation, f32 bias and ELU, bf16 between layers and at the output
    (`K2Plan`, `k2_plan`, `pack_weights_bf16`).
  - K3, `dense_stack_bf16`, replaces no Pallas kernel (the JAX package runs
    dense stacks through XLA's convolutions). CUDA source
    `csrc/dense_stack_bf16.cu`. A dense stack (ops/conv1d.py:
    dense_stack_apply: layer i reads [x, out_0, ..., out_{i-1}]) in one
    launch, K2's roundings and K2's Hopper design, with one channel-blocked
    shared-memory buffer a block that holds every channel of the stack, so
    the running concatenation never reaches device memory and the tensor
    cores read A from it by descriptor (`DensePlan`, `dense_plan`);
    its weights are packed tap by tap and layer by layer by
    `pack_dense_bf16`. models/decoders.py routes every dense stack to it
    under use_fused_conv in bf16; on the card it raises on a stack it cannot
    hold (more than DENSE_N output channels, or a window that keeps no row
    beside its halo), as K2 does.
K2 and K3 share one plan rule, whole rounds of blocks over the SMs
(`_whole_rounds`); all three one search for the longest row a block holds
(`_longest_row`). K1's and K2's packers are one gather (`_swizzle_gather`)
at the kernel's element size, K3's one of its own (`_dense_gather`), both
from one flat tensor of the stack (`_gathered`).

`build.py` compiles each source with nvcc for sm_90a; it is called through
ctypes. For each kernel:
  - `conv_stack_<t>(layers, x)` (K3: `dense_stack_bf16`) is the wrapper. On
    a CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
    the plain version. `<wrapper>.launches` counts the kernel's launches.
  - `launch_alone(<wrapper>, layers, x)` plans and packs once and
    returns the launch alone, for timing the kernel without the packing.
  - `<wrapper>_plain(layers, x)` is the plain PyTorch version: K shifted
    matmuls per layer. K1's is exact f32. K2's and K3's multiply
    bf16-rounded operands in f32 and round to bf16 after every layer; they
    never use a bf16 matmul, which would round the sum before the bias add.
  - `fused_stack_apply[_bf16](layers, x)` and `fused_dense_stack_apply_bf16`
    are the differentiable entry points: the backward recomputes through
    the unfused f32 stack, as the JAX package's `_bwd` and `_bwd_bf16` do.
    Neither Pallas kernel has a backward kernel, so no port has one.

Long blocks: a kernel keeps a block's activations on chip. Where not even one
batch row fits in a block (its accumulators in one SM's registers, its
buffers in shared memory), the wrapper cuts the time axis into overlapping windows
(`run_windowed`) and launches once over all of them; the output is the same.

Packed weights (`packed`): in inference mode, outside a CUDA graph's
capture, a wrapper packs a stack once and keeps the planes, keyed by the
weights' identity (held weakly), `data_ptr()` and `_version` and by the
pack's own plan fields, so that windows and halo windows of another length
share them; an in-place write bumps `_version` and the next call repacks.
`clear_packs()` empties the cache, for writers that bump no version (a CUDA
graph's replay, train/trainer.py:_StepGraph). `conv_stack_<t>.pack_hits`
and `.pack_misses` count its lookups. Elsewhere (training, capture) every
launch packs anew. K4, the GRU layer of kernels/gru.py, keeps its packed
weights in the same cache.

Spans (utils/logging.py:span), `k2` for K2, `k1` for K1, `k3` for K3: the wrapper's
call (once more inside `k2.window` when it windows), `k2.window` (the
windows' plan, gathers and inner call), `k2.pack` (the packed weights,
the input's cast, the output's allocation), within it `k2.pack.weights`
(the packing itself, absent on a hit) and `k2.launch` (the ctypes
launch); `wait` around each copy that makes the host wait for the card.

`layers` is a list of {'w': (C, Cin, K), 'b': (C,)} in PyTorch's layout
(K3: layer i's w is (C, Cin + i*C, K)).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from collections import OrderedDict
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.conv1d import dense_stack_apply, stack_apply
from ..utils.logging import span
from . import build

# each library is named after its wrapper: csrc/<name>.cu exports <name>_launch
# (K4's, `gru_bf16`, lives in kernels/gru.py)
LIBRARIES = ('conv_stack_bf16', 'conv_stack_f32', 'dense_stack_bf16', 'gru_bf16')
# shared memory one thread block can use on sm_90 (227 KB)
SMEM_LIMIT = 232448

Layers = List[Dict[str, torch.Tensor]]


# every launcher takes six tensor pointers, then (B, plan, n_plan, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, f'{name}_launch')
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Plan:
    """A launch plan whose dataclass fields are the ints of the source's struct Plan."""
    def as_ints(self):
        return [getattr(self, f.name) for f in fields(self)]


def _whole_rounds(layout: Callable, B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
                  n_sm: int):
    """K2's and K3's launch by their `layout(L, Cin, C, K, num_layer, R, G)`
    on a card of `n_sm` SMs (one block an SM at a time), or None when not
    even one row of length L fits in the registers and shared memory of a
    block: then the wrapper windows the time axis. With Rmax the most rows a
    block holds, the call needs rounds = ceil(B / (n_sm * Rmax)) rounds of
    blocks over the SMs. It launches G = min(B, n_sm * rounds) blocks and
    shares the rows evenly among them, ceil(B / G) or one fewer a block:
    every round is whole, and a block of fewer rows issues fewer products."""
    r_max = 0
    while r_max < max(B, 1) and layout(L, Cin, C, K, num_layer, r_max + 1).fits():
        r_max += 1
    if r_max == 0:
        return None
    G = max(1, min(B, n_sm * _cdiv(B, n_sm * r_max)))
    return layout(L, Cin, C, K, num_layer, _cdiv(B, G) if B else 1, G)


def _longest_row(layout: Callable, L: int, Cin: int, C: int, K: int, num_layer: int) -> int:
    """The longest time axis of which `layout` fits one batch row in a
    block, searched down from L (the callers': as many rows as the
    warpgroups cover); 0 if none."""
    while L > 0 and not layout(L, Cin, C, K, num_layer, 1).fits():
        L -= 1
    return L


# ---------------------------------------------------------------- K2's layout
# wgmma width N -> the most consumer warpgroups a block holds, each with an
# m64 x N tile of f32 accumulators (N/2 registers a thread), beside the
# producer warpgroup within one SM's register file (csrc/conv_stack_bf16.cu
# `conv_stack_bf16_launch`; csrc/hopper.cuh `consumer_regs`)
K2_WIDTHS = {32: 7, 104: 5, 128: 4, 256: 2}
K2_STAGES = (4, 3, 2)   # stages of the weight ring, the most that fit first
K2_CHUNK = 64        # contraction rows of a weight chunk: one 128-byte swizzle atom (CHUNK_K)


def k2_stride(c: int) -> int:
    """Row stride of a bf16 activation buffer: c rounded up to an odd
    multiple of 8, so rows are 16-byte aligned for ldmatrix and the eight
    rows one ldmatrix reads fall in distinct shared-memory banks."""
    s = _cdiv(c, 8) * 8
    return s + 8 if (s // 8) % 2 == 0 else s


def k2_width(c: int):
    """(N, ngroups): the wgmma width and the column groups that cover c
    output channels; N is the narrowest of K2_WIDTHS that holds c (or
    c / ngroups, for c above 256)."""
    c8 = _cdiv(c, 8) * 8
    ngroups = _cdiv(c8, 256)
    per = _cdiv(_cdiv(c8, ngroups), 8) * 8
    return min(n for n in K2_WIDTHS if n >= per), ngroups


@dataclass(frozen=True)
class K2Plan(_Plan):
    """K2's launch (struct Plan in conv_stack_bf16.cu, field for field).

    A block holds up to R batch rows of P = L+K-1 rows each (K//2 zero halo
    rows on each side), one after another in a flat buffer of row stride S
    (S0 for x); output row m reads the span [m*S, m*S + Kc) of it, so a
    layer is one (M, Kc) x (Kc, ngroups*N) product with M = R*P - (K-1).
    `nc` consumer warpgroups hold one m64 tile of M each. G blocks share the
    B batch rows evenly: block i takes rows [i*B//G, (i+1)*B//G), at most R.
    The weights stream in chunks of 64 contraction rows and N columns
    through a ring of `stages` stages."""
    L: int
    Cin: int
    C: int
    K: int
    num_layer: int
    R: int
    G: int
    P: int
    S: int
    S0: int
    N: int
    ngroups: int
    nc: int
    stages: int
    Kc: int
    Kc0: int
    rows_alloc: int
    rows_alloc0: int

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory: the ring's 1024-byte alignment,
        the ring, two activation buffers and x's buffer in bf16, every
        layer's bias in f32, and the ring's mbarriers."""
        return (1024 + self.stages * self.N * 128
                + 2 * (2 * self.rows_alloc * self.S + self.rows_alloc0 * self.S0)
                + 4 * self.num_layer * self.ngroups * self.N + 16 * self.stages)

    def fits(self) -> bool:
        return self.nc <= K2_WIDTHS[self.N] and self.smem <= SMEM_LIMIT


def k2_layout(L: int, Cin: int, C: int, K: int, num_layer: int, R: int, G: int = 1) -> K2Plan:
    """K2's block layout for R batch rows of length L (it may not fit)."""
    S, S0, P = k2_stride(C), k2_stride(Cin), L + K - 1
    Kc, Kc0 = _cdiv(K * S, 16) * 16, _cdiv(K * S0, 16) * 16
    N, ngroups = k2_width(C)
    nc = _cdiv(R * P - (K - 1), 64)
    # the last A row starts at (64*nc - 1)*S and spans Kc values
    rows_alloc = 64 * nc - 1 + _cdiv(Kc, S)
    rows_alloc0 = 64 * nc - 1 + _cdiv(Kc0, S0)
    plans = [K2Plan(L, Cin, C, K, num_layer, R, G, P, S, S0, N, ngroups, nc, stages, Kc, Kc0,
                    rows_alloc, rows_alloc0) for stages in K2_STAGES]
    return next((p for p in plans if p.smem <= SMEM_LIMIT), plans[-1])


@functools.lru_cache(maxsize=256)
def k2_plan(B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
            n_sm: int) -> Optional[K2Plan]:
    """K2's launch for a call on a card of `n_sm` SMs, or None (windowed):
    whole rounds of blocks (`_whole_rounds`). At the decoder's shape on 132
    SMs (Rmax 3): B=2000 in 792 blocks of 2-3 rows (6 rounds), 500 in 264 of
    1-2, 334 in 132 of 2-3, 64 in 64 of 1."""
    return _whole_rounds(k2_layout, B, L, Cin, C, K, num_layer, n_sm)


def k2_max_rows(Cin: int, C: int, K: int, num_layer: int) -> int:
    """K2's longest time axis that one block holds (one batch row); 0 if none."""
    return _longest_row(k2_layout, 64 * K2_WIDTHS[k2_width(C)[0]], Cin, C, K, num_layer)


# ---------------------------------------------------------------- K1's layout
# wgmma width N -> (the most consumer warpgroups a block holds, the most m64
# tiles each runs): a warpgroup holds an m64 x N tile of f32 accumulators
# for each of its tiles and one partial set (N/2 registers a thread each)
# and a chunk's split A fragments, beside the producer warpgroup within one
# SM's register file (csrc/conv_stack_f32.cu `conv_stack_f32_launch`;
# csrc/hopper.cuh `consumer_regs`). Wider C takes column groups of at most
# 128, each on its own warpgroups.
K1_WIDTHS = {32: (4, 1), 104: (2, 2), 128: (2, 1)}
K1_STAGES = (8, 6, 4, 3, 2)   # stages of the weight ring, the most that fit first
K1_CHUNK = 32        # contraction rows of a weight chunk: one 128-byte swizzle atom (CHUNK_K)


def k1_stride(c: int) -> int:
    """Row stride of an f32 activation buffer: c rounded up to an odd
    multiple of 4, so rows are 16-byte aligned for ldmatrix and the eight
    rows one ldmatrix reads fall in distinct shared-memory banks."""
    s = _cdiv(c, 4) * 4
    return s + 4 if (s // 4) % 2 == 0 else s


def k1_width(c: int):
    """(N, ngroups): the wgmma width and the column groups that cover c
    output channels; N is the narrowest of K1_WIDTHS that holds c (or
    c / ngroups, for c above 128)."""
    c8 = _cdiv(c, 8) * 8
    ngroups = _cdiv(c8, max(K1_WIDTHS))
    per = _cdiv(_cdiv(c8, ngroups), 8) * 8
    return min(n for n in K1_WIDTHS if n >= per), ngroups


@dataclass(frozen=True)
class K1Plan(_Plan):
    """K1's launch (struct Plan in conv_stack_f32.cu, field for field).

    K2's flat layout in f32: a block holds R batch rows of P = L+K-1 rows
    each (K//2 zero halo rows on each side), one after another in one buffer
    of row stride S (S0 for x); output row m reads the span [m*S, m*S + Kc)
    of it, so a layer is one (M, Kc) x (Kc, ngroups*N) product with M =
    R*P - (K-1). `nc` consumer warpgroups: for each column group, one per
    `tpw` m64 tiles of M. ceil(B / R) blocks. The weights stream in chunks of 32
    contraction rows and N columns, two TF32 planes each, through a ring of
    `stages` stages (a multiple of ngroups)."""
    L: int
    Cin: int
    C: int
    K: int
    num_layer: int
    R: int
    P: int
    S: int
    S0: int
    N: int
    ngroups: int
    nc: int
    tpw: int
    stages: int
    Kc: int
    Kc0: int
    rows_alloc: int
    rows_alloc0: int

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory: the ring's 1024-byte alignment,
        the ring (two planes a stage), one activation buffer (overwritten in
        place) and x's buffer, every layer's bias, all f32, and the ring's
        mbarriers."""
        return (1024 + self.stages * self.N * 256
                + 4 * (self.rows_alloc * self.S + self.rows_alloc0 * self.S0)
                + 4 * self.num_layer * self.ngroups * self.N + 16 * self.stages)

    def fits(self) -> bool:
        ncmax, tpw = K1_WIDTHS[self.N]
        return self.nc <= ncmax and self.tpw <= tpw and self.smem <= SMEM_LIMIT


def k1_layout(L: int, Cin: int, C: int, K: int, num_layer: int, R: int) -> K1Plan:
    """K1's block layout for R batch rows of length L (it may not fit)."""
    S, S0, P = k1_stride(C), k1_stride(Cin), L + K - 1
    Kc, Kc0 = _cdiv(K * S, 8) * 8, _cdiv(K * S0, 8) * 8
    N, ngroups = k1_width(C)
    mtiles = _cdiv(R * P - (K - 1), 64)
    # one tile a warpgroup where the warpgroups suffice, else several
    ncmax, most = K1_WIDTHS[N]
    tpw = next((t for t in range(1, most + 1) if _cdiv(mtiles, t) * ngroups <= ncmax), most)
    # the last A row starts at (64*mtiles - 1)*S and spans Kc values
    rows_alloc = 64 * mtiles - 1 + _cdiv(Kc, S)
    rows_alloc0 = 64 * mtiles - 1 + _cdiv(Kc0, S0)
    plans = [K1Plan(L, Cin, C, K, num_layer, R, P, S, S0, N, ngroups,
                    _cdiv(mtiles, tpw) * ngroups, tpw, stages, Kc, Kc0, rows_alloc, rows_alloc0)
             for stages in [s for s in K1_STAGES if s % ngroups == 0] or [ngroups]]
    return next((p for p in plans if p.smem <= SMEM_LIMIT), plans[-1])


@functools.lru_cache(maxsize=256)
def k1_plan(B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
            n_sm: int) -> Optional[K1Plan]:
    """K1's layout for a call on a card of `n_sm` SMs, or None when not even
    one row of length L fits in a block: then the wrapper windows the time
    axis. Of the layouts that fit (at most B rows a block), those that need
    the fewest rounds of blocks over the SMs (one block on an SM at a time),
    and of these the one with the fewest rows. At the bench's shape (C=100,
    wgmma n104) two rows a block on two warpgroups of two m64 tiles each:
    250 blocks in 2 rounds on 132 SMs."""
    plans = []
    for R in range(1, max(B, 1) + 1):
        plan = k1_layout(L, Cin, C, K, num_layer, R)
        if not plan.fits():
            break
        plans.append(plan)
    if not plans:
        return None
    rounds = [_cdiv(_cdiv(B, p.R), n_sm) for p in plans]
    return plans[rounds.index(min(rounds))]


def k1_max_rows(Cin: int, C: int, K: int, num_layer: int) -> int:
    """K1's longest time axis that one block holds (one batch row); 0 if none."""
    N, ngroups = k1_width(C)
    ncmax, tpw = K1_WIDTHS[N]
    return _longest_row(k1_layout, 64 * tpw * (ncmax // ngroups), Cin, C, K, num_layer)


# ---------------------------------------------------------------- K3's layout
# K3's one wgmma width, n104 (one instruction, both operands by descriptor),
# for up to 104 output channels (DeepTurbo's 100), and its most consumer
# warpgroups (K2's register rule, csrc/hopper.cuh; csrc/dense_stack_bf16.cu
# `dense_stack_bf16_launch`): four, the most m64 tiles that two rows of
# DeepTurbo's stack fill, so each consumer starts from 96 registers instead
# of K2's 80.
DENSE_N = 104
DENSE_NC = 4


def _even(n: int) -> int:
    return n + n % 2


@dataclass(frozen=True)
class DensePlan(_Plan):
    """K3's launch (struct Plan in dense_stack_bf16.cu, field for field).

    A block holds up to R batch rows of P = L+K-1 rows each (K//2 zero halo
    rows on each side), one after another, in ONE channel-blocked bf16
    buffer of `buf` values that holds every channel of the stack: x in
    [0, Cin), a zero channel up to Cinp (Cin rounded up to even), then layer
    i's output in [Cinp + i*Cs, Cinp + i*Cs + C) (Cs = C rounded up to
    even); the last layer's output goes over [0, Cs). Channel c of row m
    lies at value (c//8)*GS + 8*m + c%8: `groups` groups of 8 channels, GS
    = 8*R*P values apart, each 8 rows by 8 channels of it one 128-byte
    wgmma core matrix; then a zero `tail`, which the padded m64 tiles of the
    last group read (the others read on into the next group). Layer i
    contracts, tap by tap, its own channels rounded up to 16 (`tap_rows`):
    one (M, K * tap_rows(i)) x (.., N) product with M = R*P - (K-1) in `nc`
    m64 tiles, one a consumer warpgroup. G blocks share the B batch rows
    evenly, as K2's. The weights stream in chunks of 64 contraction rows and
    N columns through a ring of `stages` stages."""
    L: int
    Cin: int
    C: int
    K: int
    num_layer: int
    R: int
    G: int
    P: int
    GS: int
    groups: int
    Cinp: int
    Cs: int
    N: int
    nc: int
    stages: int
    buf: int

    def tap_rows(self, i: int) -> int:
        """Contraction rows of one tap of layer i: its channels rounded up to 16."""
        return _cdiv(self.Cinp + i * self.Cs, 16) * 16

    def chunks(self, i: int) -> int:
        """Weight chunks of layer i (its last one zero-filled past its rows)."""
        return _cdiv(self.K * self.tap_rows(i), K2_CHUNK)

    @property
    def tail(self) -> int:
        """Values past the last group: the rows that the padded m64 tiles
        read beyond the last group's R*P (64*nc + K - 1 - R*P), 8 a row."""
        return self.buf - self.groups * self.GS

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory: the ring's 1024-byte alignment,
        the ring, the activation buffer in bf16, every layer's bias in f32,
        and the ring's mbarriers."""
        return (1024 + self.stages * self.N * 128 + 2 * self.buf
                + 4 * self.num_layer * self.N + 16 * self.stages)

    def fits(self) -> bool:
        return self.Cs <= self.N and self.nc <= DENSE_NC and self.smem <= SMEM_LIMIT


def dense_layout(L: int, Cin: int, C: int, K: int, num_layer: int, R: int,
                 G: int = 1) -> DensePlan:
    """K3's block layout for R batch rows of length L (it may not fit):
    groups enough for the deepest layer's tap rows and for the last layer's
    output, 8*R*P values each, and a tail of the rows that the padded tiles
    read past the last group."""
    Cinp, Cs, P = _even(Cin), _even(C), L + K - 1
    nc = _cdiv(R * P - (K - 1), 64)
    GS = 8 * R * P
    groups = _cdiv(max(_cdiv(Cinp + (num_layer - 1) * Cs, 16) * 16, Cs), 8)
    buf = groups * GS + 8 * (64 * nc + K - 1 - R * P)
    plans = [DensePlan(L, Cin, C, K, num_layer, R, G, P, GS, groups, Cinp, Cs, DENSE_N, nc,
                       stages, buf) for stages in K2_STAGES]
    return next((p for p in plans if p.smem <= SMEM_LIMIT), plans[-1])


@functools.lru_cache(maxsize=256)
def dense_plan(B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
               n_sm: int) -> Optional[DensePlan]:
    """K3's launch for a call on a card of `n_sm` SMs, or None when not even
    one row of length L fits in a block (then the wrapper windows the time
    axis); K2's rule of whole rounds (`_whole_rounds`). At DeepTurbo's shape
    on 132 SMs (Rmax 2): B=2000 in 1056 blocks of 1-2 rows (8 rounds)."""
    return _whole_rounds(dense_layout, B, L, Cin, C, K, num_layer, n_sm)


@functools.lru_cache(maxsize=256)
def dense_max_rows(Cin: int, C: int, K: int, num_layer: int) -> int:
    """K3's longest time axis that one block holds (one batch row); 0 if none."""
    return _longest_row(dense_layout, 64 * DENSE_NC, Cin, C, K, num_layer)


def window_plan(L: int, rows: int, halo: int, device='cpu'):
    """Overlapping windows of at most `rows` rows that cover [0, L).

    Window w keeps the T centre rows [w T, (w+1) T) and reads `halo` more
    rows on each side; it is shifted, never cut, to lie inside [0, L), so
    its zero padding falls only on a true end of the sequence, and every kept
    row is at least `halo` rows from any other window edge. With halo =
    num_layer * (K//2), the stack's receptive field, the kept rows are exact.
    Returns (idx_in (nW * rows'), idx_out (L,), rows') as int64 tensors and an
    int: gather x with idx_in into nW windows of rows' <= rows rows, run the
    stack, gather the flat windowed output with idx_out."""
    t_max = rows - 2 * halo
    if t_max < 1:
        raise ValueError(f'a window of {rows} rows, the most that the registers and shared '
                         f'memory of a block hold, keeps no row beside its halo of {halo} '
                         f'on each side')
    n_win = -(-L // t_max)
    T = -(-L // n_win)
    rows = min(T + 2 * halo, L)
    idx_in = torch.empty(n_win * rows, dtype=torch.int64)
    idx_out = torch.empty(L, dtype=torch.int64)
    for w in range(n_win):
        s, e = w * T, min((w + 1) * T, L)
        a = min(max(s - halo, 0), L - rows)
        idx_in[w * rows:(w + 1) * rows] = torch.arange(a, a + rows)
        idx_out[s:e] = torch.arange(w * rows + s - a, w * rows + e - a)
    # a copy from pageable host memory waits for the card's stream to drain
    with span('wait'):
        idx_in = idx_in.to(device)
    with span('wait'):
        idx_out = idx_out.to(device)
    return idx_in, idx_out, rows


def run_windowed(fn: Callable, layers: Layers, x: torch.Tensor, rows: int) -> torch.Tensor:
    """fn(layers, x) computed over windows of at most `rows` time steps, in
    one call of fn on all windows; equal to fn(layers, x) for a stack that
    zero-pads at the sequence's ends."""
    B, L, Cin = x.shape
    K = layers[0]['w'].shape[2]
    idx_in, idx_out, rows = window_plan(L, rows, len(layers) * (K // 2), x.device)
    n_win = idx_in.numel() // rows
    y = fn(layers, x.index_select(1, idx_in).reshape(B * n_win, rows, Cin))
    return y.reshape(B, n_win * rows, y.shape[2]).index_select(1, idx_out)


def _check_layers(layers: Layers, cin: int):
    if not layers:
        raise ValueError('conv stack needs at least one layer')
    C, cin0, K = layers[0]['w'].shape
    if cin0 != cin:
        raise ValueError(f'layer 0 takes {cin0} channels, x has {cin}')
    for i, p in enumerate(layers):
        want = (C, C if i else cin, K)
        if tuple(p['w'].shape) != want or tuple(p['b'].shape) != (C,):
            raise ValueError(f'layer {i}: w {tuple(p["w"].shape)}, b '
                             f'{tuple(p["b"].shape)}; expected w {want}, b ({C},)')
    return C, K


@functools.lru_cache(maxsize=64)
def _swizzle_gather(Cin: int, C: int, K: int, nl: int, N: int, ngroups: int, S: int, S0: int,
                    Kc: int, Kc0: int, elems: int, chunk_major: bool, device: str):
    """Indices that pack a stack into wgmma's K-major 128-byte-swizzle layout
    in one gather from flat = cat(w_0, ..., w_{nl-1} flattened, b_0, ...,
    b_{nl-1}, [0]), for elements of which `elems` fill 16 bytes (8 in bf16,
    4 in f32).

    Weights: layer l's W'[k*S + ci, c] = W_l[c, ci, k] (S0 for layer 0), the
    last index (a zero) where ci >= cin, c >= C or k >= K*S, cut into column
    groups of N and chunks of kch = 8*elems rows (one 128-byte row of the
    atom); chunk (c, g) holds W'[kch*c:kch*(c+1), gN:gN+N], value (k, n) at
    (n//8)*8*kch + (n%8)*kch + ((k//elems) ^ (n%8))*elems + k%elems. A
    layer's chunks run group by group (K2) or, with chunk_major, chunk by
    chunk (K1). Returns (idx_w, the layers' chunks one after another; idx_b
    (nl, ngroups*N), zero beyond C)."""
    kch = 8 * elems
    cins = [Cin] + [C] * (nl - 1)
    offs = [sum(C * ci * K for ci in cins[:i]) for i in range(nl + 1)]
    zero = offs[-1] + nl * C
    q = torch.arange(N * kch)
    n = torch.arange(ngroups).view(-1, 1, 1) * N + (q // (8 * kch) * 8 + q // kch % 8)
    k_in = (q // elems % 8 ^ q // kch % 8) * elems + q % elems
    idx_w = []
    for i, (cin, stride, Kl) in enumerate(zip(cins, [S0] + [S] * (nl - 1),
                                              [Kc0] + [Kc] * (nl - 1))):
        k = torch.arange(_cdiv(Kl, kch)).view(1, -1, 1) * kch + k_in
        tap, ci = k // stride, k % stride
        src = torch.where((tap < K) & (ci < cin) & (n < C), offs[i] + n * cin * K + ci * K + tap,
                          zero)                                    # (ngroups, nch, N*kch)
        idx_w.append((src.transpose(0, 1) if chunk_major else src).reshape(-1))
    nb = torch.arange(ngroups * N)
    idx_b = torch.stack([torch.where(nb < C, offs[-1] + i * C + nb, zero) for i in range(nl)])
    return torch.cat(idx_w).to(device), idx_b.to(device)


def _gathered(layers: Layers, index: Callable, *args):
    """(weights, biases) of the stack gathered by `index(Cin, C, K, nl,
    *args, device)` (`_swizzle_gather`, `_dense_gather`) from flat =
    cat(w_0, ..., w_{nl-1} flattened, b_0, ..., b_{nl-1}, [0]), in the
    weights' own type: one concatenation and two gathers, whatever the
    depth (each op is a launch on the host's clock, and a wrapper packs at
    every call that `packed` does not serve)."""
    C, Cin, K = layers[0]['w'].shape
    parts = [p['w'].reshape(-1) for p in layers] + [p['b'].reshape(-1) for p in layers]
    dev = str(parts[0].device)
    flat = torch.cat(parts + [_zero(dev, parts[0].dtype)])
    idx_w, idx_b = index(Cin, C, K, len(layers), *args, dev)
    return flat[idx_w], flat[idx_b]


def tf32_split(w: torch.Tensor):
    """(big, small): the TF32 parts of f32 w, big = rna(w), small =
    rna(w - big), rna TF32's round to nearest with ties away from zero by
    the kernel's integer add and mask (low 13 bits zero); big + small is w
    to 2^-22 relative."""
    def rna(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    big = rna(w)
    return big, rna(w - big)


def pack_weights(layers: Layers, plan: K1Plan):
    """Weights in K1's layout (`_swizzle_gather` at 4-byte elements, chunk by
    chunk): chunks of 32 rows of W' and N columns, each its TF32 big plane
    then its small plane (`tf32_split`) in wgmma's swizzled layout; biases
    f32, zero beyond C.

    Returns (w0 (ceil(Kc0/32), ngroups, 2, N*32), b0 (ngroups*N,), wr (nl-1,
    ceil(Kc/32), ngroups, 2, N*32), br (nl-1, ngroups*N)), views of one
    buffer each; wr and br are None for one layer."""
    w, b = _gathered(layers, _swizzle_gather, plan.N, plan.ngroups, plan.S, plan.S0, plan.Kc,
                     plan.Kc0, 4, True)
    w, b = w.float().view(-1, plan.N * K1_CHUNK), b.float()
    planes = torch.stack(tf32_split(w), dim=1)            # (chunks, 2, N*32)
    nch0 = _cdiv(plan.Kc0, K1_CHUNK)
    w0 = planes[:nch0 * plan.ngroups].view(nch0, plan.ngroups, 2, -1)
    if len(layers) == 1:
        return w0, b[0], None, None
    wr = planes[nch0 * plan.ngroups:].view(len(layers) - 1, -1, plan.ngroups, 2,
                                           plan.N * K1_CHUNK)
    return w0, b[0], wr, b[1:]


@functools.lru_cache(maxsize=16)
def _zero(device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(1, dtype=dtype, device=device)


def pack_weights_bf16(layers: Layers, plan: K2Plan):
    """Weights in K2's layout (`_swizzle_gather` at 2-byte elements, group by
    group): bf16 chunks of 64 rows of W' and N columns in wgmma's swizzled
    layout; biases f32, zero beyond C.

    Returns (w0 (ngroups, ceil(Kc0/64), N*64), b0 (ngroups*N,), wr (nl-1,
    ngroups, ceil(Kc/64), N*64), br (nl-1, ngroups*N)), views of one
    buffer each; wr and br are None for one layer."""
    w, b = _gathered(layers, _swizzle_gather, plan.N, plan.ngroups, plan.S, plan.S0, plan.Kc,
                     plan.Kc0, 8, False)
    w, b = w.to(torch.bfloat16), b.float()
    n0 = plan.ngroups * _cdiv(plan.Kc0, K2_CHUNK) * plan.N * K2_CHUNK
    w0 = w[:n0].view(plan.ngroups, -1, plan.N * K2_CHUNK)
    if len(layers) == 1:
        return w0, b[0], None, None
    return w0, b[0], w[n0:].view(len(layers) - 1, plan.ngroups, -1, plan.N * K2_CHUNK), b[1:]


@functools.lru_cache(maxsize=64)
def _dense_gather(Cin: int, C: int, K: int, nl: int, N: int, Cinp: int, Cs: int, device: str):
    """Indices that pack a dense stack into K3's chunks in one gather from
    flat = cat(w_0, ..., w_{nl-1} flattened, b_0, ..., b_{nl-1}, [0]).

    Layer i's W_i'[16*j + q, n], k16 step j = tap * T + g (T = tap_rows(i)
    / 16), is W_i[n, ci, tap] for the buffer channel ch = 16*g + q: ci = ch
    for ch < Cin, ci = Cin + s*C + cc for ch = Cinp + s*Cs + cc with cc < C
    and ch below the layer's own Cinp + i*Cs; the last index (a zero)
    elsewhere and for n >= C. Rows run in chunks of 64 (zero past K*16*T),
    value (k, n) of a chunk at (n//8)*512 + (n%8)*64 + ((k//8) ^ (n%8))*8 +
    k%8. Returns (idx_w, the layers' chunks one after another; idx_b (nl,
    N), zero beyond C)."""
    cins = [Cin + i * C for i in range(nl)]
    offs = [sum(C * ci * K for ci in cins[:i]) for i in range(nl + 1)]
    zero = offs[-1] + nl * C
    q = torch.arange(N * K2_CHUNK)
    n = q // (8 * K2_CHUNK) * 8 + q // K2_CHUNK % 8
    k_in = (q // 8 % 8 ^ q // K2_CHUNK % 8) * 8 + q % 8
    idx_w = []
    for i in range(nl):
        rows = _cdiv(Cinp + i * Cs, 16) * 16
        k = torch.arange(_cdiv(K * rows, K2_CHUNK)).view(-1, 1) * K2_CHUNK + k_in   # (nch, N*64)
        tap, ch = k // rows, k % rows
        slot, cc = (ch - Cinp) // Cs, (ch - Cinp) % Cs
        ci = torch.where(ch < Cin, ch, Cin + slot * C + cc)
        ok = (tap < K) & (n < C) & (ch < Cinp + i * Cs) & ((ch < Cin) | ((ch >= Cinp) & (cc < C)))
        idx_w.append(torch.where(ok, offs[i] + n * cins[i] * K + ci * K + tap, zero).reshape(-1))
    nb = torch.arange(N)
    idx_b = torch.stack([torch.where(nb < C, offs[-1] + i * C + nb, zero) for i in range(nl)])
    return torch.cat(idx_w).to(device), idx_b.to(device)


def pack_dense_bf16(layers: Layers, plan: DensePlan):
    """Weights in K3's layout (`_dense_gather`): bf16 chunks of 64 rows of
    W_i' and N columns in wgmma's swizzled layout, layer after layer;
    biases f32, zero beyond C.

    Returns (w0 (chunks(0), N*64), b0 (N,), wr (sum of chunks(i), i >= 1,
    N*64), br (nl-1, N)), views of one buffer each; wr and br are None for
    one layer."""
    w, b = _gathered(layers, _dense_gather, plan.N, plan.Cinp, plan.Cs)
    w, b = w.to(torch.bfloat16).view(-1, plan.N * K2_CHUNK), b.float()
    n0 = plan.chunks(0)
    if len(layers) == 1:
        return w[:n0], b[0], None, None
    return w[:n0], b[0], w[n0:], b[1:]


def _elu_exp(v: torch.Tensor) -> torch.Tensor:
    """The Pallas kernels' ELU, exp(min(v, 0)) - 1 below zero (conv_stack.py:45-47)."""
    return torch.where(v > 0, v, torch.exp(torch.clamp(v, max=0.0)) - 1.0)


def _shifted_matmul_layer(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k hpad[:, l + k] @ W[:, :, k].T + b, zero padding K//2 in front."""
    L, K = h.shape[1], w.shape[2]
    pad = K // 2
    hp = F.pad(h, (0, 0, pad, K - 1 - pad))
    return sum(torch.matmul(hp[:, k:k + L, :], w[:, :, k].t()) for k in range(K)) + b


def conv_stack_f32_plain(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: (B, L, Cin) -> (B, L, C) f32."""
    h = x.float()
    for p in layers:
        h = _elu_exp(_shifted_matmul_layer(h, p['w'].float(), p['b'].float()))
    return h


def conv_stack_bf16_plain(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: (B, L, Cin) -> (B, L, C) bf16."""
    h = x.to(torch.bfloat16).float()
    for p in layers:
        w = p['w'].to(torch.bfloat16).float()
        h = F.elu(_shifted_matmul_layer(h, w, p['b'].float())).to(torch.bfloat16).float()
    return h.to(torch.bfloat16)


def dense_stack_bf16_plain(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: (B, L, Cin) -> (B, L, C) bf16, layer i
    on the running concatenation [x, out_0, ..., out_{i-1}], each output
    rounded to bf16 once (after bias and ELU in f32)."""
    feats = x.to(torch.bfloat16).float()
    for i, p in enumerate(layers):
        w = p['w'].to(torch.bfloat16).float()
        out = F.elu(_shifted_matmul_layer(feats, w, p['b'].float())).to(torch.bfloat16).float()
        if i < len(layers) - 1:
            feats = torch.cat([feats, out], dim=-1)
    return out.to(torch.bfloat16)


def _check_dense_layers(layers: Layers, cin: int):
    if not layers:
        raise ValueError('dense stack needs at least one layer')
    C, cin0, K = layers[0]['w'].shape
    if C > DENSE_N:
        raise ValueError(f'dense_stack_bf16 holds at most {DENSE_N} output channels '
                         f'(its one wgmma width), got {C}')
    if cin0 != cin:
        raise ValueError(f'layer 0 takes {cin0} channels, x has {cin}')
    for i, p in enumerate(layers):
        want = (C, cin + i * C, K)
        if tuple(p['w'].shape) != want or tuple(p['b'].shape) != (C,):
            raise ValueError(f'dense layer {i}: w {tuple(p["w"].shape)}, b '
                             f'{tuple(p["b"].shape)}; expected w {want}, b ({C},)')
    return C, K


def _checked(name: str, layers: Layers, x: torch.Tensor):
    """(B, L, Cin, C, K) of a call on x's CUDA device, or ValueError."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name} runs on cuda or cpu, got {x.device}')
    if x.dim() != 3:
        raise ValueError(f'x must be (B, L, Cin), got shape {tuple(x.shape)}')
    B, L, Cin = x.shape
    C, K = _SPECS[name].check(layers, Cin)
    for p in layers:
        if p['w'].device != x.device or p['b'].device != x.device:
            raise ValueError('weights and x must be on the same device')
    return B, L, Cin, C, K


def _run(name: str, x: torch.Tensor, *args):
    """Calls <name>_launch on x's current stream and raises on its error code."""
    lib = _library(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f'{name}_launch')(*args, stream)
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')


def _ptr(t):
    return None if t is None else t.data_ptr()


def _weights(layers: Layers) -> List[torch.Tensor]:
    return [t for p in layers for t in (p['w'], p['b'])]


@dataclass(frozen=True)
class _Spec:
    """What a wrapper's launch needs of its kernel."""
    plan: Callable          # k<i>_plan
    max_rows: Callable      # k<i>_max_rows
    pack: Callable          # pack_weights[_bf16]
    dtype: torch.dtype      # of x and out
    span: str               # the wrapper's span, 'k1', 'k2', 'k3' or 'k4'
    check: Callable = _check_layers   # the layers' shapes against x's channels, -> (C, K)
    # the plan's fields that the packed weights depend on (with the weights' shapes)
    pack_key: Callable = lambda p: (p.N, p.ngroups, p.S, p.S0, p.Kc, p.Kc0)
    tensors: Callable = _weights      # the tensors that the pack reads, in order


# the most stacks whose packed weights are kept; the least recently used goes
PACKS_HELD = 64


class _Packed(NamedTuple):
    refs: tuple        # a weak reference to each w and b, whose death drops the entry
    stamp: tuple       # their (data_ptr, _version), then the stream packed on
    planes: tuple      # (w0, b0, wr, br)


# (wrapper, the pack's plan fields, id of each w and b) -> _Packed, oldest
# first; an id is not reused while its entry lives, since the weight's death
# drops the entry
_packs: 'OrderedDict[tuple, _Packed]' = OrderedDict()


def clear_packs():
    """Forget every packed stack, for a writer of weights that bumps no
    `_version` (a CUDA graph's replay)."""
    _packs.clear()


def _capturing() -> bool:
    return torch.backends.cuda.is_built() and torch.cuda.is_current_stream_capturing()


def _stamp(tensors) -> Optional[tuple]:
    """(data_ptr, _version) of each tensor and the current stream on their
    card; None where the cache must not serve: outside inference mode (the
    caller may train), under a capture (a graph would replay stale planes
    after each optimizer step) or for an inference tensor (no version)."""
    if (not torch.is_inference_mode_enabled() or _capturing()
            or any(t.is_inference() for t in tensors)):
        return None
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream if dev.type == 'cuda' else None
    return (*((t.data_ptr(), t._version) for t in tensors), stream)


def packed(wrapper, layers: Layers, plan):
    """The wrapper's packed planes for `plan` ((w0, b0, wr, br) for K1-K3,
    (w, b) for K4), bit for bit its spec's `pack(layers, plan)`: kept from
    an earlier call where the weights are the same tensors, unwritten since,
    on the same stream; packed anew (the span `<k>.pack.weights`) otherwise."""
    name, spec = wrapper.__name__, _SPECS[wrapper.__name__]
    tensors = spec.tensors(layers)
    stamp = _stamp(tensors)
    if stamp is None:
        with span(f'{spec.span}.pack.weights'):
            return spec.pack(layers, plan)
    key = (name, *spec.pack_key(plan), *map(id, tensors))
    hit = _packs.get(key)
    if hit is not None and hit.stamp == stamp:
        _packs.move_to_end(key)
        wrapper.pack_hits += 1
        return hit.planes
    with span(f'{spec.span}.pack.weights'):
        planes = spec.pack(layers, plan)
    wrapper.pack_misses += 1

    def forget(_, key=key):   # a weight is freed: so is its entry
        _packs.pop(key, None)
    _packs[key] = _Packed(tuple(weakref.ref(t, forget) for t in tensors), stamp, planes)
    _packs.move_to_end(key)
    while len(_packs) > PACKS_HELD:
        _packs.popitem(last=False)
    return planes


def _prepared(wrapper, plan, layers: Layers, x: torch.Tensor,
              fn: Optional[Callable] = None) -> Callable[[], torch.Tensor]:
    """Packs the weights (`packed`) and x once for `plan`; returns call(),
    which launches the wrapper's kernel on them, counts the launch and returns
    the output (one tensor, written anew by each call). With `fn`, a
    launcher of the same C interface built from a variant of the source
    (cli/k1_variants.py, cli/k2_variants.py), call() launches that instead
    and counts nothing."""
    name, spec = wrapper.__name__, _SPECS[wrapper.__name__]
    with span(f'{spec.span}.pack'):
        w0, b0, wr, br = packed(wrapper, layers, plan)
        xc = x.to(spec.dtype).contiguous()
        B, L, _ = x.shape
        out = torch.empty((B, L, plan.C), dtype=spec.dtype, device=x.device)
        for t in (w0, wr):   # the bulk copies move 16-byte units
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f'{name} needs 16-byte aligned weights')
        ints = plan.as_ints()
        args = (xc.data_ptr(), w0.data_ptr(), b0.data_ptr(), _ptr(wr), _ptr(br), out.data_ptr(),
                B, (ctypes.c_int * len(ints))(*ints), len(ints))
    launch = f'{spec.span}.launch'

    def call():
        if not (B and L):
            return out
        with span(launch):
            if fn is None:
                _run(name, x, *args)
                wrapper.launches += 1
            else:
                rc = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f'{name} variant launch failed: CUDA error {rc}')
        return out
    call.tensors = (w0, b0, wr, br, xc)      # alive while call is
    return call


def _plan(wrapper, layers: Layers, x: torch.Tensor):
    """The wrapper's launch plan for x on its card, or None (windowed)."""
    B, L, Cin, C, K = _checked(wrapper.__name__, layers, x)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _SPECS[wrapper.__name__].plan(B, L, Cin, C, K, len(layers), n_sm)


def _launch(wrapper, layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Checks, plans, packs and launches the wrapper's kernel; windows the
    time axis first when one batch row does not fit in a block."""
    plan = _plan(wrapper, layers, x)
    if plan is None:
        C, Cin, K = layers[0]['w'].shape
        spec = _SPECS[wrapper.__name__]
        with span(f'{spec.span}.window'):
            return run_windowed(wrapper, layers, x, spec.max_rows(Cin, C, K, len(layers)))
    return _prepared(wrapper, plan, layers, x)()


def launch_alone(wrapper, layers: Layers, x: torch.Tensor) -> Callable[[], torch.Tensor]:
    """The kernel's launch for (layers, x) on weights planned and packed
    once, for timing it without the packing; each call counts as a
    launch. Raises where the wrapper would window."""
    plan = _plan(wrapper, layers, x)
    if plan is None:
        raise ValueError(f'{wrapper.__name__}: no block holds a row of length {x.shape[1]}')
    return _prepared(wrapper, plan, layers, x)


def conv_stack_f32(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K1's wrapper: (B, L, Cin) -> (B, L, C) f32."""
    with span('k1'):
        if x.device.type == 'cpu':
            return conv_stack_f32_plain(layers, x)
        return _launch(conv_stack_f32, layers, x)


def conv_stack_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K2's wrapper: (B, L, Cin) -> (B, L, C) bf16."""
    with span('k2'):
        if x.device.type == 'cpu':
            return conv_stack_bf16_plain(layers, x)
        return _launch(conv_stack_bf16, layers, x)


def dense_stack_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K3's wrapper: a dense stack, (B, L, Cin) -> (B, L, C) bf16."""
    with span('k3'):
        if x.device.type == 'cpu':
            return dense_stack_bf16_plain(layers, x)
        return _launch(dense_stack_bf16, layers, x)


_SPECS = {'conv_stack_f32': _Spec(k1_plan, k1_max_rows, pack_weights, torch.float32, 'k1'),
          'conv_stack_bf16': _Spec(k2_plan, k2_max_rows, pack_weights_bf16, torch.bfloat16,
                                   'k2'),
          'dense_stack_bf16': _Spec(dense_plan, dense_max_rows, pack_dense_bf16, torch.bfloat16,
                                    'k3', _check_dense_layers, lambda p: (p.N, p.Cinp, p.Cs))}
conv_stack_f32.launches = conv_stack_f32.pack_hits = conv_stack_f32.pack_misses = 0
conv_stack_bf16.launches = conv_stack_bf16.pack_hits = conv_stack_bf16.pack_misses = 0
dense_stack_bf16.launches = dense_stack_bf16.pack_hits = dense_stack_bf16.pack_misses = 0


class _RecomputeStack(torch.autograd.Function):
    """Forward through a kernel; backward recomputes the unfused f32 stack
    `unfused` (JAX conv_stack.py:288-298, 318-326), the cotangent cast to
    f32. Only the inputs that need a gradient get one."""

    @staticmethod
    def forward(ctx, kernel, unfused, x, n_layers, *flat):
        layers = [{'w': flat[2 * i], 'b': flat[2 * i + 1]} for i in range(n_layers)]
        ctx.unfused, ctx.n_layers = unfused, n_layers
        ctx.save_for_backward(x, *flat)
        return kernel(layers, x)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        need = [ctx.needs_input_grad[2], *ctx.needs_input_grad[4:]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip([x, *flat], need)]
            x, *flat = inputs
            layers = [{'w': flat[2 * i], 'b': flat[2 * i + 1]}
                      for i in range(ctx.n_layers)]
            out = ctx.unfused(layers, x.float())
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad],
                                             g.to(out.dtype)))
        x_grad, *w_grads = [next(grads) if n else None for n in need]
        return (None, None, x_grad, None, *w_grads)


def _fused(kernel, layers: Layers, x: torch.Tensor, unfused=stack_apply) -> torch.Tensor:
    flat = [t for p in layers for t in (p['w'], p['b'])]
    return _RecomputeStack.apply(kernel, unfused, x, len(layers), *flat)


def fused_stack_apply(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K1 forward, f32 out; gradients of the unfused f32 stack."""
    return _fused(conv_stack_f32, layers, x)


def fused_stack_apply_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K2 forward, bf16 out; gradients of the unfused f32 stack."""
    return _fused(conv_stack_bf16, layers, x)


def fused_dense_stack_apply_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K3 forward, bf16 out; gradients of the unfused f32 dense stack
    (ops/conv1d.py:dense_stack_apply)."""
    return _fused(dense_stack_bf16, layers, x, dense_stack_apply)


def conv_stack_work(B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
                    itemsize: int):
    """(FLOP, bytes) one call needs: x, weights and output of `itemsize`
    bytes each read or written once, f32 biases; no intermediate activation."""
    n_w = K * Cin * C + (num_layer - 1) * K * C * C
    nbytes = (B * L * Cin + n_w + B * L * C) * itemsize + num_layer * C * 4
    return 2 * B * L * n_w, nbytes


def dense_stack_work(B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
                     itemsize: int = 2):
    """(FLOP, bytes) one dense stack needs, layer i reading Cin + i*C
    channels: x, weights and output of `itemsize` bytes each read or written
    once, f32 biases; no intermediate activation and no concatenation."""
    n_w = K * C * sum(Cin + i * C for i in range(num_layer))
    nbytes = (B * L * Cin + n_w + B * L * C) * itemsize + num_layer * C * 4
    return 2 * B * L * n_w, nbytes
