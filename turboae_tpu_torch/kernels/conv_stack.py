"""Fused same-length Conv1d stacks: the ports of the Pallas kernels K1 and K2.

  - K1, `conv_stack_f32`, replaces `turboae_tpu/kernels/conv_stack.py::
    _fused_forward` (Pallas body `_stack_kernel`, exposed as
    `fused_stack_apply`). CUDA source `csrc/conv_stack_f32.cu`. Every layer is
    ELU(sum_k h[l + k - K//2] @ W[k] + b) with zero padding, f32 in and out,
    f32 bias and ELU. It runs on the tensor cores by 3xTF32 (mma.sync m16n8k8:
    each operand split into two TF32 parts, three products per product, ~1e-6
    from exact f32) over a block of several batch rows laid out as one flat
    buffer (`K1Plan`, `k1_plan`), with its weights packed n-major by
    `pack_weights`.
  - K2, `conv_stack_bf16`, replaces `_fused_forward_im2col` (Pallas body
    `_stack_kernel_im2col`, exposed as `fused_stack_apply_bf16`). CUDA source
    `csrc/conv_stack_bf16.cu`. x is rounded to bf16; bf16 operands, f32
    accumulation, f32 bias and ELU, bf16 between layers and at the output.
    It runs on Hopper's warpgroup tensor cores (wgmma, A from registers, B
    from a ring of weight chunks that a producer warp fills by bulk copies
    on mbarriers) over a block of several batch rows laid out as one flat
    buffer (`K2Plan`, `k2_plan`), with its weights packed in wgmma's
    swizzled layout by `pack_weights_bf16`.

`build.py` compiles each source with nvcc for sm_90a; it is called through
ctypes. For each kernel:
  - `conv_stack_<t>(layers, x)` is the wrapper. On a CUDA tensor it launches
    the kernel or raises; on a CPU tensor it runs the plain version.
    `conv_stack_<t>.launches` counts the kernel's launches.
  - `conv_stack_<t>_plain(layers, x)` is the plain PyTorch version: K shifted
    matmuls per layer. K1's is exact f32. K2's multiplies bf16-rounded
    operands in f32 and rounds to bf16 after every layer; it never uses a
    bf16 matmul, which would round the sum before the bias add.
  - `fused_stack_apply[_bf16](layers, x)` is the differentiable entry point:
    its backward recomputes through the unfused f32 stack, as the JAX
    package's `_bwd` and `_bwd_bf16` do. Neither Pallas kernel has a backward
    kernel, so neither port has one.

Long blocks: a kernel keeps a block's activations on chip. Where not even one
batch row fits in a block (its accumulators in one SM's registers, its
buffers in shared memory), the wrapper cuts the time axis into overlapping windows
(`run_windowed`) and launches once over all of them; the output is the same.

`layers` is a list of {'w': (C, Cin, K), 'b': (C,)} in PyTorch's layout.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, fields
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops.conv1d import stack_apply
from . import build

# each library is named after its wrapper: csrc/<name>.cu exports <name>_launch
LIBRARIES = ('conv_stack_bf16', 'conv_stack_f32')
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


# ---------------------------------------------------------------- K2's layout
# wgmma width N -> the most consumer warpgroups a block holds, each with an
# m64 x N tile of f32 accumulators (N/2 registers a thread), beside the
# producer warpgroup within one SM's register file (csrc/conv_stack_bf16.cu
# `conv_stack_bf16_launch`, `consumer_regs`)
K2_WIDTHS = {32: 7, 104: 5, 128: 4, 256: 2}
K2_STAGES = (4, 3, 2)   # stages of the weight ring, the most that fit first
K2_CHUNK = 64        # contraction rows of a weight chunk: one 128-byte swizzle atom (CHUNK_K)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
class K2Plan:
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

    def as_ints(self):
        return [getattr(self, f.name) for f in fields(self)]


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
    """K2's launch for a call on a card of `n_sm` SMs (one block an SM at a
    time), or None when not even one row of length L fits in the registers
    and shared memory of a block: then the wrapper windows the time axis.

    With Rmax the most rows a block holds, the call needs
    rounds = ceil(B / (n_sm * Rmax)) rounds of blocks over the SMs. It
    launches G = min(B, n_sm * rounds) blocks and shares the rows evenly
    among them, ceil(B / G) or one fewer a block: every round is whole, and
    a block of fewer rows issues fewer products. At the decoder's shape on
    132 SMs (Rmax 3): B=2000 in 792 blocks of 2-3 rows (6 rounds), 500 in
    264 of 1-2, 334 in 132 of 2-3, 64 in 64 of 1."""
    r_max = 0
    while r_max < max(B, 1) and k2_layout(L, Cin, C, K, num_layer, r_max + 1).fits():
        r_max += 1
    if r_max == 0:
        return None
    G = max(1, min(B, n_sm * _cdiv(B, n_sm * r_max)))
    return k2_layout(L, Cin, C, K, num_layer, _cdiv(B, G) if B else 1, G)


def k2_max_rows(Cin: int, C: int, K: int, num_layer: int) -> int:
    """K2's longest time axis that one block holds (one batch row); 0 if none."""
    L = 64 * K2_WIDTHS[k2_width(C)[0]]   # as many rows as the warpgroups cover
    while L > 0 and not k2_layout(L, Cin, C, K, num_layer, 1).fits():
        L -= 1
    return L


# ---------------------------------------------------------------- K1's layout
K1_WM = 2            # m16 tiles per warp        (csrc/conv_stack_f32.cu WM)
K1_WN = 13           # n8 tiles per warp         (WN)
K1_MAX_WARPS = 12    # warps per block; bounds the registers (MAX_WARPS)
K1_STAGES = 3        # stages of the weight ring (STAGES)


def k1_stride(c: int) -> int:
    """Row stride of an f32 activation buffer: c rounded up to an odd
    multiple of 4, so rows are 16-byte aligned for ldmatrix and the eight
    rows one ldmatrix reads fall in distinct shared-memory banks."""
    s = _cdiv(c, 4) * 4
    return s + 4 if (s // 4) % 2 == 0 else s


@dataclass(frozen=True)
class K1Plan:
    """One thread block's layout in K1 (struct Plan in conv_stack_f32.cu,
    field for field). K2's flat layout in f32: R batch rows of P = L+K-1
    rows each lie one after another in one buffer of row stride S (S0 for
    x); output row m reads the span [m*S, m*S + Kc) of it, so a layer is one
    (M, Kc) x (Kc, NW) product with M = R*P - (K-1), padded to `mtiles` m16
    tiles (even). Warps: mtiles/2 row groups x `ngroups` column groups of 13
    n8 tiles, which cover the C output channels; the weights are n-major,
    NW = 104 * ngroups rows of Kc (Kc0) values. They stream through a ring
    of three chunks of kch columns, each row kept at stride SK = kch + 4."""
    L: int
    Cin: int
    C: int
    K: int
    num_layer: int
    R: int
    P: int
    S: int
    S0: int
    NW: int
    SK: int
    Kc: int
    Kc0: int
    mtiles: int
    ngroups: int
    kch: int
    rows_alloc: int
    rows_alloc0: int

    @property
    def nwarps(self) -> int:
        return self.mtiles // K1_WM * self.ngroups

    @property
    def smem(self) -> int:
        """Bytes of dynamic shared memory, all f32: one activation buffer
        (overwritten in place), x's buffer, the weight ring and every
        layer's bias."""
        return 4 * (self.rows_alloc * self.S + self.rows_alloc0 * self.S0
                    + K1_STAGES * self.NW * self.SK + self.num_layer * self.NW)

    def fits(self) -> bool:
        return self.nwarps <= K1_MAX_WARPS and self.smem <= SMEM_LIMIT

    def as_ints(self):
        return [getattr(self, f.name) for f in fields(self)]


def k1_layout(L: int, Cin: int, C: int, K: int, num_layer: int, R: int) -> K1Plan:
    """K1's block layout for R batch rows of length L (it may not fit)."""
    S, S0, P = k1_stride(C), k1_stride(Cin), L + K - 1
    Kc, Kc0 = _cdiv(K * S, 8) * 8, _cdiv(K * S0, 8) * 8
    mtiles = _cdiv(R * P - (K - 1), 16 * K1_WM) * K1_WM
    ngroups = _cdiv(_cdiv(C, 8), K1_WN)
    NW = ngroups * K1_WN * 8
    # the last A row starts at (16*mtiles - 1)*S and spans Kc values
    rows_alloc = 16 * mtiles - 1 + _cdiv(Kc, S)
    rows_alloc0 = 16 * mtiles - 1 + _cdiv(Kc0, S0)
    # the longest weight chunk whose ring fits beside the buffers and biases:
    # fewer barriers (at the bench's shape 64 columns took 2-5 % less time than
    # 32 on an NVIDIA H100 80GB HBM3 at 700.00 W, cli/k1_variants.py)
    fixed = 4 * (rows_alloc * S + rows_alloc0 * S0 + num_layer * NW)
    kch = next((k for k in (64, 32, 16)
                if fixed + 4 * K1_STAGES * NW * (k + 4) <= SMEM_LIMIT), 8)
    return K1Plan(L, Cin, C, K, num_layer, R, P, S, S0, NW, kch + 4, Kc, Kc0, mtiles,
                  ngroups, kch, rows_alloc, rows_alloc0)


@functools.lru_cache(maxsize=256)
def k1_plan(B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
            n_sm: int) -> Optional[K1Plan]:
    """K1's layout for a call on a card of `n_sm` SMs, or None when not even
    one row of length L fits in a block: then the wrapper windows the time
    axis. Of the layouts that fit (at most B rows a block), those
    that need the fewest rounds of blocks over the SMs (one block on an SM at
    a time), and of these the one with the fewest rows. At the bench's shape
    on 132 SMs: two rows for B=500, three for B=2000 and 334, one for B=64."""
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
    ngroups = _cdiv(_cdiv(C, 8), K1_WN)
    L = 16 * K1_WM * (K1_MAX_WARPS // ngroups)   # as many rows as the warps cover
    while L > 0 and not k1_layout(L, Cin, C, K, num_layer, 1).fits():
        L -= 1
    return L


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
    return idx_in.to(device), idx_out.to(device), rows


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


def pack_weights(layers: Layers, plan: K1Plan):
    """Weights in K1's layout, n-major: W'[c, k*S + ci] = W[c, ci, k] in f32,
    zero where ci >= C or c >= C and in the columns from K*S up to Kc (S0 and
    Kc0 for layer 0); biases f32, zero beyond C.

    Returns (w0 (NW, Kc0), b0 (NW,), wr (nl-1, NW, Kc), br (nl-1, NW)); wr
    and br are None for one layer."""
    C, Cin, K = layers[0]['w'].shape
    NW, nl, dev = plan.NW, len(layers), layers[0]['w'].device

    def packed(ws, stride, cols, cin):   # n x (C, cin, K) -> (n, NW, cols)
        out = torch.zeros((len(ws), NW, cols), dtype=torch.float32, device=dev)
        taps = out[:, :, :K * stride].view(len(ws), NW, K, stride)
        taps[:, :C, :, :cin] = torch.stack(ws).permute(0, 1, 3, 2)
        return out

    b = torch.zeros((nl, NW), dtype=torch.float32, device=dev)
    b[:, :C] = torch.stack([p['b'] for p in layers])
    w0 = packed([layers[0]['w']], plan.S0, plan.Kc0, Cin)[0]
    if nl == 1:
        return w0, b[0], None, None
    wr = packed([p['w'] for p in layers[1:]], plan.S, plan.Kc, C)
    return w0, b[0], wr, b[1:]


@functools.lru_cache(maxsize=64)
def _k2_gather(Cin: int, C: int, K: int, nl: int, N: int, ngroups: int, S: int, S0: int,
               Kc: int, Kc0: int, device: str):
    """Indices that pack a stack into K2's layout in one gather from
    flat = cat(w_0, ..., w_{nl-1} flattened, b_0, ..., b_{nl-1}, [0]).

    Weights: layer l's W'[k*S + ci, c] = W_l[c, ci, k] (S0 for layer 0), the
    last index (a zero) where ci >= cin, c >= C or k >= K*S, cut into column
    groups of N and chunks of 64 rows; chunk (g, c) holds W'[64c:64c+64,
    gN:gN+N] in wgmma's K-major 128-byte-swizzle layout, value (k, n) at
    (n//8)*512 + (n%8)*64 + ((k//8) ^ (n%8))*8 + k%8. Returns (idx_w, the
    layers' chunks one after another; idx_b (nl, ngroups*N), zero beyond C)."""
    cins = [Cin] + [C] * (nl - 1)
    offs = [sum(C * ci * K for ci in cins[:i]) for i in range(nl + 1)]
    zero = offs[-1] + nl * C
    q = torch.arange(N * K2_CHUNK)
    n = torch.arange(ngroups).view(-1, 1, 1) * N + (q // 512 * 8 + q // 64 % 8)
    k_in = (q // 8 % 8 ^ q // 64 % 8) * 8 + q % 8
    idx_w = []
    for i, (cin, stride, Kl) in enumerate(zip(cins, [S0] + [S] * (nl - 1),
                                              [Kc0] + [Kc] * (nl - 1))):
        k = torch.arange(_cdiv(Kl, K2_CHUNK)).view(1, -1, 1) * K2_CHUNK + k_in
        tap, ci = k // stride, k % stride
        src = offs[i] + n * cin * K + ci * K + tap
        idx_w.append(torch.where((tap < K) & (ci < cin) & (n < C), src, zero).reshape(-1))
    nb = torch.arange(ngroups * N)
    idx_b = torch.stack([torch.where(nb < C, offs[-1] + i * C + nb, zero) for i in range(nl)])
    return torch.cat(idx_w).to(device), idx_b.to(device)


@functools.lru_cache(maxsize=16)
def _zero(device: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(1, dtype=dtype, device=device)


def pack_weights_bf16(layers: Layers, plan: K2Plan):
    """Weights in K2's layout (`_k2_gather`): bf16 chunks of 64 rows of W'
    and N columns in wgmma's swizzled layout; biases f32, zero beyond C.
    One concatenation and two gathers, whatever the depth: each op is a
    launch on the host's clock, and the wrapper packs at every call.

    Returns (w0 (ngroups, ceil(Kc0/64), N*64), b0 (ngroups*N,), wr (nl-1,
    ngroups, ceil(Kc/64), N*64), br (nl-1, ngroups*N)), views of one
    buffer each; wr and br are None for one layer."""
    C, Cin, K = layers[0]['w'].shape
    nl, dev = len(layers), layers[0]['w'].device
    idx_w, idx_b = _k2_gather(Cin, C, K, nl, plan.N, plan.ngroups, plan.S, plan.S0, plan.Kc,
                              plan.Kc0, str(dev))
    parts = [p['w'].reshape(-1) for p in layers] + [p['b'].reshape(-1) for p in layers]
    flat = torch.cat(parts + [_zero(str(dev), parts[0].dtype)])
    w, b = flat[idx_w].to(torch.bfloat16), flat[idx_b].float()
    n0 = plan.ngroups * _cdiv(plan.Kc0, K2_CHUNK) * plan.N * K2_CHUNK
    w0 = w[:n0].view(plan.ngroups, -1, plan.N * K2_CHUNK)
    if nl == 1:
        return w0, b[0], None, None
    return w0, b[0], w[n0:].view(nl - 1, plan.ngroups, -1, plan.N * K2_CHUNK), b[1:]


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


def _checked(name: str, layers: Layers, x: torch.Tensor):
    """(B, L, Cin, C, K) of a call on x's CUDA device, or ValueError."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name} runs on cuda or cpu, got {x.device}')
    if x.dim() != 3:
        raise ValueError(f'x must be (B, L, Cin), got shape {tuple(x.shape)}')
    B, L, Cin = x.shape
    C, K = _check_layers(layers, Cin)
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


def _launch_f32(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Checks, plans, packs and launches K1; windows the time axis first when
    one batch row does not fit in a block."""
    B, L, Cin, C, K = _checked('conv_stack_f32', layers, x)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = k1_plan(B, L, Cin, C, K, len(layers), n_sm)
    if plan is None:
        return run_windowed(conv_stack_f32, layers, x, k1_max_rows(Cin, C, K, len(layers)))
    w0, b0, wr, br = pack_weights(layers, plan)
    xc = x.float().contiguous()
    out = torch.empty((B, L, C), dtype=torch.float32, device=x.device)
    if B == 0 or L == 0:
        return out
    for t in (w0, wr):   # cp.async copies the weights 16 bytes at a time
        if t is not None and t.data_ptr() % 16:
            raise ValueError('conv_stack_f32 needs 16-byte aligned weights')
    ints = plan.as_ints()
    _run('conv_stack_f32', x, xc.data_ptr(), w0.data_ptr(), b0.data_ptr(), _ptr(wr),
         _ptr(br), out.data_ptr(), B, (ctypes.c_int * len(ints))(*ints), len(ints))
    conv_stack_f32.launches += 1
    return out


def _launch_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Checks, plans, packs and launches K2; windows the time axis first when
    one batch row does not fit in a block."""
    B, L, Cin, C, K = _checked('conv_stack_bf16', layers, x)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = k2_plan(B, L, Cin, C, K, len(layers), n_sm)
    if plan is None:
        return run_windowed(conv_stack_bf16, layers, x, k2_max_rows(Cin, C, K, len(layers)))
    w0, b0, wr, br = pack_weights_bf16(layers, plan)
    xc = x.to(torch.bfloat16).contiguous()
    out = torch.empty((B, L, C), dtype=torch.bfloat16, device=x.device)
    if B == 0 or L == 0:
        return out
    for t in (w0, wr):   # the bulk copies move 16-byte units
        if t is not None and t.data_ptr() % 16:
            raise ValueError('conv_stack_bf16 needs 16-byte aligned weights')
    ints = plan.as_ints()
    _run('conv_stack_bf16', x, xc.data_ptr(), w0.data_ptr(), b0.data_ptr(), _ptr(wr),
         _ptr(br), out.data_ptr(), B, (ctypes.c_int * len(ints))(*ints), len(ints))
    conv_stack_bf16.launches += 1
    return out


def conv_stack_f32(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K1's wrapper: (B, L, Cin) -> (B, L, C) f32."""
    if x.device.type == 'cpu':
        return conv_stack_f32_plain(layers, x)
    return _launch_f32(layers, x)


def conv_stack_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K2's wrapper: (B, L, Cin) -> (B, L, C) bf16."""
    if x.device.type == 'cpu':
        return conv_stack_bf16_plain(layers, x)
    return _launch_bf16(layers, x)


conv_stack_f32.launches = 0
conv_stack_bf16.launches = 0


class _RecomputeStack(torch.autograd.Function):
    """Forward through a kernel; backward recomputes the unfused f32 stack
    (JAX conv_stack.py:288-298, 318-326), the cotangent cast to f32. Only
    the inputs that need a gradient get one."""

    @staticmethod
    def forward(ctx, kernel, x, n_layers, *flat):
        layers = [{'w': flat[2 * i], 'b': flat[2 * i + 1]} for i in range(n_layers)]
        ctx.n_layers = n_layers
        ctx.save_for_backward(x, *flat)
        return kernel(layers, x)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        need = [ctx.needs_input_grad[1], *ctx.needs_input_grad[3:]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip([x, *flat], need)]
            x, *flat = inputs
            layers = [{'w': flat[2 * i], 'b': flat[2 * i + 1]}
                      for i in range(ctx.n_layers)]
            out = stack_apply(layers, x.float())
            grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad],
                                             g.to(out.dtype)))
        x_grad, *w_grads = [next(grads) if n else None for n in need]
        return (None, x_grad, None, *w_grads)


def _fused(kernel, layers: Layers, x: torch.Tensor) -> torch.Tensor:
    flat = [t for p in layers for t in (p['w'], p['b'])]
    return _RecomputeStack.apply(kernel, x, len(layers), *flat)


def fused_stack_apply(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K1 forward, f32 out; gradients of the unfused f32 stack."""
    return _fused(conv_stack_f32, layers, x)


def fused_stack_apply_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K2 forward, bf16 out; gradients of the unfused f32 stack."""
    return _fused(conv_stack_bf16, layers, x)


def conv_stack_work(B: int, L: int, Cin: int, C: int, K: int, num_layer: int,
                    itemsize: int):
    """(FLOP, bytes) one call needs: x, weights and output of `itemsize`
    bytes each read or written once, f32 biases; no intermediate activation."""
    macs = B * L * (K * Cin * C + (num_layer - 1) * K * C * C)
    n_w = K * Cin * C + (num_layer - 1) * K * C * C
    nbytes = (B * L * Cin + n_w + B * L * C) * itemsize + num_layer * C * 4
    return 2 * macs, nbytes

