"""K4, `gru_bf16`: one bidirectional GRU layer in bf16, all its steps in
one launch, on Hopper's warpgroup tensor cores (CUDA source
`csrc/gru_bf16.cu` on `csrc/hopper.cuh`). It replaces no Pallas kernel: the
JAX package runs the recurrence as a `lax.scan`
(turboae_tpu/ops/gru.py:_gru_scan). ops/gru.py routes a GRU layer to it on
the card in bf16 inference (`route`).

A block holds 32 batch rows of one direction and walks the L steps itself,
with W_hh and W_ih in its shared memory, h's f32 carry in registers and its
bf16 copy in shared memory, so no step goes through device memory but x's
rows in and the step's output out. The arithmetic is ops/gru.py:_scan's
under compute_dtype bf16: operands rounded to bf16, f32 accumulation, f32
bias adds, gate math and carry. The products of r and of z are summed in
one accumulator and the biases added after them; sigmoid and tanh go
through e (`gru_bf16_plain` repeats it all in that order). The wrapper pads
x's channels to a multiple of 8 (16 bytes) in bf16.

  - `gru_bf16(layer, x, out_f32)` is the wrapper, (B, L, In) -> (B, L, 2H)
    in f32 or bf16. On a CUDA tensor it launches the kernel or raises; on a
    CPU tensor it runs the plain version. `gru_bf16.launches` counts its
    launches; `.pack_hits` and `.pack_misses` the lookups of its packed
    weights, which it keeps in kernels/conv_stack.py's cache (`packed`),
    keyed by the plan's KX.
  - `launch_alone(layer, x, out_f32)` packs once and returns the launch
    alone, for timing the kernel without the packing.
  - `pack_gru_bf16(layer, plan)` packs a layer: per direction W_hh' and
    W_ih' in wgmma's K-major layout without swizzle, and the biases.
  - `gru_bf16_plain(layer, x, out_f32)` is the plain PyTorch version, on
    x's device; it reads the packed planes by the kernel's address
    arithmetic.
  - `fits(In, H)`: whether a layer's widths fit a block (GRU_H, GRU_IN).

Spans (utils/logging.py:span): `k4` the wrapper's call; inside it `k4.pack`
(the packed weights, the input's cast, the output's allocation), within
that `k4.pack.weights` (a pack the cache did not serve); and `k4.launch`.

`layer` is {'fwd': dir, 'bwd': dir}, dir = {'w_ih': (3H, In), 'w_hh': (3H,
H), 'b_ih': (3H,), 'b_hh': (3H,)}, ops/gru.py's layout.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..utils.logging import span
from . import conv_stack as ks

GRU_N = 104            # a gate's columns: H padded to 13 groups of 8 (NH)
GRU_H = GRU_N          # the widest hidden state a block holds
GRU_KH = 112           # contraction rows of the h products: H padded to 7 k16 steps
GRU_ROWS = 32          # batch rows a block: half an m64 tile's rows (ROWS)
GRU_KX = (1, 13)       # k16 steps of the x products: In <= 16, or In <= 208
GRU_IN = 16 * GRU_KX[-1]   # the widest input a block holds
_NCOL = 3 * GRU_N      # r, z, n side by side
_DIRS = ('fwd', 'bwd')
_KEYS = ('w_ih', 'w_hh', 'b_ih', 'b_hh')

Layer = Dict[str, Dict[str, torch.Tensor]]


def fits(In: int, H: int) -> bool:
    """Whether a layer of In inputs and H units fits K4's block (its shared
    memory: W_hh' of 112 x 312, W_ih' of up to 208 x 312)."""
    return 1 <= H <= GRU_H and 1 <= In <= GRU_IN


@dataclass(frozen=True)
class GruPlan(ks._Plan):
    """K4's launch (struct Plan in gru_bf16.cu, field for field): G = ceil(B /
    32) blocks a direction; KX k16 steps of the x products; out_f32 1 for an
    f32 output, 0 for bf16."""
    L: int
    In: int
    H: int
    KX: int
    G: int
    out_f32: int

    @property
    def kx(self) -> int:
        """Contraction rows of the x products: In padded to whole k16 steps."""
        return 16 * self.KX

    @property
    def xs(self) -> int:
        """Channels of x as the kernel reads it: In padded to 8 (16 bytes)."""
        return -(-self.In // 8) * 8


def gru_plan(B: int, L: int, In: int, H: int, out_f32: bool) -> GruPlan:
    KX = next(k for k in GRU_KX if In <= 16 * k)
    return GruPlan(L, In, H, KX, ks._cdiv(B, GRU_ROWS), int(out_f32))


def packed_bytes(In: int) -> int:
    """Bytes of a layer's packed planes: both directions' bf16 weights and
    f32 biases."""
    kx = gru_plan(1, 1, In, 1, True).kx
    return 2 * (2 * _NCOL * (GRU_KH + kx) + 4 * 4 * GRU_N)


# ---------------------------------------------------------------- packing
@functools.lru_cache(maxsize=1)
def _units() -> torch.Tensor:
    """The hidden unit that each of a gate's 104 columns holds. Column C0 +
    8j + 2q + e of a warpgroup (C0 = 0 for its first 56 columns, 56 for the
    last 48; group j, lane q of a quad) holds unit C0 + 16 (j//2) + 4q + 2
    (j%2) + e, or C0 + 8j + 2q + e in a last group without a pair, so that a
    thread's units of a pair of groups are four contiguous ones."""
    out = []
    for c0, n in ((0, 56), (56, 48)):
        groups = n // 8
        for c in range(n):
            j, q, e = c // 8, c % 8 // 2, c % 2
            paired = j < groups - groups % 2
            out.append(c0 + (16 * (j // 2) + 4 * q + 2 * (j % 2) + e if paired else c))
    return torch.tensor(out)


def _at(k: torch.Tensor, n: torch.Tensor, kp: int) -> torch.Tensor:
    """The value index of element (k, n) of a K-major operand of kp
    contraction rows without swizzle, as the kernel's descriptors read it:
    core matrices of 8 columns by 8 k (128 bytes), kp/8 of them a group of 8
    columns, byte ((n/8) * kp/8 + k/8) * 128 + (n%8) * 16 + (k%8) * 2."""
    return ((n // 8) * (kp // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8


@functools.lru_cache(maxsize=16)
def _gru_gather(In: int, H: int, kx: int, device: str):
    """Indices that pack a layer from flat = cat(fwd's w_ih, w_hh, b_ih,
    b_hh flattened, then bwd's, [0]): (idx_w (2, 312 (112 + kx)), each
    direction's W_hh' then W_ih', element (k, n) of W' = W[g H + u(n'), ch]
    for column n = 104 g + n' (u = `_units`), ch = u(k) in W_hh' (h's copy
    holds its units in column order) and k in W_ih', the zero past H units
    or the layer's inputs; idx_bi, idx_bh (2, 3, 104): b_ih and b_hh by gate
    and unit, zero past H)."""
    G = 3 * H
    per = G * In + G * H + 2 * G                 # values of one direction
    zero = 2 * per
    units = _units()

    def operand(kp: int, off: int, width: int, ch: torch.Tensor) -> torch.Tensor:
        k = torch.arange(kp).view(-1, 1)
        n = torch.arange(_NCOL).view(1, -1)
        g, j = n // GRU_N, units[n % GRU_N]
        ch = ch.view(-1, 1)
        src = torch.where((j < H) & (ch < width), off + (g * H + j) * width + ch, zero)
        out = torch.empty(_NCOL * kp, dtype=torch.long)
        out[_at(k, n, kp).reshape(-1)] = src.reshape(-1)
        return out
    hh_ch = torch.cat([units, torch.full((GRU_KH - GRU_N,), GRU_KH)])   # past 104: none
    one = torch.cat([operand(GRU_KH, G * In, H, hh_ch), operand(kx, 0, In, torch.arange(kx))])
    idx_w = torch.stack([torch.where(one < zero, one + d * per, one) for d in (0, 1)])
    j = torch.arange(GRU_N).view(1, -1)
    g = torch.arange(3).view(-1, 1)

    def bias(off: int) -> torch.Tensor:
        return torch.stack([torch.where(j < H, d * per + off + g * H + j, zero)
                            for d in (0, 1)])
    return (idx_w.to(device), bias(G * (In + H)).to(device),
            bias(G * (In + H) + G).to(device))


def pack_gru_bf16(layer: Layer, plan: GruPlan):
    """A layer in K4's layout (`_gru_gather`): w (2, 312 (112 + kx)) bf16,
    each direction's W_hh' then W_ih' (the kernel's shared-memory image);
    b (2, 4, 104) f32: b_ir + b_hr, b_iz + b_hz, b_in, b_hn, zero past H."""
    parts = [layer[d][k].reshape(-1) for d in _DIRS for k in _KEYS]
    dev = str(parts[0].device)
    flat = torch.cat(parts + [ks._zero(dev, parts[0].dtype)])
    idx_w, idx_bi, idx_bh = _gru_gather(plan.In, plan.H, plan.kx, dev)
    bi, bh = flat[idx_bi].float(), flat[idx_bh].float()
    b = torch.cat([bi[:, :2] + bh[:, :2], bi[:, 2:], bh[:, 2:]], dim=1)
    return flat[idx_w].to(torch.bfloat16), b


# ---------------------------------------------------------------- plain
def _sigm(v: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(torch.clamp(-v, max=80.0)))


def _tanh(v: torch.Tensor) -> torch.Tensor:
    return 1.0 - 2.0 / (1.0 + torch.exp(torch.clamp(2.0 * v, max=80.0)))


def _operand(w: torch.Tensor, kp: int) -> torch.Tensor:
    """The (kp, 312) f32 matrix W' that the kernel's descriptors read from
    the packed values w (one operand of one direction)."""
    k = torch.arange(kp).view(-1, 1)
    n = torch.arange(_NCOL).view(1, -1)
    return w[_at(k, n, kp).to(w.device)].float()


def gru_bf16_plain(layer: Layer, x: torch.Tensor, out_f32: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K4, on x's device: (B, L, In) -> (B, L, 2H),
    f32 or bf16. Each direction from its packed planes, in the kernel's
    column order (`_units`): per step the x and h products of bf16 operands
    in f32 (r's and z's summed), then the biases, sigmoid and tanh through
    e, the f32 carry h = n + z (h - n), units past H held at 0."""
    B, L, In = x.shape
    H = layer['fwd']['w_hh'].shape[1]
    plan = gru_plan(B, L, In, H, out_f32)
    w, b = pack_gru_bf16(layer, plan)
    units = _units().to(x.device)
    xq = F.pad(x.detach().to(torch.bfloat16).float(), (0, plan.kx - In))
    live = units < H
    outs = []
    for d in (0, 1):
        whh, wih = _operand(w[d], GRU_KH), _operand(w[d, _NCOL * GRU_KH:], plan.kx)
        br, bz, bi, bn = b[d][:, units]
        h = torch.zeros((B, GRU_N), device=x.device)
        o = torch.zeros((B, L, GRU_N), device=x.device)
        for t in (range(L - 1, -1, -1) if d else range(L)):
            gx = xq[:, t] @ wih
            gh = F.pad(h.to(torch.bfloat16).float(), (0, GRU_KH - GRU_N)) @ whh
            r = _sigm(gx[:, :GRU_N] + gh[:, :GRU_N] + br)
            z = _sigm(gx[:, GRU_N:2 * GRU_N] + gh[:, GRU_N:2 * GRU_N] + bz)
            n = _tanh(gx[:, 2 * GRU_N:] + bi + r * (gh[:, 2 * GRU_N:] + bn))
            h = torch.where(live, n + z * (h - n), 0.0)
            o[:, t, units] = h
        outs.append(o[..., :H])
    out = torch.cat(outs, dim=-1)
    return out if out_f32 else out.to(torch.bfloat16)


# ---------------------------------------------------------------- the card
def _checked(layer: Layer, x: torch.Tensor):
    """(B, L, In, H) of a call on x's CUDA device, or ValueError."""
    if x.device.type != 'cuda':
        raise ValueError(f'gru_bf16 runs on cuda or cpu, got {x.device}')
    if x.dim() != 3:
        raise ValueError(f'x must be (B, L, In), got shape {tuple(x.shape)}')
    B, L, In = x.shape
    H = layer['fwd']['w_hh'].shape[1]
    want = {'w_ih': (3 * H, In), 'w_hh': (3 * H, H), 'b_ih': (3 * H,), 'b_hh': (3 * H,)}
    for d in _DIRS:
        for k, s in want.items():
            t = layer[d][k]
            if tuple(t.shape) != s:
                raise ValueError(f'gru layer {d} {k}: {tuple(t.shape)}, expected {s}')
            if t.device != x.device:
                raise ValueError('weights and x must be on the same device')
    if not fits(In, H):
        raise ValueError(f'gru_bf16 holds H <= {GRU_H} and In <= {GRU_IN}, got H={H}, '
                         f'In={In}')
    return B, L, In, H


def _prepared(layer: Layer, x: torch.Tensor, out_f32: bool) -> Callable[[], torch.Tensor]:
    """Packs the weights (`packed`) and x once; returns call(), which
    launches K4 on them, counts the launch and returns the output (one
    tensor, written anew by each call)."""
    B, L, In, H = _checked(layer, x)
    plan = gru_plan(B, L, In, H, out_f32)
    with span('k4.pack'):
        w, b = ks.packed(gru_bf16, [layer], plan)
        if (w.data_ptr() | b.data_ptr()) % 16:
            raise ValueError('gru_bf16 needs 16-byte aligned weights')
        if In == plan.xs:
            xc = x.to(torch.bfloat16).contiguous()
        else:
            xc = torch.zeros((B, L, plan.xs), dtype=torch.bfloat16, device=x.device)
            xc[..., :In] = x
        out = torch.empty((B, L, 2 * H), dtype=torch.float32 if out_f32 else torch.bfloat16,
                          device=x.device)
        ints = plan.as_ints()
        args = (xc.data_ptr(), w.data_ptr(), b.data_ptr(), None, None, out.data_ptr(), B,
                (ctypes.c_int * len(ints))(*ints), len(ints))

    def call():
        if not (B and L):
            return out
        with span('k4.launch'):
            ks._run('gru_bf16', x, *args)
            gru_bf16.launches += 1
        return out
    call.tensors = (w, b, xc)      # alive while call is
    return call


def gru_bf16(layer: Layer, x: torch.Tensor, out_f32: bool = True) -> torch.Tensor:
    """K4's wrapper: one bidirectional GRU layer, (B, L, In) -> (B, L, 2H),
    f32 (`out_f32`) or bf16, the reverse direction's outputs in input order."""
    with span('k4'):
        if x.device.type == 'cpu':
            return gru_bf16_plain(layer, x, out_f32)
        return _prepared(layer, x, out_f32)()


def launch_alone(layer: Layer, x: torch.Tensor, out_f32: bool = True) -> Callable[[], torch.Tensor]:
    """K4's launch for (layer, x) on weights packed once, for timing it
    without the packing; each call counts as a launch."""
    return _prepared(layer, x, out_f32)


gru_bf16.launches = gru_bf16.pack_hits = gru_bf16.pack_misses = 0
ks._SPECS['gru_bf16'] = ks._Spec(
    None, None, lambda layers, plan: pack_gru_bf16(layers[0], plan), torch.bfloat16, 'k4',
    None, lambda p: (p.KX,), lambda layers: [l[d][k] for l in layers for d in _DIRS
                                              for k in _KEYS])
