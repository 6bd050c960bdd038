"""Fused same-length Conv1d stacks: the ports of the Pallas kernels K1 and K2.

  - K1, `conv_stack_f32`, replaces `turboae_tpu/kernels/conv_stack.py::
    _fused_forward` (Pallas body `_stack_kernel`, exposed as
    `fused_stack_apply`). CUDA source `csrc/conv_stack_f32.cu`. Every layer is
    ELU(sum_k h[l + k - K//2] @ W[k] + b) with zero padding, in f32 throughout:
    no bf16 rounding and no TF32 anywhere.
  - K2, `conv_stack_bf16`, replaces `_fused_forward_im2col` (Pallas body
    `_stack_kernel_im2col`, exposed as `fused_stack_apply_bf16`). CUDA source
    `csrc/conv_stack_bf16.cu`. x is rounded to bf16; bf16 operands, f32
    accumulation, f32 bias and ELU, bf16 between layers and at the output.

`build.py` compiles each source with nvcc for sm_90a; it is called through
ctypes. For each kernel:
  - `conv_stack_<t>(layers, x)` is the wrapper. On a CUDA tensor it launches
    the kernel or raises; on a CPU tensor it runs the plain version.
    `conv_stack_<t>.launches` counts the kernel's launches.
  - `conv_stack_<t>_plain(layers, x)` is the plain PyTorch version: K shifted
    matmuls per layer. K2's multiplies bf16-rounded operands in f32 and rounds
    to bf16 after every layer; it never uses a bf16 matmul, which would round
    the sum before the bias add.
  - `fused_stack_apply[_bf16](layers, x)` is the differentiable entry point:
    its backward recomputes through the unfused f32 stack, as the JAX
    package's `_bwd` and `_bwd_bf16` do. Neither Pallas kernel has a backward
    kernel, so neither port has one.

Long blocks: a kernel keeps a batch row's activations in shared memory, two
(L+K-1, C) buffers. Where those exceed what one thread block may use, the
wrapper cuts the time axis into overlapping windows (`run_windowed`) and
launches once over all of them; the output is the same.

`layers` is a list of {'w': (C, Cin, K), 'b': (C,)} in PyTorch's layout.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from ..ops.conv1d import stack_apply
from . import build

# each library is named after its wrapper: csrc/<name>.cu exports <name>_launch
LIBRARIES = ('conv_stack_bf16', 'conv_stack_f32')
# shared memory one thread block can use on sm_90 (227 KB)
SMEM_LIMIT = 232448

Layers = List[Dict[str, torch.Tensor]]


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, f'{name}_launch')
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(L: int, C: int, K: int, num_layer: int, itemsize: int = 2) -> int:
    """Dynamic shared memory of one thread block: two (L+K-1, C) buffers of
    `itemsize`-byte values (2 for K2, 4 for K1); none for one layer."""
    return 2 * (L + K - 1) * C * itemsize if num_layer > 1 else 0


def max_rows(C: int, K: int, itemsize: int) -> int:
    """The longest time axis whose two buffers fit in SMEM_LIMIT."""
    return SMEM_LIMIT // (2 * C * itemsize) - (K - 1)


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
        raise ValueError(f'a window of {rows} rows, the most that shared memory '
                         f'holds, keeps no row beside its halo of {halo} on each side')
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


def pack_weights(layers: Layers, dtype=torch.bfloat16):
    """Weights in the kernels' layout, taps folded into the contraction.

    Returns (w0, b0, wr, br, Cp): w0 (K*Cin, Cp) in `dtype`, b0 (Cp,) f32,
    wr (nl-1, K*C, Cp) in `dtype` and br (nl-1, Cp) f32 (None for one layer),
    with Cp = C rounded up to 4 and the extra columns zero."""
    C, _, K = layers[0]['w'].shape
    Cp = (C + 3) // 4 * 4

    def w_packed(w):   # (C, Cin, K) -> (K*Cin, Cp), row k*Cin + ci
        wt = w.permute(2, 1, 0).reshape(-1, C).to(dtype)
        return F.pad(wt, (0, Cp - C))

    def b_packed(b):
        return F.pad(b.float(), (0, Cp - C))

    w0 = w_packed(layers[0]['w']).contiguous()
    b0 = b_packed(layers[0]['b']).contiguous()
    if len(layers) == 1:
        return w0, b0, None, None, Cp
    wr = torch.stack([w_packed(p['w']) for p in layers[1:]]).contiguous()
    br = torch.stack([b_packed(p['b']) for p in layers[1:]]).contiguous()
    return w0, b0, wr, br, Cp


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


def _launch(wrapper, dtype: torch.dtype, layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """Checks, packs and launches one kernel on x's CUDA device; windows the
    time axis first when a block's buffers would not fit in shared memory."""
    name = wrapper.__name__          # also the name of its library
    if x.device.type != 'cuda':
        raise ValueError(f'{name} runs on cuda or cpu, got {x.device}')
    if x.dim() != 3:
        raise ValueError(f'x must be (B, L, Cin), got shape {tuple(x.shape)}')
    B, L, Cin = x.shape
    C, K = _check_layers(layers, Cin)
    for p in layers:
        if p['w'].device != x.device or p['b'].device != x.device:
            raise ValueError('weights and x must be on the same device')
    itemsize = torch.finfo(dtype).bits // 8
    if smem_bytes(L, C, K, len(layers), itemsize) > SMEM_LIMIT:
        return run_windowed(wrapper, layers, x, max_rows(C, K, itemsize))
    w0, b0, wr, br, Cp = pack_weights(layers, dtype)
    xc = x.to(dtype).contiguous()
    out = torch.empty((B, L, C), dtype=dtype, device=x.device)
    if B == 0 or L == 0:
        return out
    align = 4 * itemsize   # the kernels read weights 4 values at a time
    for t in (w0, wr):
        if t is not None and t.data_ptr() % align:
            raise ValueError(f'{name} needs {align}-byte aligned weights')
    lib = _library(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, f'{name}_launch')(
            xc.data_ptr(), w0.data_ptr(), b0.data_ptr(),
            None if wr is None else wr.data_ptr(),
            None if br is None else br.data_ptr(), out.data_ptr(),
            B, L, Cin, C, Cp, K, len(layers), stream)
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')
    wrapper.launches += 1
    return out


def conv_stack_f32(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K1's wrapper: (B, L, Cin) -> (B, L, C) f32."""
    if x.device.type == 'cpu':
        return conv_stack_f32_plain(layers, x)
    return _launch(conv_stack_f32, torch.float32, layers, x)


def conv_stack_bf16(layers: Layers, x: torch.Tensor) -> torch.Tensor:
    """K2's wrapper: (B, L, Cin) -> (B, L, C) bf16."""
    if x.device.type == 'cpu':
        return conv_stack_bf16_plain(layers, x)
    return _launch(conv_stack_bf16, torch.bfloat16, layers, x)


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

