"""Fused bf16 same-length Conv1d stack: the port of the Pallas kernel K2.

Replaces `turboae_tpu/kernels/conv_stack.py::_fused_forward_im2col` (the
Pallas kernel `_stack_kernel_im2col`, exposed as `fused_stack_apply_bf16`).
The CUDA source is `csrc/conv_stack_bf16.cu`; `build.py` compiles it with
nvcc for sm_90a and it is called through ctypes.

What the stack computes: x (B, L, Cin) is rounded to bf16; each layer is
ELU(sum_k h[l + k - K//2] @ W[k] + b) with zero padding, bf16 operands, f32
accumulation, f32 bias and ELU, and bf16 between layers and at the output.

  - `conv_stack_bf16(layers, x)` is the kernel's wrapper. On a CUDA tensor it
    launches the kernel or raises; on a CPU tensor it runs the plain version.
    `conv_stack_bf16.launches` counts the kernel's launches.
  - `conv_stack_bf16_plain(layers, x)` is the plain PyTorch version: bf16-
    rounded operands multiplied in f32, K shifted matmuls per layer, rounded
    to bf16 after every layer. It never uses a bf16 matmul, which would round
    the sum before the bias add.
  - `fused_stack_apply_bf16(layers, x)` is the differentiable entry point:
    its backward recomputes through the unfused f32 stack, as the JAX
    package's `_bwd_bf16` does.

`layers` is a list of {'w': (C, Cin, K), 'b': (C,)} in PyTorch's layout.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..ops.conv1d import stack_apply
from . import build

LIBRARY = 'conv_stack_bf16'
# shared memory one thread block can use on sm_90 (227 KB)
SMEM_LIMIT = 232448


def _library() -> ctypes.CDLL:
    lib = build.load(LIBRARY)
    fn = lib.conv_stack_bf16_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(L: int, C: int, K: int, num_layer: int) -> int:
    """Dynamic shared memory of one thread block: two bf16 (L+K-1, C) buffers."""
    return 2 * (L + K - 1) * C * 2 if num_layer > 1 else 0


def _check_layers(layers: List[Dict[str, torch.Tensor]], cin: int):
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


def pack_weights(layers: List[Dict[str, torch.Tensor]]):
    """Weights in the kernel's layout, taps folded into the contraction.

    Returns (w0, b0, wr, br, Cp): w0 (K*Cin, Cp) bf16, b0 (Cp,) f32,
    wr (nl-1, K*C, Cp) bf16 and br (nl-1, Cp) f32 (None for one layer), with
    Cp = C rounded up to 4 and the extra columns zero."""
    C, _, K = layers[0]['w'].shape
    Cp = (C + 3) // 4 * 4

    def w_packed(w):   # (C, Cin, K) -> (K*Cin, Cp), row k*Cin + ci
        wt = w.permute(2, 1, 0).reshape(-1, C).to(torch.bfloat16)
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


def conv_stack_bf16_plain(layers: List[Dict[str, torch.Tensor]],
                          x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, L, Cin) -> (B, L, C) bf16."""
    L = x.shape[1]
    h = x.to(torch.bfloat16).float()
    for p in layers:
        w = p['w'].to(torch.bfloat16).float()          # (C, Cin, K)
        K = w.shape[2]
        pad = K // 2
        hp = F.pad(h, (0, 0, pad, K - 1 - pad))        # zero-pad the time axis
        acc = sum(torch.matmul(hp[:, k:k + L, :], w[:, :, k].t()) for k in range(K))
        h = F.elu(acc + p['b'].float()).to(torch.bfloat16).float()
    return h.to(torch.bfloat16)


def conv_stack_bf16(layers: List[Dict[str, torch.Tensor]],
                    x: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: (B, L, Cin) -> (B, L, C) bf16."""
    if x.device.type == 'cpu':
        return conv_stack_bf16_plain(layers, x)
    if x.device.type != 'cuda':
        raise ValueError(f'conv_stack_bf16 runs on cuda or cpu, got {x.device}')
    if x.dim() != 3:
        raise ValueError(f'x must be (B, L, Cin), got shape {tuple(x.shape)}')
    B, L, Cin = x.shape
    C, K = _check_layers(layers, Cin)
    for p in layers:
        if p['w'].device != x.device or p['b'].device != x.device:
            raise ValueError('weights and x must be on the same device')
    smem = smem_bytes(L, C, K, len(layers))
    if smem > SMEM_LIMIT:
        raise ValueError(f'L={L}, C={C}, K={K} needs {smem} bytes of shared '
                         f'memory per block; the limit is {SMEM_LIMIT}')
    w0, b0, wr, br, Cp = pack_weights(layers)
    xb = x.to(torch.bfloat16).contiguous()
    out = torch.empty((B, L, C), dtype=torch.bfloat16, device=x.device)
    if B == 0 or L == 0:
        return out
    for t in (w0, wr):     # the kernel reads weights 4 bf16 (8 bytes) at a time
        if t is not None and t.data_ptr() % 8:
            raise ValueError('conv_stack_bf16 needs 8-byte aligned weights')
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.conv_stack_bf16_launch(
            xb.data_ptr(), w0.data_ptr(), b0.data_ptr(),
            None if wr is None else wr.data_ptr(),
            None if br is None else br.data_ptr(), out.data_ptr(),
            B, L, Cin, C, Cp, K, len(layers), stream)
    if rc != 0:
        raise RuntimeError(f'conv_stack_bf16 kernel launch failed: CUDA error {rc}')
    conv_stack_bf16.launches += 1
    return out


conv_stack_bf16.launches = 0


class _ConvStackBF16(torch.autograd.Function):
    """Forward through the kernel; backward recomputes the unfused f32 stack
    (JAX conv_stack.py:288-298), casting the bf16 cotangent up to f32."""

    @staticmethod
    def forward(ctx, x, n_layers, *flat):
        layers = [{'w': flat[2 * i], 'b': flat[2 * i + 1]} for i in range(n_layers)]
        ctx.n_layers = n_layers
        ctx.save_for_backward(x, *flat)
        return conv_stack_bf16(layers, x)

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            flat = [t.detach().requires_grad_(True) for t in flat]
            layers = [{'w': flat[2 * i], 'b': flat[2 * i + 1]}
                      for i in range(ctx.n_layers)]
            out = stack_apply(layers, x.float())
            grads = torch.autograd.grad(out, [x, *flat], g.to(out.dtype))
        return (grads[0], None, *grads[1:])


def fused_stack_apply_bf16(layers: List[Dict[str, torch.Tensor]],
                           x: torch.Tensor) -> torch.Tensor:
    flat = [t for p in layers for t in (p['w'], p['b'])]
    return _ConvStackBF16.apply(x, len(layers), *flat)
