"""Same-shape Conv1d and Conv2d stacks, dense stacks and linear heads
(JAX: ops/conv1d.py:28-188).

Tensors are channels last at this module's interface, as in the JAX
package: (B, L, C) for 1D and (B, H, W, C) for 2D; `F.conv1d` and
`F.conv2d` see (B, C, ...) through a transpose inside.

Parameters are plain dicts in PyTorch's layout: a conv layer is
{'w': (Cout, Cin, K), 'b': (Cout,)} (2D: {'w': (Cout, Cin, K, K), ...}), a
linear head {'w': (out, in), 'b': (out,)}.

Init is PyTorch's default for Conv1d, Conv2d and Linear, as in the JAX
package (:28-41, 66-74, 109-117, 127-134): weight and bias both
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = Cin * K (2D: Cin * K * K),
drawn in f32 from an explicit CPU torch.Generator and then moved to `device`,
so an init does not depend on the device it lands on.

Dtype policy, as in the JAX package:
  - a conv layer computes in `compute_dtype`; under bf16 its output and the bias
    add are bf16 (JAX :49-63);
  - a head takes operands rounded to `compute_dtype`, accumulates in f32 and
    returns f32 (JAX :119-122). It multiplies the rounded operands in f32,
    because a bf16 matmul rounds its output to bf16.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from ..utils.logging import span

Layer = Dict[str, torch.Tensor]


def _uniform(gen: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    return ((torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound).to(device)


def conv1d_init(gen: torch.Generator, in_channels: int, out_channels: int,
                kernel_size: int, device='cpu') -> Layer:
    """One Conv1d layer: w (Cout, Cin, K), b (Cout,), fan_in = Cin * K."""
    bound = 1.0 / math.sqrt(in_channels * kernel_size)
    return {'w': _uniform(gen, (out_channels, in_channels, kernel_size), bound, device),
            'b': _uniform(gen, (out_channels,), bound, device)}


def stack_init(gen: torch.Generator, num_layer: int, in_channels: int,
               out_channels: int, kernel_size: int, device='cpu') -> List[Layer]:
    """SameShapeConv1d: the first layer Cin -> Cout, the rest Cout -> Cout."""
    return [conv1d_init(gen, in_channels if i == 0 else out_channels, out_channels,
                        kernel_size, device) for i in range(num_layer)]


def dense_stack_init(gen: torch.Generator, num_layer: int, in_channels: int,
                     out_channels: int, kernel_size: int, device='cpu') -> List[Layer]:
    """DenseSameShapeConv1d: layer i takes Cin + i * Cout channels."""
    return [conv1d_init(gen, in_channels + i * out_channels, out_channels, kernel_size,
                        device) for i in range(num_layer)]


def linear_init(gen: torch.Generator, in_features: int, out_features: int,
                device='cpu') -> Layer:
    """Linear head: w (out, in), b (out,), fan_in = in."""
    bound = 1.0 / math.sqrt(in_features)
    return {'w': _uniform(gen, (out_features, in_features), bound, device),
            'b': _uniform(gen, (out_features,), bound, device)}


def conv1d_apply(p: Layer, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Same-length 1D conv on (B, L, Cin) -> (B, L, Cout), zero padding K//2."""
    w = p['w'].to(compute_dtype)
    y = F.conv1d(x.to(compute_dtype).transpose(1, 2), w, padding=w.shape[2] // 2)
    return y.transpose(1, 2) + p['b'].to(compute_dtype)


def halo(layers: List[Layer]) -> int:
    """How far a same-length stack's output reads its input along time: the
    sum of the layers' K // 2 (dist/mesh.py:halo_apply)."""
    return sum(p['w'].shape[-1] // 2 for p in layers)


def stack_apply(layers: List[Layer], x: torch.Tensor, act=F.elu,
                no_act: bool = False, compute_dtype=torch.float32) -> torch.Tensor:
    """SameShapeConv1d: conv then activation, layer after layer."""
    for p in layers:
        x = conv1d_apply(p, x, compute_dtype)
        if not no_act:
            x = act(x)
    return x


def dense_stack_apply(layers: List[Layer], x: torch.Tensor, act=F.elu,
                      compute_dtype=torch.float32, fused=None) -> torch.Tensor:
    """DenseNet-style stack: layer i reads the running concat
    [x, out_0, ..., out_{i-1}] in that channel order, ELU after every layer.
    Each layer rounds its input to compute_dtype, so the concat's dtype does
    not change the result.

    `fused(layers, x)`, where given, computes the whole ELU stack at once
    in place of the layers (the decoder's bf16 kernel, kernels/conv_stack.py:
    fused_dense_stack_apply_bf16, which writes no concatenation to device
    memory); `act` is then ELU.

    The call is the span `dense`. `dense_stack_apply.calls` counts the calls
    and `dense_stack_apply.copy_bytes` the bytes the running concat's
    `torch.cat`s write: B * L * itemsize * sum_i (Cin + i * Cout) for
    i = 1 .. num_layer - 1, and 0 for a fused call."""
    with span('dense'):
        if fused is not None:
            out = fused(layers, x)
        else:
            inp = x.to(compute_dtype)
            out = act(conv1d_apply(layers[0], inp, compute_dtype))
            for p in layers[1:]:
                inp = torch.cat([inp, out], dim=-1)
                dense_stack_apply.copy_bytes += inp.numel() * inp.element_size()
                out = act(conv1d_apply(p, inp, compute_dtype))
        dense_stack_apply.calls += 1
    return out


dense_stack_apply.calls = dense_stack_apply.copy_bytes = 0


def linear_apply(p: Layer, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Linear head: operands in `compute_dtype`, f32 accumulation, f32 out."""
    xq = x.to(compute_dtype).float()
    wq = p['w'].to(compute_dtype).float()
    return torch.matmul(xq, wq.t()) + p['b'].float()


def conv2d_init(gen: torch.Generator, in_channels: int, out_channels: int,
                kernel_size: int, device='cpu') -> Layer:
    """One Conv2d layer: w (Cout, Cin, K, K), b (Cout,), fan_in = Cin * K * K."""
    bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
    return {'w': _uniform(gen, (out_channels, in_channels, kernel_size, kernel_size), bound,
                          device),
            'b': _uniform(gen, (out_channels,), bound, device)}


def conv2d_apply(p: Layer, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Same-shape 2D conv on (B, H, W, Cin) -> (B, H, W, Cout), zero padding
    K//2 on both axes; the bias added in compute_dtype (JAX :137-150)."""
    w = p['w'].to(compute_dtype)
    y = F.conv2d(x.to(compute_dtype).permute(0, 3, 1, 2), w, padding=w.shape[2] // 2)
    return y.permute(0, 2, 3, 1) + p['b'].to(compute_dtype)


def stack2d_init(gen: torch.Generator, num_layer: int, in_channels: int,
                 out_channels: int, kernel_size: int, device='cpu') -> List[Layer]:
    """SameShapeConv2d: the first layer Cin -> Cout, the rest Cout -> Cout."""
    return [conv2d_init(gen, in_channels if i == 0 else out_channels, out_channels,
                        kernel_size, device) for i in range(num_layer)]


def stack2d_apply(layers: List[Layer], x: torch.Tensor, no_act: bool = False,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """SameShapeConv2d: conv then ELU, layer after layer (JAX :162-168)."""
    for p in layers:
        x = conv2d_apply(p, x, compute_dtype)
        if not no_act:
            x = F.elu(x)
    return x


def dense_stack2d_init(gen: torch.Generator, num_layer: int, in_channels: int,
                       out_channels: int, kernel_size: int, device='cpu') -> List[Layer]:
    """DenseSameShapeConv2d: layer i takes Cin + i * Cout channels."""
    return [conv2d_init(gen, in_channels + i * out_channels, out_channels, kernel_size,
                        device) for i in range(num_layer)]


def dense_stack2d_apply(layers: List[Layer], x: torch.Tensor, no_act: bool = False,
                        compute_dtype=torch.float32) -> torch.Tensor:
    """The 2D dense stack (JAX :178-188): layer i reads the running concat
    [x, out_0, ..., out_{i-1}], ELU after every layer unless no_act. As in
    the 1D one, each layer rounds its input to compute_dtype."""
    inp = x.to(compute_dtype)
    out = conv2d_apply(layers[0], inp, compute_dtype)
    out = out if no_act else F.elu(out)
    for p in layers[1:]:
        inp = torch.cat([inp, out], dim=-1)
        out = conv2d_apply(p, inp, compute_dtype)
        out = out if no_act else F.elu(out)
    return out
