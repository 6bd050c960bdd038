"""Same-length Conv1d stacks and linear heads (JAX: ops/conv1d.py:43-84,119-122).

Tensors are (B, L, C) channels last at this module's interface, as in the JAX
package; `F.conv1d` sees (B, C, L) through a transpose inside.

Parameters are plain dicts in PyTorch's layout: a conv layer is
{'w': (Cout, Cin, K), 'b': (Cout,)}, a linear head {'w': (out, in), 'b': (out,)}.

Dtype policy, as in the JAX package:
  - a conv layer computes in `compute_dtype`; under bf16 its output and the bias
    add are bf16 (JAX :49-63);
  - a head takes operands rounded to `compute_dtype`, accumulates in f32 and
    returns f32 (JAX :119-122). It multiplies the rounded operands in f32,
    because a bf16 matmul rounds its output to bf16.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

Layer = Dict[str, torch.Tensor]


def conv1d_apply(p: Layer, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Same-length 1D conv on (B, L, Cin) -> (B, L, Cout), zero padding K//2."""
    w = p['w'].to(compute_dtype)
    y = F.conv1d(x.to(compute_dtype).transpose(1, 2), w, padding=w.shape[2] // 2)
    return y.transpose(1, 2) + p['b'].to(compute_dtype)


def stack_apply(layers: List[Layer], x: torch.Tensor, act=F.elu,
                no_act: bool = False, compute_dtype=torch.float32) -> torch.Tensor:
    """SameShapeConv1d: conv then activation, layer after layer."""
    for p in layers:
        x = conv1d_apply(p, x, compute_dtype)
        if not no_act:
            x = act(x)
    return x


def linear_apply(p: Layer, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Linear head: operands in `compute_dtype`, f32 accumulation, f32 out."""
    xq = x.to(compute_dtype).float()
    wq = p['w'].to(compute_dtype).float()
    return torch.matmul(xq, wq.t()) + p['b'].float()
