"""Bidirectional multi-layer GRU and LSTM (JAX: ops/gru.py).

Params are PyTorch's layout: one direction of one layer is
{'w_ih': (G*H, In), 'w_hh': (G*H, H), 'b_ih': (G*H,), 'b_hh': (G*H,)} with
G = 3 gates r/z/n for the GRU and G = 4 gates i/f/g/o for the LSTM; a stack
is a list of layers {'fwd': dir, 'bwd': dir}, layer l > 0 reading 2H
features. The gate math is torch's: separate b_ih and b_hh, and the GRU's
n = tanh(i_n + r * (h W_hn + b_hn)). A layer's output is
concat([fwd, bwd]) over the features, the reverse direction's outputs in
input order.

Three routes compute the same function:
  - 'scan', the plain version and the CPU's: the input projection of every
    step is hoisted out of the loop, the recurrence is a Python loop over
    time with an f32 carry, and under compute_dtype bf16 both matmuls take
    operands rounded to bf16 and accumulate in f32 (JAX :42-70, 121-143);
  - 'cudnn', the card's: one cuDNN RNN call per layer (`torch._VF.gru` /
    `lstm`, bidirectional, batch first). Each call first copies the layer's
    eight tensors into one buffer laid out as cuDNN lays out its weights
    (`torch._cudnn_rnn_flatten_weight`'s offsets, found once per shape), so
    cuDNN runs on views of it and neither copies nor warns; gradients reach
    the params through the copy. Without gradients the call is a CUDA graph
    captured once per (kind, shape, dtype, device): cuDNN's standard RNN
    launches a GEMM and a cell kernel for every step and direction (400
    launches a layer at L=100), which the replay issues without the host.
    The pack writes straight into the graph's weight buffer and the input's
    cast into its input buffer; the output is copied out as f32, so the next
    replay may overwrite it. Under gradients, or inside another
    capture, the call runs eagerly;
  - 'kernel', K4 (kernels/gru.py:gru_bf16): one launch a layer, all its
    steps of both directions, the weights in shared memory and h on chip,
    the scan's bf16 arithmetic with its f32 carry. A stack's inner layers
    hand their output to the next in bf16, which that layer rounds its input
    to anyway; the last writes f32.
`route_for` decides by what a call shows: a tensor on the CPU takes the
scan; on the card a GRU in bf16 without gradients or dropout whose widths
fit K4's block (H <= 104, inputs <= 208) takes K4, every other call cuDNN
(f32, the LSTM, training, wider layers). cuDNN's bf16 RNN keeps its hidden
state in bf16 where the scan keeps f32, and still lands within 5e-3 of the
bf16 scan (PERF.md §6). `route=` forces one ('kernel' raises on a call that
K4 cannot take); nothing falls back to another. The scan also runs in f64
(compute_dtype float64), as a reference for the routes' f32 rounding.

Dropout between layers (torch's `dropout=`) follows every layer but the last
(JAX :86-94). Its keep mask is drawn from the caller's generator, one
uniform tensor per dropped layer in layer order; with no generator, rate 0
or one layer there is none.

ROUTE_CALLS counts the layer calls of each route, so a caller can see which
one ran.

A stack's call is the span `rnn`, each of its layers a span `rnn.layer`
(every route), and the build of cuDNN's flat weight buffer a span
`rnn.pack` inside it, K4's call the span `k4` (utils/logging.py: recorded
only under a profiler session). `birnn_apply.calls` counts the stacks,
`birnn_apply.layers` their layers and `birnn_apply.pack_bytes` the bytes
written into cuDNN's flat buffers or K4's packed planes (0 on the scan, and
on K4's cache hits).

A recurrence over time has no local form over a rank's positions: under a
mesh that shards time (dist/mesh.py) `birnn_apply` gathers its input, runs
on the whole block with no mesh in effect (its dropout masks drawn at the
whole block's shape, as the 1-rank run draws them) and keeps this rank's
positions (`whole_time`).
"""
from __future__ import annotations

import gc
import math
from functools import lru_cache
from typing import Dict, List, Optional

import torch

from ..dist import mesh as dm
from ..kernels import gru as k4
from ..utils.logging import span

Layer = Dict[str, Dict[str, torch.Tensor]]

ROUTE_CALLS = {'scan': 0, 'cudnn': 0, 'kernel': 0}
_GATES = {'gru': 3, 'lstm': 4}
_DIR_KEYS = ('w_ih', 'w_hh', 'b_ih', 'b_hh')


def _uniform(gen: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    return ((torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound).to(device)


def _dir_init(gen, input_size: int, hidden_size: int, gates: int, device):
    """torch's RNN init: every tensor U(-1/sqrt(H), 1/sqrt(H)), drawn in
    the order w_ih, w_hh, b_ih, b_hh."""
    bound = 1.0 / math.sqrt(hidden_size)
    G = gates * hidden_size
    shapes = ((G, input_size), (G, hidden_size), (G,), (G,))
    return {k: _uniform(gen, s, bound, device) for k, s in zip(_DIR_KEYS, shapes)}


def gru_layer_init(gen: torch.Generator, input_size: int, hidden_size: int, device='cpu'):
    """One direction of one GRU layer (JAX :28-39)."""
    return _dir_init(gen, input_size, hidden_size, 3, device)


def lstm_layer_init(gen: torch.Generator, input_size: int, hidden_size: int, device='cpu'):
    """One direction of one LSTM layer (JAX :102-110)."""
    return _dir_init(gen, input_size, hidden_size, 4, device)


def birnn_init(gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int,
               kind: str = 'gru', device='cpu') -> List[Layer]:
    """A bidirectional stack; layer l > 0 reads 2H features."""
    init = lstm_layer_init if kind == 'lstm' else gru_layer_init
    return [{d: init(gen, input_size if l == 0 else 2 * hidden_size, hidden_size, device)
             for d in ('fwd', 'bwd')} for l in range(num_layers)]


def bigru_init(gen, input_size, hidden_size, num_layers, device='cpu'):
    return birnn_init(gen, input_size, hidden_size, num_layers, 'gru', device)


def bilstm_init(gen, input_size, hidden_size, num_layers, device='cpu'):
    return birnn_init(gen, input_size, hidden_size, num_layers, 'lstm', device)


# ---------------------------------------------------------------- the scan

def _scan(p, x: torch.Tensor, reverse: bool, kind: str, compute_dtype) -> torch.Tensor:
    """One direction over (B, L, In) -> (B, L, H), f32 out (f64 under f64)."""
    B, L, _ = x.shape
    H = p['w_hh'].shape[1]
    acc = torch.float64 if compute_dtype == torch.float64 else torch.float32
    q = lambda t: t.to(compute_dtype).to(acc)
    gi_all = torch.matmul(q(x), q(p['w_ih']).t()) + p['b_ih'].to(acc)      # (B, L, G*H)
    w_hh_t, b_hh = q(p['w_hh']).t(), p['b_hh'].to(acc)
    h = torch.zeros((B, H), dtype=acc, device=x.device)
    c = torch.zeros_like(h)
    out = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        gh = torch.matmul(q(h), w_hh_t) + b_hh
        gi = gi_all[:, t]
        if kind == 'lstm':
            gates = gi + gh
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        else:
            i_r, i_z, i_n = gi.chunk(3, dim=-1)
            h_r, h_z, h_n = gh.chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = (1.0 - z) * n + z * h
        out[t] = h
    return torch.stack(out, dim=1)


def _scan_layer(layer: Layer, x, kind, compute_dtype):
    return torch.cat([_scan(layer['fwd'], x, False, kind, compute_dtype),
                      _scan(layer['bwd'], x, True, kind, compute_dtype)], dim=-1)


# ---------------------------------------------------------------- cuDNN

@lru_cache(maxsize=None)
def _cudnn_layout(kind: str, input_size: int, hidden_size: int, dtype, device):
    """(buffer numel, [(offset, shape)] of the eight tensors fwd then bwd in
    _DIR_KEYS order) of one bidirectional layer's cuDNN weight buffer."""
    from torch.backends.cudnn.rnn import get_cudnn_mode
    G = _GATES[kind] * hidden_size
    shapes = [(G, input_size), (G, hidden_size), (G,), (G,)] * 2
    dummies = [torch.empty(s, dtype=dtype, device=device) for s in shapes]
    with torch.no_grad():
        buf = torch._cudnn_rnn_flatten_weight(dummies, 4, input_size,
                                              get_cudnn_mode(kind.upper()), hidden_size, 0, 1,
                                              True, True)
    base = buf.untyped_storage().data_ptr()
    if any(d.untyped_storage().data_ptr() != base for d in dummies):
        raise RuntimeError('cuDNN did not lay the RNN weights out in one buffer')
    return buf.numel(), [(d.storage_offset(), s) for d, s in zip(dummies, shapes)]


def _cudnn_call(kind: str, xin: torch.Tensor, buf: torch.Tensor, places, H: int,
                train: bool) -> torch.Tensor:
    """cuDNN's call of one bidirectional layer on views of the flat buffer."""
    weights = [buf[off:off + math.prod(s)].view(s) for off, s in places]
    h0 = torch.zeros((2, xin.shape[0], H), dtype=xin.dtype, device=xin.device)
    if kind == 'lstm':
        return torch._VF.lstm(xin, (h0, h0), weights, True, 1, 0.0, train, True, True)[0]
    return torch._VF.gru(xin, h0, weights, True, 1, 0.0, train, True, True)[0]


@lru_cache(maxsize=None)
def _cudnn_graph(kind: str, shape, H: int, dtype, device):
    """(graph, input buffer, weight buffer, output) of the inference call at
    `shape` (B, L, In), captured once. A first call on a side stream sets
    up cuDNN's handle and workspace outside the capture; the cycle collector
    is paused during it, since a graph it destroys would break the capture
    (train/trainer.py:_StepGraph)."""
    numel, places = _cudnn_layout(kind, shape[-1], H, dtype, device)
    with torch.inference_mode(False), torch.no_grad():
        xin = torch.zeros(shape, dtype=dtype, device=device)
        buf = torch.zeros(numel, dtype=dtype, device=device)
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            _cudnn_call(kind, xin, buf, places, H, False)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                out = _cudnn_call(kind, xin, buf, places, H, False)
        finally:
            gc.enable()
    return graph, xin, buf, out


def _cudnn_layer(layer: Layer, x: torch.Tensor, kind: str, dtype) -> torch.Tensor:
    H = layer['fwd']['w_hh'].shape[1]
    numel, places = _cudnn_layout(kind, x.shape[-1], H, dtype, x.device)
    tensors = [layer[d][k] for d in ('fwd', 'bwd') for k in _DIR_KEYS]
    train = torch.is_grad_enabled()
    graphed = not train and not torch.cuda.is_current_stream_capturing()
    if graphed:
        graph, xin, buf, out = _cudnn_graph(kind, tuple(x.shape), H, dtype, x.device)
    with span('rnn.pack'):
        pieces, at = [], 0
        for (off, _), t in sorted(zip(places, tensors), key=lambda pt: pt[0][0]):
            if off > at:
                pieces.append(torch.zeros(off - at, dtype=dtype, device=x.device))
            pieces.append(t.to(dtype).reshape(-1))
            at = off + t.numel()
        if numel > at:
            pieces.append(torch.zeros(numel - at, dtype=dtype, device=x.device))
        buf = torch.cat(pieces, out=buf) if graphed else torch.cat(pieces)
        birnn_apply.pack_bytes += buf.numel() * buf.element_size()
    if graphed:
        xin.copy_(x)
        graph.replay()
        return out.to(torch.float32, copy=True)
    return _cudnn_call(kind, x.to(dtype).contiguous(), buf, places, H, train).float()


# ---------------------------------------------------------------- K4

def _kernel_layer(layer: Layer, x: torch.Tensor, last: bool) -> torch.Tensor:
    hits = k4.gru_bf16.pack_hits
    out = k4.gru_bf16(layer, x, out_f32=last)
    if k4.gru_bf16.pack_hits == hits:
        birnn_apply.pack_bytes += k4.packed_bytes(x.shape[-1])
    return out


# ---------------------------------------------------------------- apply

def route_for(device_type: str, kind: str, dtype, grad: bool, dropout: bool, H: int, In: int,
              route: Optional[str] = None) -> str:
    """The route of a stack's call: `device_type` of its input, its `kind`,
    compute `dtype`, whether it needs gradients or draws dropout, its units
    H and widest layer input In; `route` forces one (see the module's
    docstring)."""
    if route is not None and route not in ROUTE_CALLS:
        raise ValueError(f'route must be one of {tuple(ROUTE_CALLS)}, got {route!r}')
    if device_type == 'cpu':
        if route in ('cudnn', 'kernel'):
            raise ValueError(f'route {route!r} needs a CUDA tensor')
        return 'scan'
    fits = (kind == 'gru' and dtype == torch.bfloat16 and not grad and not dropout
            and k4.fits(In, H))
    if route == 'kernel' and not fits:
        raise ValueError('route \'kernel\' takes a GRU in bf16 without gradients or dropout, '
                         f'H <= {k4.GRU_H} and inputs <= {k4.GRU_IN}; got {kind}, {dtype}, '
                         f'gradients {grad}, dropout {dropout}, H={H}, In={In}')
    return route or ('kernel' if fits else 'cudnn')


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: zero each unit with probability `rate`, scale the
    rest by 1 / (1 - rate); one uniform draw per unit from `generator`."""
    keep = 1.0 - rate
    mask = dm.rows(lambda s: torch.rand(s, generator=generator, device=x.device),
                   x.shape) < keep     # drawn at the global batch under a mesh
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _interlayer_dropout(x: torch.Tensor, rate: float, generator, layer_idx: int,
                        n_layers: int) -> torch.Tensor:
    if rate <= 0.0 or generator is None or layer_idx >= n_layers - 1:
        return x
    return dropout(x, rate, generator)


def birnn_apply(layers: List[Layer], x: torch.Tensor, kind: str = 'gru',
                compute_dtype=torch.float32, dropout: float = 0.0,
                generator: Optional[torch.Generator] = None,
                route: Optional[str] = None) -> torch.Tensor:
    """(B, L, In) -> (B, L, 2H) f32 (f64 for the f64 scan). The call is the
    span `rnn`; it counts in `birnn_apply.calls` (see the module's docstring)."""
    with span('rnn'):
        out = dm.whole_time(lambda full: _birnn(layers, full, kind, compute_dtype, dropout,
                                                generator, route), x)
        birnn_apply.calls += 1
    return out


birnn_apply.calls = birnn_apply.layers = birnn_apply.pack_bytes = 0


def _birnn(layers, x, kind, compute_dtype, dropout, generator, route):
    H = layers[0]['fwd']['w_hh'].shape[1]
    tensors = [t for layer in layers for d in layer.values() for t in d.values()]
    grad = torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in tensors))
    dropped = dropout > 0.0 and generator is not None and len(layers) > 1
    r = route_for(x.device.type, kind, compute_dtype, grad, dropped, H,
                  max(x.shape[-1], 2 * H if len(layers) > 1 else 0), route)
    for i, layer in enumerate(layers):
        ROUTE_CALLS[r] += 1
        with span('rnn.layer'):
            if r == 'kernel':
                x = _kernel_layer(layer, x, i == len(layers) - 1)
            elif r == 'cudnn':
                x = _cudnn_layer(layer, x, kind, compute_dtype)
            else:
                x = _scan_layer(layer, x, kind, compute_dtype)
            birnn_apply.layers += 1
        x = _interlayer_dropout(x, dropout, generator, i, len(layers))
    return x


def bigru_apply(layers, x, compute_dtype=torch.float32, dropout: float = 0.0,
                generator=None, route=None):
    return birnn_apply(layers, x, 'gru', compute_dtype, dropout, generator, route)


def bilstm_apply(layers, x, compute_dtype=torch.float32, dropout: float = 0.0,
                 generator=None, route=None):
    return birnn_apply(layers, x, 'lstm', compute_dtype, dropout, generator, route)
