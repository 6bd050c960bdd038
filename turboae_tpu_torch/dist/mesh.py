"""Data parallelism over torch.distributed (JAX: dist/mesh.py).

In JAX one process drives N devices: `Config.mesh_shape=(N,)` shards the
batch axis and GSPMD makes every reduction over that axis global. Here one
process per rank does that work, launched by torchrun
(`python -m torch.distributed.run`): with NCCL each rank owns one card, with
gloo the ranks run on the CPU (or share a card). A global batch of
`batch_size` rows splits into `batch_size / N` rows a rank.

The semantics are those of JAX's global arrays:
  - every draw is made at the global shape from the generator that every
    rank seeds alike, and each rank keeps its rows (`rows`, `shard_rows`):
    an N-rank run sees the numbers the 1-rank run with that seed sees;
  - every statistic over the batch axis is global (`batch_sum`,
    `batch_mean`): the power constraint's mean and std, the losses' batch
    means, the metrics and error counts.

The gradient rule. Each rank's objective is its *share* of the loss, and the
shares sum to the single-process loss: local sums are divided by the global
count, and a term every rank computes alike from global statistics (maxBCE's
max, sortBCE's top 5) is divided by the world size (`share`). A global
statistic goes through `all_reduce`, whose backward all-reduces the incoming
gradient, so each rank's input receives what every rank's share owes it.
The parameter gradients are then summed over the ranks once a step, before
the optimizers step, and the reported loss is the sum of the shares. (An
all-reduce of a replicated loss would scale every gradient by the world
size; an identity backward would drop the other ranks' part of a global
statistic's gradient.)

The mesh in effect is set by `active(mesh)` around a trainer's or sweep's
work, as a `with mesh:` block does in JAX; the model code reads it through
the helpers below, which are the identity with no mesh. The only collective
is `all_reduce`: gloo has no other but `broadcast` on CUDA tensors.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: this process's place in the job."""
    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any


def launch_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) as torchrun sets them; None outside it."""
    if 'WORLD_SIZE' not in os.environ:
        return None
    return (int(os.environ.get('RANK', 0)), int(os.environ['WORLD_SIZE']),
            int(os.environ.get('LOCAL_RANK', 0)))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = 'nccl') -> bool:
    """Join the job's process group over `coordinator` ('tcp://host:port' or
    'env://'); True when a group is up. A no-op for one process with no
    coordinator, as JAX's is. NCCL needs one card a rank: it raises when this
    node's ranks (LOCAL_WORLD_SIZE, else num_processes) outnumber its cards."""
    if backend not in BACKENDS:
        raise ValueError(f'backend must be one of {BACKENDS}, got {backend!r}')
    if num_processes is None or (num_processes == 1 and coordinator is None):
        return False
    if backend == 'nccl':
        local = int(os.environ.get('LOCAL_WORLD_SIZE', num_processes))
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(f'NCCL needs one card a rank: {local} ranks on this node, '
                               f'{cards} cards (use gloo to share a card or run on the CPU)')
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=coordinator or 'env://',
                                world_size=num_processes, rank=process_id)
    return True


def make_mesh(shape: Sequence[int] = (), device=None) -> Optional[Mesh]:
    """() -> None (one process, no collectives); (N,) -> the data-parallel
    mesh over the job's N ranks, which must be up (initialize_distributed).
    device: this rank's device, by default cuda:LOCAL_RANK under NCCL and the
    CPU under gloo. A 2-D mesh raises: it is ROADMAP M16b."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return None
    if len(shape) != 1:
        raise NotImplementedError(f'mesh {shape}: only 1-D data parallelism is ported; '
                                  '2-D meshes are ROADMAP M16b')
    if not dist.is_initialized():
        raise RuntimeError(f'mesh {shape} needs a process group: launch with torchrun '
                           '(python -m torch.distributed.run) and call initialize_distributed')
    world = dist.get_world_size()
    if shape[0] != world:
        raise ValueError(f'mesh {shape} needs {shape[0]} ranks, the job has {world}')
    backend = dist.get_backend()
    if device is None:
        local = (launch_env() or (0, 0, 0))[2]
        device = torch.device('cuda', local) if backend == 'nccl' else torch.device('cpu')
    return Mesh(world, dist.get_rank(), torch.device(device), backend, dist.group.WORLD)


# ---------------------------------------------------------------- the mesh in effect
_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]):
    """Make `mesh` the one the model code reduces over, for the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = prev


def current() -> Optional[Mesh]:
    return _ACTIVE


def world() -> int:
    return 1 if _ACTIVE is None else _ACTIVE.size


# ---------------------------------------------------------------- rows
def shard_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a global (B, ...) tensor; raises unless the mesh
    divides B, as a sharding would in JAX."""
    if mesh is None:
        return x
    b, r = divmod(x.shape[0], mesh.size)
    if r:
        raise ValueError(f'{x.shape[0]} rows do not split over {mesh.size} ranks')
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """draw(shape) for this rank's `shape` of rows: under a mesh the draw is
    made at the global shape and this rank's rows are kept, so that the
    generator moves on alike on every rank and equal to the 1-rank run."""
    mesh = _ACTIVE
    if mesh is None:
        return draw(tuple(shape))
    return shard_rows(draw((shape[0] * mesh.size, *shape[1:])), mesh)


# ---------------------------------------------------------------- reductions
class _AllReduce(torch.autograd.Function):
    """Sum over the ranks; the backward sums the incoming gradient too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks of the mesh in effect, differentiable;
    x itself with no mesh."""
    if _ACTIVE is None:
        return x
    return _AllReduce.apply(x, _ACTIVE.group)


def batch_sum(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The sum over the global batch of x's rows: over all axes (dim None) or
    over `dim`, which holds axis 0."""
    s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return all_reduce(s)


def batch_count(x: torch.Tensor, dim=None) -> int:
    """How many global elements a batch_sum over `dim` adds up."""
    dims = range(x.dim()) if dim is None else ((dim,) if isinstance(dim, int) else dim)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return n * world()


def mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The mean over the global batch (all axes, or `dim`, which holds axis
    0); torch.mean itself with no mesh."""
    if _ACTIVE is None:
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    return batch_sum(x, dim) / batch_count(x, dim)


def batch_mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The mean over the global batch, as XLA takes a mean (the f32 sum times
    the f32 reciprocal of the count; utils/metrics.py:f32_mean with no mesh)."""
    recip = float(np.float32(1.0) / np.float32(batch_count(x, dim)))
    return batch_sum(x, dim, keepdim) * recip


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a term every rank computes alike: x / world size."""
    return x if _ACTIVE is None else x / _ACTIVE.size


def all_reduce_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum each tensor over the ranks, in place, in one collective a dtype
    (not differentiable: the trainers' gradients and reported numbers)."""
    if mesh is None or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.group)
        i = 0
        for t in group:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
