"""Data and sequence parallelism over torch.distributed (JAX: dist/mesh.py
and Trainer._constrain, train/trainer.py:95-106).

In JAX one process drives N devices: `Config.mesh_shape=(N,)` shards the
batch axis (`shard_axis='batch'`, P('data')) or the time axis
(`shard_axis='time'`, P(None, 'data')), and GSPMD makes every reduction
over that axis global. Here one process per rank does that work, launched by
torchrun (`python -m torch.distributed.run`): with NCCL each rank owns one
card, with gloo the ranks run on the CPU (or share a card).

The mesh. `make_mesh((N,))` puts the job's N ranks on the 'data' axis;
`make_mesh((N, M))` names the axes ('data', 'model') as JAX does: rank r has
data index r // M and model index r % M. Every sharding is over 'data', so
the M ranks of one data index are replicas, as in JAX, where nothing is
sharded over 'model'. Each model index has its data group, the N ranks that
share it: every reduction and gradient sum runs over it, and `world()` is its
size N.

The share of a rank along the mesh's axis (`shard_rows`, `rows`): under
'batch' the blocks [d B/N, (d+1) B/N) of a global (B, ...) tensor, under
'time' the positions [d L/N, (d+1) L/N) of axis 1 of a (B, L, ...) tensor.
Every draw is made at the global shape from the generator that every rank
seeds alike, and each rank keeps its share: an N-rank run sees the numbers
the 1-rank run with that seed sees.

The semantics are those of JAX's global arrays. A statistic over the sharded
axis is global (`batch_sum`, `batch_mean`, `mean`): the power constraint's
mean and std, the losses' means, the metrics and error counts. A reduction
over other axes only is local: under 'time' the mean over the batch axis of
maxBCE's positional loss. Under 'time' an op that mixes positions first
gathers its narrow input along time (`gather_time`): the interleavers, the
conv stacks' halo windows (`halo_apply`), and the ops with no local form
over time, which run whole with no mesh in effect and keep this rank's
positions (`whole_time`: the biRNNs, the 2D codes, DeepTurbo's turbo
encoder), as GSPMD replicates an op it cannot partition.

The gradient rule. Each rank's objective is its *share* of the loss, and the
shares sum to the single-process loss: local sums are divided by the global
count, and a term every rank computes alike from global statistics (maxBCE's
max, sortBCE's top 5) is divided by the world size (`share`). A global
statistic goes through `all_reduce`, whose backward all-reduces the incoming
gradient, so each rank's input receives what every rank's share owes it;
`gather_time`'s backward likewise sums the incoming gradient over the ranks
and keeps this rank's positions. The parameter gradients are then summed over
the data group once a step, before the optimizers step, and the reported loss
is the sum of the shares. (An all-reduce of a replicated loss would scale
every gradient by the world size; an identity backward would drop the other
ranks' part of a global statistic's gradient.)

The mesh in effect is set by `active(mesh)` around a trainer's or sweep's
work, as a `with mesh:` block does in JAX; the model code reads it through
the helpers below, which are the identity with no mesh. The only collective
is `all_reduce`: gloo has no other but `broadcast` on CUDA tensors, so
`gather_time` all-reduces a zero-filled global buffer into which each rank
writes its positions (exact: each element is one rank's value plus zeros).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ('nccl', 'gloo')
AXES = ('batch', 'time')


@dataclass(frozen=True)
class Mesh:
    """This process's place in the job. `size` is the data axis's size N, the
    world of every reduction; `rank` the process's rank in the job; `group`
    its data group; `shape` (N,) or (N, M) (() reads as (size,)); `shard_axis`
    the axis of a (B, L, ...) batch that the data axis shards."""
    size: int
    rank: int
    device: torch.device
    backend: str
    group: Any
    shape: Tuple[int, ...] = ()
    shard_axis: str = 'batch'

    @property
    def replicas(self) -> int:
        """M, the size of the 'model' axis (1 for a 1-D mesh)."""
        return self.shape[1] if len(self.shape) == 2 else 1

    @property
    def data(self) -> int:
        """This rank's index on the 'data' axis: its share of the batch or time."""
        return self.rank // self.replicas

    @property
    def model(self) -> int:
        """This rank's index on the 'model' axis: which replica it is."""
        return self.rank % self.replicas

    @property
    def data_group(self):
        """The ranks that share this rank's model index."""
        return self.group

    @property
    def axis(self) -> int:
        """The sharded axis of a (B, L, ...) tensor: 0 ('batch') or 1 ('time')."""
        return AXES.index(self.shard_axis)


def along(mesh: Optional[Mesh], shard_axis: str) -> Optional[Mesh]:
    """`mesh` sharding `shard_axis` ('batch' or 'time'); None stays None."""
    if shard_axis not in AXES:
        raise ValueError(f'shard_axis must be one of {AXES}, got {shard_axis!r}')
    if mesh is None or mesh.shard_axis == shard_axis:
        return mesh
    return dataclasses.replace(mesh, shard_axis=shard_axis)


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


def make_mesh(shape: Sequence[int] = (), device=None, shard_axis: str = 'batch'
              ) -> Optional[Mesh]:
    """() -> None (one process, no collectives); (N,) -> the mesh of the
    job's N ranks on the 'data' axis; (N, M) -> ('data', 'model') over N * M
    ranks, M replicas of each data index. The job's process group must be up
    (initialize_distributed); every rank builds the M data groups, in one
    order. device: this rank's device, by default cuda:LOCAL_RANK under NCCL
    and the CPU under gloo. More than two axes raise, as JAX's names allow
    only two."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return None
    if len(shape) > 2:
        raise ValueError(f'mesh {shape}: the axes are (\'data\', \'model\'); at most two')
    if not dist.is_initialized():
        raise RuntimeError(f'mesh {shape} needs a process group: launch with torchrun '
                           '(python -m torch.distributed.run) and call initialize_distributed')
    world = dist.get_world_size()
    need = int(np.prod(shape))
    if need != world:
        raise ValueError(f'mesh {shape} needs {need} ranks, the job has {world}')
    backend = dist.get_backend()
    if device is None:
        local = (launch_env() or (0, 0, 0))[2]
        device = torch.device('cuda', local) if backend == 'nccl' else torch.device('cpu')
    rank = dist.get_rank()
    n, m = shape[0], (shape[1] if len(shape) == 2 else 1)
    group = dist.group.WORLD
    if m > 1:
        for j in range(m):              # every rank creates every group
            g = dist.new_group([d * m + j for d in range(n)])
            if rank % m == j:
                group = g
    return along(Mesh(n, rank, torch.device(device), backend, group, shape), shard_axis)


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
    """The data group's size: how many shares a global statistic sums."""
    return 1 if _ACTIVE is None else _ACTIVE.size


def time_sharded() -> bool:
    """Whether the mesh in effect shards the time axis."""
    return _ACTIVE is not None and _ACTIVE.shard_axis == 'time'


# ---------------------------------------------------------------- shares
def shard_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's share of a global tensor along the mesh's axis: its blocks
    of axis 0 under 'batch', its positions of axis 1 under 'time'; raises
    unless the mesh divides that axis, as a sharding would in JAX."""
    if mesh is None:
        return x
    a = mesh.axis
    n, r = divmod(x.shape[a], mesh.size)
    if r:
        what = 'rows' if a == 0 else 'positions'
        raise ValueError(f'{x.shape[a]} {what} do not split over {mesh.size} ranks')
    return x.narrow(a, mesh.data * n, n)


def rows(draw: Callable[[tuple], torch.Tensor], shape: Sequence[int]) -> torch.Tensor:
    """draw(shape) for this rank's `shape`: under a mesh the draw is made at
    the global shape and this rank's share is kept, so that the generator
    moves on alike on every rank and equal to the 1-rank run."""
    mesh = _ACTIVE
    if mesh is None:
        return draw(tuple(shape))
    full = list(shape)
    full[mesh.axis] *= mesh.size
    return shard_rows(draw(tuple(full)), mesh)


def time_slice(n: int) -> Tuple[int, int]:
    """(s, e): the global positions of this rank's n positions under 'time';
    (0, n) otherwise."""
    if not time_sharded():
        return 0, n
    return _ACTIVE.data * n, (_ACTIVE.data + 1) * n


class _GatherTime(torch.autograd.Function):
    """The global tensor along `dim` from each rank's equal share of n; the
    backward sums the incoming gradient over the ranks and keeps this rank's
    share."""

    @staticmethod
    def forward(ctx, x, dim, index, size, group):
        n = x.shape[dim]
        ctx.dim, ctx.start, ctx.n, ctx.group = dim, index * n, n, group
        shape = list(x.shape)
        shape[dim] = n * size
        y = x.new_zeros(shape)
        y.narrow(dim, index * n, n).copy_(x)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None, None, None


def gather_time(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Under 'time', the global tensor along `dim` (the time axis, or a
    flattened axis of positions) from this rank's share, differentiable;
    x itself otherwise."""
    if not time_sharded():
        return x
    m = _ACTIVE
    return _GatherTime.apply(x, dim, m.data, m.size, m.group)


def halo_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
               halo: int) -> torch.Tensor:
    """fn(x) for a same-length op along time whose output at a position reads
    the input within `halo` positions of it (a conv stack: num_layer * (K //
    2)). Under 'time' this rank gathers x, runs fn on the window [max(s -
    halo, 0), min(e + halo, L)) and keeps its positions [s, e): fn's zero
    padding falls on a true end of the block only where the window meets
    one, and the rows that a cut edge corrupts lie within `halo` of it, which
    is outside [s, e) (kernels/conv_stack.py:window_plan's argument)."""
    if not time_sharded():
        return fn(x)
    n = x.shape[1]
    s, e = time_slice(n)
    full = gather_time(x)
    lo, hi = max(s - halo, 0), min(e + halo, full.shape[1])
    return fn(full[:, lo:hi])[:, s - lo:e - lo]


def whole_time(fn: Callable, *xs: torch.Tensor):
    """fn(*xs) for an op with no local form over time. Under 'time' every x
    is gathered, fn runs on the whole block with no mesh in effect (its
    statistics and draws are then the whole block's, as in the 1-rank run),
    and this rank's positions of its output are kept (of the first element,
    where fn returns a tuple: an encoder's (codes, stats))."""
    if not time_sharded():
        return fn(*xs)
    s, e = time_slice(xs[0].shape[1])
    full = [gather_time(x) for x in xs]
    with active(None):
        out = fn(*full)
    if isinstance(out, tuple):
        return (out[0][:, s:e], *out[1:])
    return out[:, s:e]


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
    """The sum of x over the data group of the mesh in effect,
    differentiable; x itself with no mesh."""
    if _ACTIVE is None:
        return x
    return _AllReduce.apply(x, _ACTIVE.group)


def _spans(x: torch.Tensor, dim) -> bool:
    """Whether a reduction of x over `dim` (None: all axes) spans the ranks:
    under 'batch' every one does (each holds axis 0), under 'time' one that
    holds axis 1."""
    if _ACTIVE is None:
        return False
    if _ACTIVE.axis == 0:
        return True
    if dim is None:
        return x.dim() > 1
    dims = (dim,) if isinstance(dim, int) else dim
    return 1 in {d % x.dim() for d in dims}


def batch_sum(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The sum over the global tensor: over all axes (dim None) or over
    `dim`, which under 'batch' holds axis 0; local where it does not span
    the ranks (over the batch axis only, under 'time')."""
    s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    return all_reduce(s) if _spans(x, dim) else s


def batch_count(x: torch.Tensor, dim=None) -> int:
    """How many global elements a batch_sum over `dim` adds up."""
    dims = range(x.dim()) if dim is None else ((dim,) if isinstance(dim, int) else dim)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return n * world() if _spans(x, dim) else n


def mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The mean over the global tensor (all axes, or `dim`); torch.mean
    itself where it does not span the ranks."""
    if not _spans(x, dim):
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
    return batch_sum(x, dim) / batch_count(x, dim)


def batch_mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """The mean over the global tensor, as XLA takes a mean (the f32 sum times
    the f32 reciprocal of the count; utils/metrics.py:f32_mean with no mesh)."""
    recip = float(np.float32(1.0) / np.float32(batch_count(x, dim)))
    return batch_sum(x, dim, keepdim) * recip


def share(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of a term every rank computes alike: x / world size."""
    return x if _ACTIVE is None else x / _ACTIVE.size


def all_reduce_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Sum each tensor over the data group, in place, in one collective a
    dtype (not differentiable: the trainers' gradients and reported numbers)."""
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
