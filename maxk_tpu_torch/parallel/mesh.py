"""Process groups and the collectives of row-partitioned and
tensor-parallel training.

The JAX package runs its graph axis as a device mesh inside one program
(``maxk_tpu/parallel/mesh.py``); here each shard is a rank of a
``torch.distributed`` process group, one process per rank. A
``GraphGroup`` takes the mesh's place: the group, this rank, the world
size, this rank's device and the backend.

With ``--model_parallel M`` the N ranks form a (N/M graph x M model)
``ProcessGrid``, as ``make_graph_mesh(N, model_axis_size=M)`` builds a
2-D mesh. Rank ``g * M + m`` holds graph shard g and model slice m, so
the M ranks of one shard are adjacent (adjacent cards, where each rank
has one). The graph axis keeps its halo exchange; the model axis carries
Megatron's pair of collectives around each column-parallel Dense layer
(``copy_to_model``, ``gather_columns``), which GSPMD inserts in JAX.

The backend follows from the layout, and nothing falls back:

- ``nccl`` when every rank has a card of its own;
- ``gloo`` when ranks share a card, or on the CPU. Gloo takes CUDA
  tensors for every collective used here (``all_to_all_single``,
  ``all_reduce``, ``all_gather``, ``broadcast``) and stages them through
  the host itself.

Every exchange moves rows as bytes (``_as_bytes``): the wire is the same
for any dtype and either backend.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

# How long a collective may wait for the other ranks before it fails.
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class GraphGroup:
    """The graph axis: ``size`` ranks, this one ``rank`` on ``device``."""

    rank: int
    size: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None   # None: the default group
    # The members' global ranks in group order; None: 0 .. size-1.
    ranks: Optional[tuple] = None

    def global_rank(self, i: int) -> int:
        """The global rank of member i."""
        return i if self.ranks is None else self.ranks[i]


@dataclasses.dataclass(frozen=True)
class ProcessGrid:
    """The (graph x model) grid: ``world``, this rank's graph group (the
    ranks of its model slice, one per shard) and its model group (the
    ranks of its shard, one per slice)."""

    world: GraphGroup
    graph: GraphGroup
    model: GraphGroup

    def describe(self) -> str:
        """"G-way graph x M-way model", as the JAX CLI logs its mesh."""
        return f"{self.graph.size}-way graph x {self.model.size}-way model"


def make_grid(world: GraphGroup, model_axis_size: int = 1) -> ProcessGrid:
    """The (world.size / M graph x M model) grid of the world's ranks
    (a collective: every rank calls it, in the same order as every other
    ``dist.new_group``). M = 1 is the 1-D graph axis itself, and makes no
    group; its model group has this rank alone."""
    m = max(1, model_axis_size)
    n = world.size
    if n % m:
        raise ValueError(f"n_devices={n} not divisible by "
                         f"model_axis_size={m}")
    if m == 1:
        alone = GraphGroup(rank=0, size=1, device=world.device,
                           backend=world.backend, ranks=(world.rank,))
        return ProcessGrid(world=world, graph=world, model=alone)
    g_me, m_me = divmod(world.rank, m)

    def group_of(ranks: tuple, rank: int, handle) -> GraphGroup:
        return GraphGroup(rank=rank, size=len(ranks), device=world.device,
                          backend=world.backend, group=handle, ranks=ranks)

    # Every rank creates every group, model groups first, in one order.
    model = graph = None
    for g in range(n // m):
        ranks = tuple(g * m + j for j in range(m))
        handle = dist.new_group(list(ranks))
        if g == g_me:
            model = group_of(ranks, m_me, handle)
    for j in range(m):
        ranks = tuple(g * m + j for g in range(n // m))
        handle = dist.new_group(list(ranks))
        if j == m_me:
            graph = group_of(ranks, g_me, handle)
    return ProcessGrid(world=world, graph=graph, model=model)


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """nccl when each of this host's ranks has a card of its own, gloo
    when they share one, or on the CPU."""
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device: str, local_rank: int) -> torch.device:
    """``cuda:(local_rank % cards)``, or the CPU when asked for."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_distributed(init_method: str, num_processes: int, process_id: int,
                     local_rank: int = 0, local_device_count: int = 1,
                     device: str = "cuda") -> GraphGroup:
    """Join the job as rank ``process_id * local_device_count +
    local_rank`` of ``num_processes * local_device_count``.

    init_method: ``tcp://host:port`` of the coordinator, or
    ``file://path`` of a store every rank of the job can reach.
    """
    dev = rank_device(device, local_rank)
    backend = choose_backend(dev, local_device_count)
    rank = process_id * local_device_count + local_rank
    size = num_processes * local_device_count
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, timeout=TIMEOUT)
    return GraphGroup(rank=rank, size=size, device=dev, backend=backend)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) rows as (n, row_bytes) uint8, no copy for contiguous x."""
    return x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)


def _from_bytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Inverse of _as_bytes for rows shaped and typed like `like`'s."""
    return b.view(like.dtype).reshape((b.shape[0],) + like.shape[1:])


def all_to_all_rows(x: torch.Tensor, send_counts: list, recv_counts: list,
                    group: GraphGroup) -> torch.Tensor:
    """Rows of x sent to each rank in rank order (``send_counts``), the
    rows received from each in rank order (``recv_counts``)."""
    send = _as_bytes(x)
    recv = torch.empty((sum(recv_counts), send.shape[1]), dtype=torch.uint8,
                       device=x.device)
    dist.all_to_all_single(recv, send, list(recv_counts), list(send_counts),
                           group=group.group)
    return _from_bytes(recv, x)


def all_gather_rows(x: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """Every rank's (n, ...) x, concatenated in rank order."""
    send = _as_bytes(x)
    parts = [torch.empty_like(send) for _ in range(group.size)]
    dist.all_gather(parts, send, group=group.group)
    return _from_bytes(torch.cat(parts), x)


def all_reduce_sum(x: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """The sum of every rank's x (a new tensor; x is left as it is)."""
    out = x.clone()
    dist.all_reduce(out, group=group.group)
    return out


# -- the model axis: Megatron's pair around a column-parallel layer --------

def split_sizes(n: int, parts: int) -> list:
    """n columns over `parts` ranks as ``torch.tensor_split`` cuts them:
    the first n % parts ranks hold one more."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def split_bounds(n: int, parts: int, i: int) -> tuple:
    """[lo, hi) of rank i's share of n columns (``split_sizes``)."""
    sizes = split_sizes(n, parts)
    lo = sum(sizes[:i])
    return lo, lo + sizes[i]


def gather_split(x: torch.Tensor, group: GraphGroup, n: int,
                 dim: int = 0) -> torch.Tensor:
    """Every member's share of an axis n long (its ``split_sizes``
    share of axis `dim`, in member order), concatenated into a contiguous
    tensor: shares padded to the largest for ``all_gather``, then
    trimmed."""
    if group.size == 1:
        return x
    sizes = split_sizes(n, group.size)
    pad = list(x.shape)
    pad[dim] = sizes[0] - x.shape[dim]
    xp = x.contiguous() if pad[dim] == 0 else torch.cat(
        [x, x.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(xp) for _ in range(group.size)]
    dist.all_gather(parts, xp, group=group.group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim=dim)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient's sum over the model group backward.
    Each model rank's dx is ``dy[:, its columns] @ W_m``, a partial sum
    of the whole layer's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _GatherColumns(torch.autograd.Function):
    """All-gather the model ranks' column slices into whole rows forward;
    backward, this rank's columns of dy (not a sum: what follows the
    gather is computed alike on every model rank)."""

    @staticmethod
    def forward(ctx, y, group, width):
        ctx.bounds = split_bounds(width, group.size, group.rank)
        return gather_split(y, group, width, dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.bounds
        return g[:, lo:hi].contiguous(), None, None


def copy_to_model(x: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """x into the model region: the identity, whose gradient is summed
    over ``group`` (the model group)."""
    if group.size == 1:
        return x
    return _CopyToModel.apply(x, group)


def gather_columns(y: torch.Tensor, group: GraphGroup,
                   width: int) -> torch.Tensor:
    """(n, width) from each model rank's (n, its columns) ``y``."""
    if group.size == 1:
        return y
    return _GatherColumns.apply(y, group, width)
