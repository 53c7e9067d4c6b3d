"""Process groups and the collectives of row-partitioned training.

The JAX package runs its graph axis as a device mesh inside one program
(``maxk_tpu/parallel/mesh.py``); here each shard is a rank of a
``torch.distributed`` process group, one process per rank. A
``GraphGroup`` takes the mesh's place: the group, this rank, the world
size, this rank's device and the backend.

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


class _AllReduceSum(torch.autograd.Function):
    """all_reduce_sum with its gradient: the result is replicated, so each
    rank's cotangent is its own share, and the input's gradient is their
    sum, as JAX's psum transposes."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def all_reduce_sum_grad(x: torch.Tensor, group: GraphGroup) -> torch.Tensor:
    """Differentiable all_reduce_sum."""
    return _AllReduceSum.apply(x, group)
