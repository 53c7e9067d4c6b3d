"""Start the ranks of a job: ``spawn`` runs a function on each of this
process's ranks and returns what each returned.

A job has ``num_processes`` processes of ``local_ranks`` ranks each, rank
``process_id * local_ranks + local_rank``, which meet at ``init_method``
(``tcp://host:port`` of the coordinator, or ``file://`` a store every
process reaches). Each rank is a process of its own, started with
``spawn``, so it imports only torch and this package; if one rank fails
the others are stopped and the error is raised here.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from maxk_tpu_torch.parallel.mesh import init_distributed


def _rank_entry(local_rank, target, args, init_method, num_processes,
                process_id, local_ranks, device, results):
    if device == "cpu":
        # The host's cores shared out: ranks on the CPU would otherwise
        # each start a thread per core (OMP_NUM_THREADS may ask for fewer).
        torch.set_num_threads(max(1, min(
            torch.get_num_threads(), (os.cpu_count() or 1) // local_ranks)))
    group = init_distributed(init_method, num_processes, process_id,
                             local_rank, local_ranks, device)
    try:
        results.put((local_rank, target(group, *args)))
    finally:
        dist.destroy_process_group()


def spawn(target, local_ranks: int, init_method: str, device: str = "cuda",
          args: tuple = (), num_processes: int = 1,
          process_id: int = 0) -> list:
    """[target(group, *args) of each local rank], by local rank. target
    must be importable by name (a module-level function) and return
    something picklable."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_entry, args=(target, args, init_method, num_processes,
                           process_id, local_ranks, device, results),
        nprocs=local_ranks, join=False, start_method="spawn")
    out = [None] * local_ranks

    def drain():
        # Read while the ranks run: a rank blocks in put() until then.
        while not results.empty():
            rank, value = results.get()
            out[rank] = value

    while not procs.join(timeout=0.2):
        drain()
    drain()
    return out


def train_rank(group, config):
    """The CLI's work on one rank: ``train.__main__.run`` as this rank."""
    from maxk_tpu_torch.train.__main__ import run
    return run(config, group)
