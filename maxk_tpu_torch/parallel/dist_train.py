"""Row-partitioned full-graph training over the ranks of a process
group, and tensor parallelism over a second axis.

The layout of ``maxk_tpu/parallel/dist_train.py``, one rank per shard:

- the adjacency and the node arrays split into equal row blocks
  (``parallel/partition.py``), each rank holding its own;
- parameters replicated: every rank builds the model from the config's
  seed, and the graph axis's first rank's state is broadcast at the
  start;
- each aggregation exchanges the rows it needs (``parallel/halo.py``;
  the CBSR wire on the MaxK SpGEMM);
- the loss is the local masked sum over the all-reduced count (JAX's
  ``psum(num) / psum(den)``), and after ``backward`` the gradients are
  all-reduced with SUM as one flat buffer, then Adam steps.

With ``config.model_parallel`` M > 1 the ranks form a (graph x model)
``ProcessGrid`` (``parallel/mesh.py``) and every Dense layer is
column-parallel over the model axis (``parallel/tensor.py``): each rank
keeps its rows of every Linear's weight and their Adam moments and
Lookahead copies, the rest replicated. Everything above (the shards, the
exchange, the loss's count, the gradient all-reduce, the evaluation's
gather, GNNRes's BatchNorm) runs over the rank's graph group, and the M
ranks of a shard compute alike outside the Dense layers.

No DDP: its bucketing would hide the one reduction the step makes, and
GNNRes's BatchNorm sums its statistics itself (``models.BatchNorm``).
Dropout draws from a generator seeded by (seed, graph rank), the JAX
package's ``fold_in(rng, axis_index("graph"))``: a shard's model ranks
draw the same bits, and runs with dropout agree with one device only in
distribution. Every rank evaluates on the all-gathered logits; only rank
0 writes checkpoints and results. A checkpoint holds whole weights and
moments (gathered over the model group), so it is the same on any grid
of as many graph shards.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from maxk_tpu_torch import obs
from maxk_tpu_torch.data.datasets import Dataset
from maxk_tpu_torch.models.models import MODEL_NORMS
from maxk_tpu_torch.parallel.mesh import (GraphGroup, ProcessGrid,
                                          all_gather_rows, all_reduce_sum,
                                          gather_split, make_grid,
                                          split_bounds)
from maxk_tpu_torch.parallel.partition import (ShardedGraphBundle,
                                               local_bundle, local_rows,
                                               shard_bundle)
from maxk_tpu_torch.parallel.tensor import shard_model, sharded_widths
from maxk_tpu_torch.train.checkpoint import CheckpointManager
from maxk_tpu_torch.train.loop import (FitLoop, masked_loss_terms,
                                       model_from_config)
from maxk_tpu_torch.train.optim import make_optimizer


def rank_seed(seed: int, rank: int) -> int:
    """A seed for rank's dropout bits, apart from every other rank's."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class DistTrainer(FitLoop):
    """One rank of row-partitioned (and tensor-parallel) training.

    ``group``: the job's ranks (a ``GraphGroup``, made a grid of
    ``config.model_parallel`` model ranks here, every rank alike) or a
    ``ProcessGrid`` already made. Its model is an ordinary model on this
    rank's device, column-parallel on a grid: load weights with
    ``load_flax_params`` (its own columns) on every rank alike before the
    first step. ``sharded``: the dataset's graph already sharded over the
    graph axis (``shard_bundle``), built from the config otherwise.
    """

    def __init__(self, config, dataset: Dataset,
                 group: Union[GraphGroup, ProcessGrid],
                 logger=None, writer=None,
                 sharded: Optional[ShardedGraphBundle] = None):
        self.config = config
        self.dataset = dataset
        self.grid = group if isinstance(group, ProcessGrid) else make_grid(
            group, getattr(config, "model_parallel", 1))
        # The graph axis: the shards, and every reduction over them.
        self.group = group = self.grid.graph
        self.logger = logger
        self.writer = writer
        self.device = group.device
        self.is_writer = self.grid.world.rank == 0

        self.sharded = sharded if sharded is not None else shard_bundle(
            dataset.csr, group.size,
            norms=MODEL_NORMS.get(config.model, ("mean", "sum", "sym")),
            halo=getattr(config, "halo", True),
            symmetric=getattr(dataset, "symmetric", False))
        self.graphs = local_bundle(self.sharded, group)

        def rows(arr, fill=0):
            return torch.from_numpy(np.ascontiguousarray(local_rows(
                arr, self.sharded, group.rank, fill))).to(self.device)

        self.features = rows(dataset.features)
        self.labels = rows(dataset.labels)
        self.train_mask = rows(dataset.train_mask, fill=False)

        self.model = shard_model(
            model_from_config(config, dataset, group=group),
            self.grid.model).to(self.device)
        self.widths = sharded_widths(self.model)
        for t in self.model.state_dict().values():
            dist.broadcast(t, group.global_rank(0), group=group.group)
        self.optimizer = make_optimizer(
            self.model.parameters(), config.w_lr, config.w_weight_decay,
            enable_lookahead=getattr(config, "enable_lookahead", False))
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(config.seed, group.rank))
        self.epoch = 0
        # The loss's denominator: train nodes over every shard.
        self.n_train = all_reduce_sum(
            self.train_mask.sum().to(torch.float32), group)

    # -- steps ----------------------------------------------------------------

    def train_step(self) -> torch.Tensor:
        """One step on every rank; returns the global loss (on the
        device, the same on every rank)."""
        with obs.span("maxk.step"):
            self.model.train()
            with obs.span("maxk.step.forward"):
                logits = self.model(self.graphs, self.features,
                                    training=True, generator=self.generator)
                num, _ = masked_loss_terms(logits, self.labels,
                                           self.train_mask,
                                           self.dataset.multilabel)
                loss = num / torch.clamp(self.n_train, min=1.0)
            with obs.span("maxk.step.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            # One all-reduce: every gradient, then this rank's share of the
            # loss.
            with obs.span("maxk.step.allreduce"):
                params = list(self.model.parameters())
                flat = torch.cat([
                    (p.grad if p.grad is not None else torch.zeros_like(p))
                    .reshape(-1) for p in params]
                    + [loss.detach().reshape(1)])
                dist.all_reduce(flat, group=self.group.group)
                offset = 0
                for p in params:
                    n = p.numel()
                    p.grad = flat[offset:offset + n].view_as(p)
                    offset += n
            with obs.span("maxk.step.optimizer"):
                self.optimizer.step()
            self.epoch += 1
            return flat[-1]

    @torch.no_grad()
    def eval_logits(self) -> torch.Tensor:
        """Every node's logits, on every rank."""
        self.model.eval()
        local = self.model(self.graphs, self.features, training=False)
        return all_gather_rows(local.contiguous(), self.group)[
            :self.dataset.csr.n_nodes]

    # -- checkpoints ----------------------------------------------------------

    def state_blob(self, extra: dict) -> dict:
        """The whole state, and every shard's dropout generator (a
        collective: every rank calls it). Column-parallel weights and
        their optimizer state are gathered to whole rows over the model
        group, so the blob does not depend on the model axis."""
        state = self.generator.get_state().to(self.device)
        states = all_gather_rows(state.reshape(1, -1), self.group).cpu()
        # A tensor of its own each: set_state reads a state from the start
        # of its storage.
        return dict(model=self._model_state(self._whole),
                    optimizer=self._optimizer_state(
                        self.optimizer.state_dict(), self._whole),
                    generators=[s.clone() for s in states], epoch=self.epoch,
                    extra=extra)

    def load_blob(self, blob: dict) -> dict:
        """Restore a state_blob on this rank (its own rows of the
        column-parallel tensors); returns its extra dict."""
        self.model.load_state_dict(self._model_state(
            self._local, blob["model"]))
        self.optimizer.load_state_dict(self._optimizer_state(
            blob["optimizer"], self._local))
        self.generator.set_state(blob["generators"][self.group.rank])
        self.epoch = blob["epoch"]
        return blob["extra"]

    def _whole(self, t: torch.Tensor, n_rows: int) -> torch.Tensor:
        """Every model rank's rows of a column-parallel tensor."""
        return gather_split(t.to(self.device), self.grid.model, n_rows)

    def _local(self, t: torch.Tensor, n_rows: int) -> torch.Tensor:
        """This model rank's rows of a whole one."""
        m = self.grid.model
        return t[slice(*split_bounds(n_rows, m.size, m.rank))].clone()

    def _model_state(self, fn, state: Optional[dict] = None) -> dict:
        """The model's state_dict (or `state`), each column-parallel
        weight passed through fn(tensor, whole rows)."""
        if state is None:
            state = self.model.state_dict()
        return {k: (fn(v, self.widths[k]) if k in self.widths else v)
                for k, v in state.items()}

    def _optimizer_state(self, state: dict, fn) -> dict:
        """An optimizer state_dict, fn(tensor, whole rows) applied to the
        Adam moments (and Lookahead's slow copy) of each column-parallel
        weight: the tensors of its parameter's shape."""
        if not self.widths:
            return state
        names = [n for n, _ in self.model.named_parameters()]
        rows = [self.widths.get(n) for n in names]

        def adam(inner):
            per = {}
            for i, st in inner["state"].items():
                per[i] = st if rows[i] is None else {
                    k: (fn(v, rows[i]) if torch.is_tensor(v) and v.dim() == 2
                        else v) for k, v in st.items()}
            return {**inner, "state": per}

        if "inner" not in state:
            return adam(state)
        slow = state["slow"]
        if slow is not None:
            slow = [s if r is None else fn(s, r) for s, r in zip(slow, rows)]
        return {**state, "inner": adam(state["inner"]), "slow": slow}

    def state_nbytes(self) -> int:
        """Bytes of this rank's parameters and optimizer state."""
        opt = self.optimizer.state_dict()
        inner = opt.get("inner", opt)
        n = sum(p.numel() * p.element_size()
                for p in self.model.parameters())
        n += sum(v.numel() * v.element_size()
                 for st in inner["state"].values() for v in st.values()
                 if torch.is_tensor(v) and v.dim() > 0)
        for s in opt.get("slow") or ():
            n += s.numel() * s.element_size()
        return n

    def save_checkpoint(self, ckpt: CheckpointManager, step: int,
                        extra: dict) -> None:
        """Rank 0 writes; every rank waits until the file is there."""
        blob = self.state_blob(extra)
        if self.is_writer:
            ckpt.save(step, blob)
        all_reduce_sum(torch.zeros(1, device=self.device), self.grid.world)
