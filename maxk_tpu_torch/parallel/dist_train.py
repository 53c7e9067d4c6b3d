"""Row-partitioned full-graph training over the ranks of a process group.

The layout of ``maxk_tpu/parallel/dist_train.py``, one rank per shard:

- the adjacency and the node arrays split into equal row blocks
  (``parallel/partition.py``), each rank holding its own;
- parameters replicated: every rank builds the model from the config's
  seed, and rank 0's state is broadcast at the start;
- each aggregation exchanges the rows it needs (``parallel/halo.py``;
  the CBSR wire on the MaxK SpGEMM);
- the loss is the local masked sum over the all-reduced count (JAX's
  ``psum(num) / psum(den)``), and after ``backward`` the gradients are
  all-reduced with SUM as one flat buffer, then Adam steps.

No DDP: its bucketing would hide the one reduction the step makes, and
GNNRes's BatchNorm sums its statistics itself (``models.BatchNorm``).
Dropout draws from a generator seeded by (seed, rank), the JAX package's
``fold_in(rng, axis_index)``, so runs with dropout agree with one device
only in distribution. Every rank evaluates on the all-gathered logits;
only rank 0 writes checkpoints and results.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from maxk_tpu_torch.data.datasets import Dataset
from maxk_tpu_torch.models.models import MODEL_NORMS
from maxk_tpu_torch.parallel.mesh import (GraphGroup, all_gather_rows,
                                          all_reduce_sum)
from maxk_tpu_torch.parallel.partition import (ShardedGraphBundle,
                                               local_bundle, local_rows,
                                               shard_bundle)
from maxk_tpu_torch.train.checkpoint import CheckpointManager
from maxk_tpu_torch.train.loop import (FitLoop, masked_loss_terms,
                                       model_from_config)
from maxk_tpu_torch.train.optim import make_optimizer


def rank_seed(seed: int, rank: int) -> int:
    """A seed for rank's dropout bits, apart from every other rank's."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class DistTrainer(FitLoop):
    """One rank of row-partitioned training.

    Its model is an ordinary model on this rank's device: load weights
    with ``model.load_state_dict`` (from a Trainer) or
    ``model.load_flax_params`` on every rank alike before the first step.
    ``sharded``: the dataset's graph already sharded over the group's
    ranks (``shard_bundle``), built from the config otherwise.
    """

    def __init__(self, config, dataset: Dataset, group: GraphGroup,
                 logger=None, writer=None,
                 sharded: Optional[ShardedGraphBundle] = None):
        self.config = config
        self.dataset = dataset
        self.group = group
        self.logger = logger
        self.writer = writer
        self.device = group.device
        self.is_writer = group.rank == 0

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

        self.model = model_from_config(config, dataset,
                                       group=group).to(self.device)
        for t in self.model.state_dict().values():
            dist.broadcast(t, 0, group=group.group)
        self.optimizer = make_optimizer(
            self.model.parameters(), config.w_lr, config.w_weight_decay,
            enable_lookahead=getattr(config, "enable_lookahead", False))
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(config.seed, group.rank))
        self.epoch = 0
        # The loss's denominator: train nodes over every rank.
        self.n_train = all_reduce_sum(
            self.train_mask.sum().to(torch.float32), group)

    # -- steps ----------------------------------------------------------------

    def train_step(self) -> torch.Tensor:
        """One step on every rank; returns the global loss (on the
        device, the same on every rank)."""
        self.model.train()
        logits = self.model(self.graphs, self.features, training=True,
                            generator=self.generator)
        num, _ = masked_loss_terms(logits, self.labels, self.train_mask,
                                   self.dataset.multilabel)
        loss = num / torch.clamp(self.n_train, min=1.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # One all-reduce: every gradient, then this rank's share of the
        # loss.
        params = list(self.model.parameters())
        flat = torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1) for p in params] + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=self.group.group)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n
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
        """The replicated state, and every rank's dropout generator (a
        collective: every rank calls it)."""
        state = self.generator.get_state().to(self.device)
        states = all_gather_rows(state.reshape(1, -1), self.group).cpu()
        # A tensor of its own each: set_state reads a state from the start
        # of its storage.
        return dict(model=self.model.state_dict(),
                    optimizer=self.optimizer.state_dict(),
                    generators=[s.clone() for s in states], epoch=self.epoch,
                    extra=extra)

    def load_blob(self, blob: dict) -> dict:
        """Restore a state_blob on this rank; returns its extra dict."""
        self.model.load_state_dict(blob["model"])
        self.optimizer.load_state_dict(blob["optimizer"])
        self.generator.set_state(blob["generators"][self.group.rank])
        self.epoch = blob["epoch"]
        return blob["extra"]

    def save_checkpoint(self, ckpt: CheckpointManager, step: int,
                        extra: dict) -> None:
        """Rank 0 writes; every rank waits until the file is there."""
        blob = self.state_blob(extra)
        if self.is_writer:
            ckpt.save(step, blob)
        all_reduce_sum(torch.zeros(1, device=self.device), self.group)
