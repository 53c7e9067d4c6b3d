"""Tensor parallelism: every Dense layer column-parallel over the model
axis of a ``ProcessGrid``.

The JAX package stores every 2-D leaf named ``kernel`` (each flax Dense
kernel, its Adam moments and its Lookahead slow copy) as
``P(None, "model")``: dout/M columns a device, every other leaf
replicated (``maxk_tpu/parallel/dist_train.py``). A flax kernel is
(din, dout) and ``nn.Linear.weight`` is (dout, din), so here each model
rank keeps its rows of every Linear's weight (``split_bounds``: the first
dout % M ranks one more), and biases, LayerNorm and BatchNorm stay whole.

A ``ColumnParallelLinear`` computes its columns of ``x @ W.T``, gathers
the whole rows (MaxK and the aggregation need them; GSPMD inserts the
same all-gather) and adds the whole bias, so everything after it runs
alike on every model rank of a shard. Its input passes ``copy_to_model``,
whose gradient sums the model ranks' partial ``dx``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maxk_tpu_torch.parallel.mesh import (GraphGroup, copy_to_model,
                                          gather_columns, split_bounds)


class ColumnParallelLinear(nn.Module):
    """This model rank's rows of a Linear's weight (its output columns)
    and the whole bias."""

    def __init__(self, full: nn.Linear, group: GraphGroup):
        super().__init__()
        self.group = group
        self.in_features = full.in_features
        self.out_features = full.out_features
        self.lo, self.hi = split_bounds(full.out_features, group.size,
                                        group.rank)
        self.weight = nn.Parameter(
            full.weight.detach()[self.lo:self.hi].clone())
        self.bias = (None if full.bias is None
                     else nn.Parameter(full.bias.detach().clone()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gather_columns(F.linear(copy_to_model(x, self.group),
                                    self.weight),
                           self.group, self.out_features)
        return y if self.bias is None else y + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, columns=[{self.lo}, {self.hi})")


def shard_model(model: nn.Module, group: GraphGroup) -> nn.Module:
    """Make every ``nn.Linear`` of a built model column-parallel over
    ``group`` (the model group), in place; returns the model. Its
    ``tp_shard`` is (group.rank, group.size), which ``load_flax_params``
    reads. A group of one rank leaves the model as it is."""
    if group.size == 1:
        return model
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn.Linear):
                setattr(parent, name, ColumnParallelLinear(child, group))
    model.tp_shard = (group.rank, group.size)
    return model


def sharded_widths(model: nn.Module) -> dict:
    """{state_dict key of each sharded weight: its whole row count}."""
    return {f"{name}.weight": m.out_features
            for name, m in model.named_modules()
            if isinstance(m, ColumnParallelLinear)}
