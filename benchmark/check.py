"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, number by number, each against the limit
``benchmark/limits/<cell>.json`` gives it.

- ``loss_gap``: the largest of the steps' |loss - reference loss| over the
  reference loss; ``loss1_gap`` the first step's.
- ``grad_gap``: the first step's gradient as Adam got it, by the worst
  parameter: |norm - reference norm| over the larger of the reference's
  norm of that parameter and of the median parameter.
- ``change_gap``: the same of each parameter's change over the steps,
  leaving out the parameters whose reference gradient norm is under a
  thousandth of the median parameter's (their change is round-off).
- ``eval_gap`` (cells that evaluate): the norm of the difference of the
  logits of the evaluation on the initial weights, which the benchmark
  drew, over the norm of the reference's evaluation forward on them.
- ``state_gap`` (models with state, such as GNN_res's BatchNorm running
  statistics): by the worst state tensor, the norm of the difference of
  its changes over the steps, the program's less the reference's, over
  the norm of the reference's change. An update left out reads 1.

A cell compares the numbers its limits name. The others are read for
the limits' choice; a model without state has no ``state_gap``.
"""

from __future__ import annotations

import math
import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3


def _leaf_gaps(got: dict, want: dict, keys) -> list:
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return [abs(got[k] - want[k]) / max(want[k], med) for k in keys]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def numbers(got, want) -> dict:
    """The numbers of one side's readings ``got`` against the reference's
    ``want`` (``cell.Readings``). Those a cell's limits name are compared;
    the others are read for the limits' choice."""
    losses = [abs(a - b) / abs(b) for a, b in zip(got.losses, want.losses)]
    med = statistics.median(want.grad_norms.values())
    moved = [k for k, g in want.grad_norms.items()
             if g >= NEGLIGIBLE_GRAD * med]
    out = {"loss_gap": max(losses), "loss1_gap": losses[0],
           "grad_gap": max(_leaf_gaps(got.grad_norms, want.grad_norms,
                                      want.grad_norms)),
           "change_gap": max(_leaf_gaps(got.change_norms, want.change_norms,
                                        moved))}
    if want.eval_logits is not None:
        out["eval_gap"] = _rel(got.eval_logits, want.eval_logits)
    if want.state_changes:
        out["state_gap"] = max(_rel(got.state_changes[k], d)
                               for k, d in want.state_changes.items())
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number finite and at
    or under its limit, and every limit's number present."""
    checks = {name: {"value": values.get(name), "limit": limit}
              for name, limit in limits.items()}
    ok = all(c["value"] is not None and math.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
