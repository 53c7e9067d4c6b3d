"""One run of a cell: its inputs, the program's Trainer on them, its first
steps, the measured window, and the plain reference that judges it.

The program is ``maxk_tpu_torch``'s ``Trainer``, built from the
configuration's settings and handed the benchmark's inputs and initial
weights. Each epoch calls ``Trainer.train_step()`` and, every
``eval_every`` epochs, ``Trainer.evaluate_masks()``, as ``FitLoop.fit``
does. Set-up drives that same Trainer through the window's own epochs
three times; the reference follows those three steps from the same
weights, data and dropout draws. In cells that evaluate, set-up first
calls ``Trainer.evaluate_masks()`` once on the initial weights, which the
benchmark drew; the reference evaluates the same weights.

A model may hold state besides its parameters: tensors its
``state_dict`` keeps as buffers, which training updates and Adam never
sees (GNN_res's BatchNorm running statistics). Its reference names them
in ``state_specs``; the benchmark draws them with the weights, loads both
into the program, and compares each state tensor's change over the steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import types
from typing import Optional

import numpy as np
import torch

from benchmark.graphs.generate import add_self_loops, make_graph, make_nodes
from benchmark.reference import common as R
from benchmark.spec import Cell

FIRST_STEPS = 3


@dataclasses.dataclass
class Inputs:
    """What the benchmark hands both sides, on the host."""

    indptr: np.ndarray        # (V+1,) int64, the graph as run (loops in)
    indices: np.ndarray       # (E,)   int32
    features: np.ndarray      # (V, F) float32
    labels: np.ndarray        # (V,)   int64
    masks: tuple              # train, val, test (V,) bool
    params: dict              # name -> float32 initial weights (host)
    state: dict               # name -> float32 initial state (host)
    dropout_seed: int
    ref_graph: tuple          # (indptr, indices) as drawn, without loops


@dataclasses.dataclass
class RunInfo:
    """What a per-layer metric's reader is given."""

    cell: Cell
    trace: object             # trace.Trace of the window
    epochs: int               # epochs of the measured window
    trainer_build_s: float    # host seconds of the Trainer's constructor
    n_nodes: int
    n_edges: int              # directed edges as run (loops in)
    degrees: torch.Tensor     # (V,) as run


@dataclasses.dataclass
class Readings:
    """What one side produced in the first steps."""

    losses: list              # each step's loss
    grad_norms: dict          # name -> norm of the first step's gradient
    change_norms: dict        # name -> norm of the change over the steps
    eval_logits: Optional[torch.Tensor]   # (V, C), on the initial weights
    state_changes: dict       # name -> a state tensor's change (host)


def make_inputs(cell: Cell, seed: int, device) -> Inputs:
    """The cell's graph, node data, initial weights and, after them, the
    initial state of a model that has any, from ``seed`` on ``device``,
    copied to the host. Without state the generator is not called again,
    so a model without state gets the inputs it always had."""
    cfg, g = cell.config, cell.config["graph"]
    gen = torch.Generator(device=device).manual_seed(seed)
    graph = make_graph(g["n_nodes"], g["n_edges"], g["max_degree"],
                       g["degree_exponent"], gen)
    nodes = make_nodes(g["n_nodes"], g["n_features"], g["n_classes"],
                       tuple(g["split"]), gen)
    ref = cell.reference()
    sizes = (cfg, g["n_features"], g["n_classes"])
    params = R.make_params(ref.param_specs(*sizes), gen)
    state_specs = getattr(ref, "state_specs", None)
    specs = state_specs(*sizes) if state_specs else {}
    state = R.make_params(specs, gen) if specs else {}
    run_graph = add_self_loops(graph) if g["self_loops"] else graph
    return Inputs(
        indptr=run_graph.indptr.cpu().numpy(),
        indices=run_graph.indices.to(torch.int32).cpu().numpy(),
        features=nodes.features.cpu().numpy(),
        labels=nodes.labels.cpu().numpy(),
        masks=tuple(m.cpu().numpy() for m in (
            nodes.train_mask, nodes.val_mask, nodes.test_mask)),
        params={k: v.cpu() for k, v in params.items()},
        state={k: v.cpu() for k, v in state.items()},
        dropout_seed=seed + 1,
        # The reference gets the graph as drawn, and adds loops itself.
        ref_graph=(graph.indptr.cpu().numpy(),
                   graph.indices.cpu().numpy()))


def trainer_config(cfg: dict, seed: int, device) -> types.SimpleNamespace:
    """The Trainer's settings, as ``bench/train_bench.py::bench_config``
    builds them."""
    return types.SimpleNamespace(
        model=cfg["model"], hidden_dim=cfg["hidden_dim"],
        hidden_layers=cfg["hidden_layers"], maxk=cfg["maxk"],
        dropout=cfg["dropout"], norm=cfg["norm"],
        nonlinear=cfg["nonlinear"], w_lr=cfg["w_lr"],
        w_weight_decay=cfg["w_weight_decay"], enable_lookahead=False,
        seed=seed, compute_dtype=cfg["compute_dtype"], device=str(device))


def _norm(t: Optional[torch.Tensor], scale: float = 1.0) -> float:
    """The norm of t / scale; NaN where there is no t."""
    if t is None:
        return float("nan")
    return float(torch.linalg.vector_norm(t / scale))


class Program:
    """The system under test: a Trainer on the cell's inputs."""

    def __init__(self, cell: Cell, inputs: Inputs, seed: int, device):
        from maxk_tpu_torch.data.datasets import Dataset
        from maxk_tpu_torch.ops.graph import CSRGraph
        from maxk_tpu_torch.train.loop import Trainer

        g = cell.config["graph"]
        ds = Dataset(
            name=cell.config["name"],
            csr=CSRGraph(inputs.indptr, inputs.indices),
            features=inputs.features, labels=inputs.labels,
            train_mask=inputs.masks[0], val_mask=inputs.masks[1],
            test_mask=inputs.masks[2], num_classes=g["n_classes"],
            multilabel=False, metric="micro_f1", symmetric=True)
        self.cell = cell
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.trainer = Trainer(trainer_config(cell.config, seed, device),
                               ds, device=device)
        self.build_s = time.perf_counter() - t0
        with torch.no_grad():
            self.trainer.model.load_state_dict(
                {k: v.to(self.device)
                 for k, v in {**inputs.params, **inputs.state}.items()},
                strict=True)
        self.trainer.generator.manual_seed(inputs.dropout_seed)
        self.epochs = 0

    def epoch(self, span=contextlib.nullcontext) -> torch.Tensor:
        """One epoch of the window: a train step and, every
        ``eval_every`` epochs, the evaluation, inside ``span("bench.eval")``.
        Returns the loss, on the device."""
        every = self.cell.traffic["eval_every"]
        loss = self.trainer.train_step()
        if every and self.epochs % every == 0:
            with span("bench.eval"):
                self.trainer.evaluate_masks()
        self.epochs += 1
        return loss

    def first_steps(self, inputs: Inputs) -> Readings:
        """In cells that evaluate, one ``evaluate_masks()`` on the initial
        weights, keeping the logits it used; then the first FIRST_STEPS
        epochs, through ``epoch``: the first step's gradient from Adam's
        state after it (m = (1 - beta1) g), and the change of each
        parameter and each state tensor (``model.named_buffers()``) after
        the last."""
        tr, dev = self.trainer, self.device
        start = {k: v.to(dev) for k, v in inputs.params.items()}
        logits = None
        if self.cell.traffic["eval_every"]:
            eval_logits, captured = tr.eval_logits, []

            def capture():
                out = eval_logits()
                captured.append(out.float().cpu())
                return out

            tr.eval_logits = capture
            tr.evaluate_masks()
            del tr.eval_logits
            logits = captured[0]
        losses, grads = [], None
        for step in range(FIRST_STEPS):
            losses.append(self.epoch())
            if step == 0:
                beta1 = tr.optimizer.param_groups[0]["betas"][0]
                grads = {name: _norm(tr.optimizer.state[p].get("exp_avg"),
                                     1 - beta1)
                         for name, p in tr.model.named_parameters()}
        changes = {name: float(torch.linalg.vector_norm(p.detach()
                                                        - start[name]))
                   for name, p in tr.model.named_parameters()}
        buffers = dict(tr.model.named_buffers())
        state = {name: buffers[name].detach().float().cpu() - init
                 for name, init in inputs.state.items()}
        return Readings([float(x) for x in losses], grads, changes, logits,
                        state)

    def free(self) -> None:
        del self.trainer
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference(cell: Cell, inputs: Inputs, device, dense: str = "float32",
              half_batch: bool = False) -> Readings:
    """The plain reference's first steps from the same inputs and, in
    cells that evaluate, its evaluation forward on the initial weights.
    Only the parameters are differentiated and stepped by Adam; the
    model's ``forward`` gets one dict of parameters and state, and updates
    the state in its training forwards (a dropout generator given).
    ``dense`` "tf32" is the control; ``half_batch`` plants a fault: the
    loss over the first half of the training nodes only."""
    R.no_tf32()
    cfg, g = cell.config, cell.config["graph"]
    model = cell.reference()
    dev = torch.device(device)
    indptr, indices = (torch.from_numpy(a).to(dev) for a in inputs.ref_graph)
    adj = R.adjacency(indptr, indices, g["n_nodes"], g["self_loops"],
                      model.NORM)
    del indptr, indices
    x = torch.from_numpy(inputs.features).to(dev)
    labels = torch.from_numpy(inputs.labels).to(dev)
    train = torch.nonzero(torch.from_numpy(inputs.masks[0]).to(dev))[:, 0]
    if half_batch:
        train = train[:train.shape[0] // 2]
    p = {k: v.to(dev).clone().requires_grad_(True)
         for k, v in inputs.params.items()}
    start = {k: v.detach().clone() for k, v in p.items()}
    state = {k: v.to(dev).clone() for k, v in inputs.state.items()}
    weights = {**p, **state}   # the same tensors: both change in place
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    gen = torch.Generator(device=dev).manual_seed(inputs.dropout_seed)
    losses, grad_norms, eval_logits = [], None, None
    if cell.traffic["eval_every"]:
        with torch.no_grad():
            eval_logits = model.forward(weights, adj, x, cfg, None,
                                        dense).cpu()
    for t in range(1, FIRST_STEPS + 1):
        logits = model.forward(weights, adj, x, cfg, gen, dense)
        loss = torch.nn.functional.cross_entropy(logits[train],
                                                 labels[train])
        del logits
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        if t == 1:
            grad_norms = {k: float(torch.linalg.vector_norm(gr))
                          for k, gr in grads.items()}
        R.adam_step(p, grads, m, v2, t, cfg["w_lr"], cfg["w_weight_decay"])
        losses.append(float(loss.detach()))
        del grads, loss
    changes = {k: float(torch.linalg.vector_norm(p[k].detach() - start[k]))
               for k in p}
    state_changes = {k: state[k].cpu() - v for k, v in inputs.state.items()}
    return Readings(losses, grad_norms, changes, eval_logits, state_changes)
