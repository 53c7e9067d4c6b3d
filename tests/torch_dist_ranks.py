"""What each rank computes for tests/test_torch_dist.py and
tests/test_torch_tp.py.

Each rank of the test's gloo group runs ``run(group, inputs)`` (2 ranks)
or ``run_grid(group, inputs)`` (4 ranks as 2 graph x 2 model) in a
process of its own (``maxk_tpu_torch.parallel.launch.spawn``), so this
module imports only numpy, torch and the port; the test process holds
the results to the single-device port and to the JAX package.
"""

import types

import numpy as np
import torch
from torch import profiler

from maxk_tpu_torch.ops import spgemm as spgemm_module
from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.ops.spmm import spmm_t
from maxk_tpu_torch.parallel.dist_train import DistTrainer
from maxk_tpu_torch.parallel.mesh import make_grid
from maxk_tpu_torch.parallel.tensor import ColumnParallelLinear
from maxk_tpu_torch.parallel.partition import local_rows, shard_graph
from maxk_tpu_torch.train.checkpoint import CheckpointManager


def _ops(group, inputs) -> dict:
    """This rank's rows of spmm_t and maxk_spgemm (forward and dx) on its
    shards, in halo and all-gather mode, at each compute dtype (spmm_t
    also under "int8", which quantizes the exchanged table); and of
    maxk_spgemm under CBSR_GATHER_MODE in all-gather mode, where K5 reads
    the received table ("spgemm_gather")."""
    csr = CSRGraph(*inputs["graph"])
    x, dy, k = inputs["x"], inputs["dy"], inputs["k"]
    out = {}
    for halo in (True, False):
        sg = shard_graph(csr, group.size, halo)
        g = sg.local(group)
        g_t = shard_graph(csr.transpose(), group.size, halo).local(group)
        x_l = torch.from_numpy(local_rows(x, sg, group.rank))
        dy_l = torch.from_numpy(local_rows(dy, sg, group.rank))
        cases = [("spmm", "float32"), ("spgemm", "float32"),
                 ("spgemm", "bfloat16"), ("spmm", "int8")]
        if not halo:
            cases += [("spgemm_gather", "float32"),
                      ("spgemm_gather", "bfloat16")]
        for name, cd in cases:
            xg = x_l.clone().requires_grad_(True)
            spgemm_module.CBSR_GATHER_MODE = name == "spgemm_gather"
            try:
                y = (spmm_t(g, g_t, xg, cd) if name == "spmm"
                     else maxk_spgemm(g, g_t, xg, k, cd))
            finally:
                spgemm_module.CBSR_GATHER_MODE = False
            y.backward(dy_l)
            out[(name, cd, halo)] = (y.detach().numpy(), xg.grad.numpy())
    return out


def _config(inputs, **over):
    return types.SimpleNamespace(**{**inputs["config"], **over})


def _trainers(group, inputs, **over) -> dict:
    """3 steps of each model: the losses, and the gradients after the
    first step's all-reduce (on a grid, this rank's rows of each
    column-parallel weight's)."""
    out = {}
    for model in ("sage", "gcn", "gin", "gnn_res"):
        tr = DistTrainer(_config(inputs, model=model, **over),
                         inputs["dataset"], group)
        losses = [float(tr.train_step())]
        grads = {n: p.grad.numpy().copy()
                 for n, p in tr.model.named_parameters()}
        losses += [float(tr.train_step()) for _ in range(2)]
        out[model] = dict(losses=losses, grads=grads)
    return out


def _from_jax(group, inputs, **over) -> list:
    """SAGE from the JAX package's init, 3 steps."""
    tr = DistTrainer(_config(inputs, hidden_layers=inputs["jax_layers"],
                             **over), inputs["jax_dataset"], group)
    tr.model.load_flax_params(inputs["flax_params"])
    return [float(tr.train_step()) for _ in range(3)]


def _resume(group, inputs, **over) -> dict:
    """SAGE at dropout 0.5: 3 steps straight through, against 2 steps, a
    checkpoint, and a fresh trainer restored from it for the third; the
    straight trainer's logits and its ``evaluate_masks()``."""
    cfg = _config(inputs, dropout=0.5, **over)
    ds = inputs["dataset"]
    straight = DistTrainer(cfg, ds, group)
    losses = [float(straight.train_step()) for _ in range(3)]
    first = DistTrainer(cfg, ds, group)
    for _ in range(2):
        first.train_step()
    ckpt = CheckpointManager(inputs["ckpt_dir"])
    first.save_checkpoint(ckpt, 2, dict(note="two steps"))
    resumed = DistTrainer(cfg, ds, group)
    blob, step = ckpt.restore()
    extra = resumed.load_blob(blob)
    return dict(straight=losses, resumed=float(resumed.train_step()),
                step=step, epoch=resumed.epoch, extra=extra,
                logits=straight.eval_logits().numpy(),
                metrics=straight.evaluate_masks(),
                blob_shapes={k: tuple(v.shape)
                             for k, v in blob["model"].items()})


def _placement(grid, inputs) -> dict:
    """SAGE with Lookahead after 6 steps (its slow copies exist): each
    parameter's, Adam moment's and slow copy's shape on this rank, and
    the columns each column-parallel layer holds."""
    tr = DistTrainer(_config(inputs, enable_lookahead=True),
                     inputs["dataset"], grid)
    for _ in range(6):
        tr.train_step()
    names = [n for n, _ in tr.model.named_parameters()]
    opt = tr.optimizer.state_dict()
    shapes = {}
    for i, (n, p) in enumerate(tr.model.named_parameters()):
        st = opt["inner"]["state"][i]
        shapes[n] = dict(param=tuple(p.shape),
                         exp_avg=tuple(st["exp_avg"].shape),
                         exp_avg_sq=tuple(st["exp_avg_sq"].shape),
                         slow=tuple(opt["slow"][i].shape))
    columns = {f"{n}.weight": (m.lo, m.hi, m.out_features)
               for n, m in tr.model.named_modules()
               if isinstance(m, ColumnParallelLinear)}
    assert set(names) >= set(columns)
    return dict(shapes=shapes, columns=columns, nbytes=tr.state_nbytes())


def _rows_contiguous(grid, inputs) -> bool:
    """Whether a column-parallel layer hands on row-major rows, as the
    kernels after it (K1, K2) need them."""
    tr = DistTrainer(_config(inputs), inputs["dataset"], grid)
    with torch.no_grad():
        return tr.model.lin_in(tr.features).is_contiguous()


def _step_spans(group, inputs) -> list:
    """(name, start, end) of the ``maxk.`` spans of one SAGE step under
    the profiler, by start."""
    tr = DistTrainer(_config(inputs), inputs["dataset"], group)
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU]) as p:
        tr.train_step()
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in p.events() if e.name.startswith("maxk."))


def run(group, inputs) -> dict:
    # The same 2 ranks as a (1 graph x 2 model) grid.
    grid = make_grid(group, 2)
    return dict(rank=group.rank, backend=group.backend,
                ops=_ops(group, inputs), trainers=_trainers(group, inputs),
                spans=_step_spans(group, inputs),
                from_jax=_from_jax(group, inputs),
                resume=_resume(group, inputs),
                grid=dict(graph=(grid.graph.rank, grid.graph.size),
                          model=(grid.model.rank, grid.model.size),
                          trainers=_trainers(grid, inputs),
                          contiguous=_rows_contiguous(grid, inputs)))


def run_grid(group, inputs) -> dict:
    """The 4 ranks as (2 graph x 2 model): the four families, SAGE from
    the JAX package's init, the placement, a checkpoint resume."""
    grid = make_grid(group, 2)
    return dict(rank=group.rank, backend=group.backend,
                graph=(grid.graph.rank, grid.graph.size),
                model=(grid.model.rank, grid.model.size),
                trainers=_trainers(grid, inputs),
                from_jax=_from_jax(grid, inputs),
                placement=_placement(grid, inputs),
                resume=_resume(group, inputs, model_parallel=2))
