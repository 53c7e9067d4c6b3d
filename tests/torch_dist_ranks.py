"""What each rank computes for tests/test_torch_dist.py.

Each rank of the test's gloo group runs ``run(group, inputs)`` in a
process of its own (``maxk_tpu_torch.parallel.launch.spawn``), so this
module imports only numpy, torch and the port; the test process holds
the results to the single-device port and to the JAX package.
"""

import types

import numpy as np
import torch

from maxk_tpu_torch.ops import spgemm as spgemm_module
from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.ops.spmm import spmm_t
from maxk_tpu_torch.parallel.dist_train import DistTrainer
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


def _trainers(group, inputs) -> dict:
    """3 steps of each model: the losses, and the gradients after the
    first step's all-reduce."""
    out = {}
    for model in ("sage", "gcn", "gin", "gnn_res"):
        tr = DistTrainer(_config(inputs, model=model), inputs["dataset"],
                         group)
        losses = [float(tr.train_step())]
        grads = {n: p.grad.numpy().copy()
                 for n, p in tr.model.named_parameters()}
        losses += [float(tr.train_step()) for _ in range(2)]
        out[model] = dict(losses=losses, grads=grads)
    return out


def _from_jax(group, inputs) -> list:
    """SAGE from the JAX package's init, 3 steps."""
    tr = DistTrainer(_config(inputs, hidden_layers=inputs["jax_layers"]),
                     inputs["jax_dataset"], group)
    tr.model.load_flax_params(inputs["flax_params"])
    return [float(tr.train_step()) for _ in range(3)]


def _resume(group, inputs) -> dict:
    """SAGE at dropout 0.5: 3 steps straight through, against 2 steps, a
    checkpoint, and a fresh trainer restored from it for the third."""
    cfg = _config(inputs, dropout=0.5)
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
                logits=straight.eval_logits().numpy())


def run(group, inputs) -> dict:
    return dict(rank=group.rank, backend=group.backend,
                ops=_ops(group, inputs), trainers=_trainers(group, inputs),
                from_jax=_from_jax(group, inputs),
                resume=_resume(group, inputs))
