"""GNN_res's BatchNorm as one autograd op (``models/models.py::_BatchNorm``):
its written-out gradient against plain autograd of the same formula, the
running statistics, the ``norm.updates`` counter, the ``maxk.norm.*``
spans, and the whole GNNRes against the benchmark's plain reference
(``benchmark/reference/gnn_res.py``), which shares no code with it.

Tolerances: the op and the test's own autograd copy compute the same
statistics with the same reductions, so their gradients differ only in
the order of the backward's sums: rtol 1e-5, atol 1e-6. Against the
reference, Dense products, sparse sums and column sums run in other
orders through three layers: rtol 1e-4, the flax parity test's bound
(``test_torch_gnn_models.py``), and the running statistics, one batch
term weighed by 0.01 on the drawn ones, at rtol 1e-6.
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import profiler

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu_torch import obs
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.models.models import (BatchNorm, GraphBundle,
                                          build_model)
from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.train.loop import Trainer

EPS = 1e-5


def _stats(x, n_valid=None):
    """(mean, E[x^2] - E[x]^2) of the first n_valid rows, with the op's
    reductions: sum / n and the squared column norm / n."""
    xv = x[:n_valid]
    n = xv.shape[0]
    mean = xv.sum(dim=0) / n
    return mean, torch.linalg.vector_norm(xv, dim=0).square() / n \
        - mean * mean


def _plain(x, w, b, n_valid=None):
    """BatchNorm's training forward in plain ops, differentiated by
    autograd: the statistics of the first n_valid rows, every row
    normalised."""
    mean, raw_var = _stats(x, n_valid)
    var = torch.clamp(raw_var, min=0.0)
    return (x - mean) * torch.rsqrt(var + EPS) * w + b


def _clamped_column(x: torch.Tensor) -> torch.Tensor:
    """x with column 3 set to the first constant whose E[x^2] - E[x]^2
    rounds below 0, so that the clamp binds there."""
    for c in np.linspace(0.1, 9.9, 99, dtype=np.float32):
        x[:, 3] = float(c)
        if _stats(x)[1][3] < 0:
            return x
    raise AssertionError("no constant column rounds to a negative variance")


@pytest.mark.parametrize("case", ["random", "padded", "clamped"])
def test_gradient_is_autograds(case):
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(300, 64, generator=gen) * 2.0 + 0.5
    n_valid = 260 if case == "padded" else None
    if case == "clamped":
        x = _clamped_column(x)
        assert _stats(x)[1][3] < 0
    w = torch.rand(64, generator=gen) + 0.5
    b = torch.randn(64, generator=gen)
    dy = torch.randn(300, 64, generator=gen)

    bn = BatchNorm(64)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    xa = x.clone().requires_grad_(True)
    y = bn(xa, True, n_valid)
    y.backward(dy)

    xp, wp, bp = (t.clone().requires_grad_(True) for t in (x, w, b))
    y_plain = _plain(xp, wp, bp, n_valid)
    y_plain.backward(dy)

    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-6)
    for got, want in ((xa.grad, xp.grad), (bn.weight.grad, wp.grad),
                      (bn.bias.grad, bp.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if case == "padded":
        # Past n_valid only the direct term: rstd * w * dy.
        rstd = torch.rsqrt(torch.clamp(_stats(x, n_valid)[1], min=0.0)
                           + EPS)
        torch.testing.assert_close(xa.grad[n_valid:],
                                   dy[n_valid:] * rstd * w,
                                   rtol=1e-6, atol=0.0)


def test_running_statistics():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(200, 16, generator=gen) * 3.0 - 1.0
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(16, generator=gen))
        bn.running_var.copy_(torch.rand(16, generator=gen) + 0.5)
    old_mean, old_var = bn.running_mean.clone(), bn.running_var.clone()
    bn(x, True)
    mean, raw_var = _stats(x)
    var = torch.clamp(raw_var, min=0.0)
    torch.testing.assert_close(bn.running_mean, 0.99 * old_mean + 0.01 * mean,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.99 * old_var + 0.01 * var,
                               rtol=1e-6, atol=1e-7)
    kept = bn.running_mean.clone(), bn.running_var.clone()
    with torch.no_grad():
        y = bn(x, False)
    assert torch.equal(bn.running_mean, kept[0])
    assert torch.equal(bn.running_var, kept[1])
    want = (x - kept[0]) * torch.rsqrt(kept[1] + EPS) * bn.weight + bn.bias
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


def _trainer(layers=3):
    cfg = types.SimpleNamespace(
        model="gnn_res", hidden_dim=16, hidden_layers=layers, maxk=4,
        dropout=0.5, norm=True, nonlinear="maxk", w_lr=0.01,
        w_weight_decay=0.0, enable_lookahead=False, seed=5,
        compute_dtype="float32", device="cpu")
    ds = make_synthetic_dataset(n_nodes=200, avg_degree=6.0, n_classes=4,
                                in_size=12, seed=1)
    return Trainer(cfg, ds)


def test_updates_are_counted_a_layer_a_train_step():
    tr = _trainer(layers=3)
    before = obs.counters()["norm.updates"]
    tr.train_step()
    assert obs.counters()["norm.updates"] == before + 3
    tr.evaluate_masks()
    assert obs.counters()["norm.updates"] == before + 3
    tr.train_step()
    assert obs.counters()["norm.updates"] == before + 6


def test_spans_of_a_train_step():
    tr = _trainer(layers=3)
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU]) as p:
        tr.train_step()
    names = [e.name for e in p.events()]
    assert names.count("maxk.norm.forward") == 3
    assert names.count("maxk.norm.backward") == 3


def _reference_case(seed: int = 11):
    """The products recipe's widths (3 x 256, k 32, 100 features, 47
    classes, BatchNorm) on a 600-node graph drawn by the benchmark's
    generator; weights and running statistics drawn as the benchmark
    draws them."""
    from benchmark.graphs.generate import add_self_loops, make_graph
    from benchmark.reference import common, gnn_res

    cfg = {"hidden_dim": 256, "hidden_layers": 3, "maxk": 32,
           "dropout": 0.0, "norm": True}
    n, f, c = 600, 100, 47
    gen = torch.Generator().manual_seed(seed)
    graph = make_graph(n, 12000, 150, 2.0, gen)
    x = torch.randn(n, f, generator=gen)
    labels = torch.randint(0, c, (n,), generator=gen)
    train = torch.randperm(n, generator=gen)[:300]
    params = common.make_params(gnn_res.param_specs(cfg, f, c), gen)
    state = common.make_params(gnn_res.state_specs(cfg, f, c), gen)
    loops = add_self_loops(graph)
    csr = CSRGraph(loops.indptr.numpy(), loops.indices.numpy())
    adj = common.adjacency(graph.indptr, graph.indices, n, True,
                           gnn_res.NORM)
    return cfg, (n, f, c), x, labels, train, params, state, csr, adj


def test_gnnres_matches_the_plain_reference(monkeypatch):
    from benchmark.reference import common, gnn_res

    cfg, (n, f, c), x, labels, train, params, state, csr, adj = \
        _reference_case()
    # The reference gathers in bf16, as the configurations state; the
    # port here runs in float32, so the reference's gathers do too.
    monkeypatch.setattr(common, "bf16", lambda t: t)

    model = build_model("gnn_res", f, cfg["hidden_dim"],
                        cfg["hidden_layers"], c, maxk=cfg["maxk"],
                        feat_drop=0.0, norm=True, compute_dtype="float32")
    model.load_state_dict({**params, **state}, strict=True)
    graphs = GraphBundle.for_model(csr, "gnn_res", symmetric=True,
                                   device="cpu")
    logits = model(graphs, x, training=True,
                   generator=torch.Generator().manual_seed(0))
    loss = F.cross_entropy(logits[train], labels[train])
    loss.backward()

    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    s = {k: v.clone() for k, v in state.items()}
    ref_logits = gnn_res.forward({**p, **s}, adj, x, cfg,
                                 torch.Generator().manual_seed(0), "float32")
    ref_loss = F.cross_entropy(ref_logits[train], labels[train])
    grads = dict(zip(p, torch.autograd.grad(ref_loss, list(p.values()))))

    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-4, atol=0.0)
    for name, prm in model.named_parameters():
        torch.testing.assert_close(prm.grad, grads[name], rtol=1e-4,
                                   atol=1e-6, msg=name)
    buffers = dict(model.named_buffers())
    for name, want in s.items():
        assert not torch.equal(want, state[name]), name
        torch.testing.assert_close(buffers[name], want, rtol=1e-6,
                                   atol=1e-7, msg=name)
