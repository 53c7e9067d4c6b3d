"""The port's models, routes, compute modes and tools on one CUDA card.

Marked ``cuda``: each test skips without a CUDA device (the ``card``
fixture of ``tests/card_inputs.py`` decides, never the import). On a
machine with an H100, from the repo root:

  python -m pytest -m cuda --noconftest -p no:cacheprovider \\
      -p no:randomly tests/test_torch_card_models.py

Most run at the 131,072-node cell of ``bench/kernel_table.py`` (SAGE
4x256, k = 32, bf16 compute, norm, dropout 0.5, seed 97, bench.py's
dataset):

- ``maxk_spgemm`` on both routes against the plain composition, within
  the two-order bound of each row's sum (``sum_error_ratio``; the CBSR
  route's dx within that plus its bf16 rounding, 2**-8), its forward
  bit-equal to the mask route's and its dx the mask route's rounded to
  bf16; also at D = 1280 on the small graph, where the wide kernel
  launches once a route (K1's and K4's kernels not at all);
- 5 train steps and an evaluation of SAGE on each route, GCN, GIN and
  GNN_res: each step's launches (every kernel id; GNN_res's BatchNorm
  among them), finite losses and logits; the CBSR route's first loss
  within rtol 1e-6 of the mask route's;
- K1 and K4 bit-equal to their plain versions on the x each hidden layer
  hands them in a train step;
- GCN, GIN and GNN_res (2x256, k = 32, f32, norm off and on) on the
  small graph with the same parameters on the card and the CPU: eval
  logits within 1e-4 |cpu| + 1e-5 max |cpu|, the loss at rtol 1e-4,
  gradients and running statistics within 1e-4 max |cpu| + 1e-6, MaxK
  choices and ReLU signs the card's but at near ties
  (``tests/card_tapes.py``); K1 and K2 launch on the card, nothing on
  the CPU;
- ``--profile``'s trace holds device kernels;
- the benchmark harness: each column's launches for one call
  (``HARNESS_COLUMNS``) on syn_small_d64 (validated) and the cell, the
  cell's k = 32 CBSR forward against torch.sparse.mm, the harness under
  ``CBSR_GATHER_MODE`` (validated, K5 launched), the headline CLI;
- ``CBSR_GATHER_MODE``: SAGE's steps launch K1-K5 4 times each, and the
  first loss equals the CBSR route's;
- the reddit shape (V = 232,965, E = 114,618,780): the train_bench CLI's
  line (the JAX script's keys, V, E, a finite loss, K1 = 4 and K2 = 8 a
  step), its int8 measurement (K1 = 4, K7 = 8 a step), K2's and K7's
  rows past edge 2**31 / D within the two-order bound of a float64 sum,
  K1 bit-equal at V rows;
- the opt-in modes: SAGE under ``compute_dtype="int8"`` (K1 = 4, K7 = 8
  a step); ``maxk_spgemm`` under ``"int8_rowscale"`` (forward K4, K6's
  int8 mode, K7; backward K2, K3, K6), its forward within the JAX
  test's bounds of the dense float32 product and within K7's bound of
  its plain composition, its dx the CBSR route's; the hub split
  (``MAXK_HUB_AUTO``'s flag): a float32 ``maxk_spgemm`` and dx within two
  summation orders of each row's edges and H columns of the hub-free
  graph's, 5 steps on each route, first losses within rtol 1e-4.
"""

import dataclasses
import json
import math
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from card_inputs import (LAYERS, N_SMALL, NONE, card, cell,  # noqa: F401
                         counts, k7_bound, since, small_csr, sum_error_ratio)
from card_tapes import MaxKTape, ReluTape
from maxk_tpu_torch.bench import harness
from maxk_tpu_torch.bench.kernel_table import (D, K, V, cell_csr,
                                               layer_inputs, torch_sparse)
from maxk_tpu_torch.models.models import GraphBundle
from maxk_tpu_torch.ops import spgemm as spgemm_module
from maxk_tpu_torch.ops.cbsr import cbsr_expand, cbsr_expand_int8, cbsr_topk
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_csr, spmm_int8_plain
from maxk_tpu_torch.ops.cuda_topk import (cbsr_topk_forward,
                                          cbsr_topk_plain, maxk_forward,
                                          maxk_forward_plain)
from maxk_tpu_torch.ops.graph import DeviceCSR
from maxk_tpu_torch.ops.spgemm import maxk_spgemm, spgemm_forward_cbsr
from maxk_tpu_torch.train.loop import Trainer

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent


def _route(monkeypatch, route: str) -> None:
    """The mask route (MAXK_FUSED_MASK=1) or the CBSR route (0)."""
    monkeypatch.setenv("MAXK_FUSED_MASK", "0" if route == "cbsr" else "1")


def _train(cell, per_step: dict, cfg=None, graphs=None) -> list:
    """5 train steps and one evaluation of a fresh Trainer; each step
    launches per_step's kernels and no other, its loss is finite, and the
    logits are. Returns the losses."""
    trainer = Trainer(cfg or cell.cfg, cell.ds, graphs=graphs or cell.bundle)
    losses = []
    for _ in range(5):
        before = counts()
        losses.append(float(trainer.train_step()))
        assert since(before) == {**NONE, **per_step}
    logits = trainer.eval_logits()
    assert all(math.isfinite(x) for x in losses), losses
    assert tuple(logits.shape) == (V, 41)
    assert bool(torch.isfinite(logits).all())
    return losses


@pytest.fixture(scope="module")
def first_losses(cell):
    """The first train step's loss of a fresh SAGE Trainer at the cell,
    on each route."""
    out = {}
    for route in ("mask", "cbsr"):
        with pytest.MonkeyPatch.context() as mp:
            _route(mp, route)
            out[route] = float(Trainer(cell.cfg, cell.ds,
                                       graphs=cell.bundle).train_step())
    return out


# -- maxk_spgemm on both routes ------------------------------------------

@pytest.mark.parametrize("where", ["cell", "wide"])
def test_maxk_spgemm_routes_against_the_plain_composition(
        cell, monkeypatch, where):
    """At the cell (D = 256), and on the small graph at D = 1280, where
    the wide kernel takes K1's and K4's place."""
    if where == "cell":
        g, g_t, n, d = cell.bundle.g_mean, cell.bundle.g_mean_t, V, D
    else:
        g = DeviceCSR.from_csr(small_csr(), cell.dev)
        g_t = DeviceCSR.from_csr(small_csr().transpose(), cell.dev)
        n, d = N_SMALL, 1280
    gen = torch.Generator(device=cell.dev).manual_seed(7)
    x = torch.randn(n, d, device=cell.dev, generator=gen)
    dy = torch.randn(n, d, device=cell.dev, generator=gen)
    runs, before = {}, counts()
    for route in ("mask", "cbsr"):
        _route(monkeypatch, route)
        xg = x.clone().requires_grad_(True)
        y = maxk_spgemm(g, g_t, xg, K)
        y.backward(dy)
        runs[route] = (y.detach(), xg.grad)
    launches = since(before)
    if where == "wide":
        assert (launches["k1_wide"], launches["k4_wide"], launches["k1"],
                launches["k4"]) == (1, 1, 0, 0), launches
    y_s, mask = maxk_forward_plain(x, K)
    y_ref = spmm_csr_plain(g, y_s.to(torch.bfloat16))
    dx_ref = spmm_csr_plain(g_t, dy.to(torch.bfloat16)) * mask
    y_abs = y_s.to(torch.bfloat16).float().abs()
    dy_abs = dy.to(torch.bfloat16).float().abs()
    for route, (y, dx) in runs.items():
        assert sum_error_ratio(y, y_ref, g, y_abs) <= 1.0, route
        assert sum_error_ratio(dx, dx_ref, g_t, dy_abs, rel=2.0 ** -8
                               if route == "cbsr" else 0.0) <= 1.0, route
    (y_m, dx_m), (y_c, dx_c) = runs["mask"], runs["cbsr"]
    assert dx_c.dtype == torch.float32
    assert torch.equal(y_c.view(torch.int32), y_m.view(torch.int32))
    dx_m16 = torch.where(mask.bool(), dx_m.to(torch.bfloat16).float(), 0.0)
    assert torch.equal(dx_c.view(torch.int32), dx_m16.view(torch.int32))


# -- train steps at the cell ----------------------------------------------

BN_STEP = {"bn_sums": 2 * LAYERS, "bn_affine": LAYERS, "bn_dx": LAYERS}
MASK_STEP = {"k1": LAYERS, "k2": 2 * LAYERS}
CBSR_STEP = {**MASK_STEP, "k3": LAYERS, "k4": LAYERS, "k6": 2 * LAYERS}
TRAIN_CASES = {"sage": ("sage", "mask", MASK_STEP),
               "sage_cbsr": ("sage", "cbsr", CBSR_STEP),
               "gcn": ("gcn", "mask", MASK_STEP),
               "gin": ("gin", "mask", MASK_STEP),
               "gnn_res": ("gnn_res", "mask", {**MASK_STEP, **BN_STEP})}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_steps_at_the_cell(cell, first_losses, monkeypatch, case):
    model, route, per_step = TRAIN_CASES[case]
    _route(monkeypatch, route)
    cfg = types.SimpleNamespace(**{**vars(cell.cfg), "model": model})
    graphs = cell.bundle if model == "sage" else GraphBundle.for_model(
        cell.csr, model, symmetric=True, device=cell.dev)
    losses = _train(cell, per_step, cfg, graphs)
    if route == "cbsr":
        mask_first = first_losses["mask"]
        assert abs(losses[0] - mask_first) <= 1e-6 * abs(mask_first)


def test_k1_and_k4_on_a_train_steps_layer_inputs(cell, monkeypatch):
    """The x each of the 4 hidden layers hands K1 in the first step, and
    hands K4 on the CBSR route: both bit-equal to their plain versions."""
    for x in layer_inputs(cell.cfg, cell.ds, cell.bundle):
        y, mask = maxk_forward(x, K)
        y_ref, m_ref = maxk_forward_plain(x, K)
        assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
        assert torch.equal(mask, m_ref)
    _route(monkeypatch, "cbsr")
    for x in layer_inputs(cell.cfg, cell.ds, cell.bundle):
        values, selector = cbsr_topk_forward(x, K)
        v_ref, s_ref = cbsr_topk_plain(x, K)
        assert torch.equal(values.view(torch.int32), v_ref.view(torch.int32))
        assert torch.equal(selector, s_ref)


# -- the families on the card against the CPU ----------------------------

@pytest.fixture(scope="module")
def small_models(card):
    """The small graph's sum and sym matrices on the card and the CPU, 64
    input features, 16 classes, half the rows in training."""
    rng = np.random.default_rng(13)
    return types.SimpleNamespace(
        feats=rng.normal(size=(N_SMALL, 64)).astype(np.float32),
        labels=torch.from_numpy(rng.integers(0, 16, N_SMALL)),
        train_mask=torch.from_numpy(rng.uniform(size=N_SMALL) < 0.5),
        graphs={side: GraphBundle.from_csr(small_csr(), norms=("sum", "sym"),
                                           device=device)
                for side, device in (("card", card), ("cpu", "cpu"))})


def _ratio(a, b, rtol: float) -> float:
    """max |a - b| / (rtol |b| + 1e-5 max |b|) for logits (rtol > 0),
    max |a - b| / (1e-4 max |b| + 1e-6) otherwise."""
    scale = float(b.abs().max())
    if rtol:
        bound = rtol * b.abs() + 1e-5 * scale
    else:
        bound = torch.full_like(b, 1e-4 * scale + 1e-6)
    return float(((a - b).abs() / bound.clamp_min(1e-30)).max())


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("model", ["gcn", "gin", "gnn_res"])
def test_the_card_agrees_with_the_cpu(small_models, model, norm):
    """One train-mode step (dropout 0) and one evaluation of the model
    2x256, k=32, f32 compute, the same parameters on both sides. GIN
    without norm sums its rows up by the degree at each layer, so its
    logits reach the hundreds and a logit near 0 carries the rounding of
    its large terms: hence the 1e-5 of the largest |cpu| in the logits'
    tolerance. Under train-mode BatchNorm the gradient of the bias added
    before it is 0 but for rounding on both devices: hence the 1e-6."""
    from maxk_tpu_torch.models import models as models_mod
    from maxk_tpu_torch.train.loop import masked_loss
    sm = small_models
    n_classes = int(sm.labels.max()) + 1
    made = {}
    for side, device in (("cpu", torch.device("cpu")), ("card", "cuda")):
        made[side] = models_mod.build_model(
            model, 64, 256, 2, n_classes, maxk=K, feat_drop=0.0, norm=norm,
            nonlinear="maxk", compute_dtype="float32",
            generator=torch.Generator().manual_seed(13)).to(device)
    made["card"].load_state_dict(made["cpu"].state_dict())
    tape, relu_tape = MaxKTape(models_mod), ReluTape()
    out = {}
    for side in ("card", "cpu"):
        net, g = made[side], sm.graphs[side]
        device = next(net.parameters()).device
        x = torch.from_numpy(sm.feats).to(device)
        on_card = side == "card"
        before = counts()
        with (tape.record() if on_card else tape.replay(),
              relu_tape.record() if on_card else relu_tape.replay()):
            logits = net(g, x, training=True)
            loss = masked_loss(logits, sm.labels.to(device),
                               sm.train_mask.to(device), False)
            loss.backward()
            train_launches = since(before)
            mid = counts()
            with torch.no_grad():
                eval_logits = net(g, x)
            eval_launches = since(mid)
        out[side] = dict(
            loss=float(loss.detach()), eval_logits=eval_logits.cpu(),
            grads={n: p.grad.cpu() for n, p in net.named_parameters()},
            buffers={n: b.cpu() for n, b in net.named_buffers()},
            launches=({n: train_launches[n] for n in ("k1", "k2")},
                      {n: eval_launches[n] for n in ("k1", "k2")}))
    card, cpu = out["card"], out["cpu"]
    assert card["launches"] == ({"k1": 2, "k2": 4}, {"k1": 2, "k2": 2})
    assert cpu["launches"] == ({"k1": 0, "k2": 0}, {"k1": 0, "k2": 0})
    ratios = {"eval_logits": _ratio(card["eval_logits"], cpu["eval_logits"],
                                    1e-4),
              "loss": abs(card["loss"] - cpu["loss"])
              / (1e-4 * abs(cpu["loss"]))}
    ratios.update({f"grad:{n}": _ratio(card["grads"][n], g, 0)
                   for n, g in cpu["grads"].items()})
    ratios.update({f"buffer:{n}": _ratio(card["buffers"][n], b, 0)
                   for n, b in cpu["buffers"].items()})
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 1.0, (worst, ratios[worst], tape.flips,
                                  relu_tape.flips)


# -- the tools: --profile, the harness, the headline ---------------------

def test_profile_writes_a_trace_with_device_kernels(card, tmp_path):
    """A short fit with ``profile=True`` writes one trace into
    {path}/profile, and it holds device kernels."""
    from maxk_tpu_torch.tools.golden_accuracy import golden_dataset
    cfg = types.SimpleNamespace(
        model="sage", hidden_dim=64, hidden_layers=2, dropout=0.2,
        norm=True, nonlinear="maxk", maxk=32, epochs=4, w_lr=0.01,
        w_weight_decay=0.0, enable_lookahead=False, seed=97,
        path=str(tmp_path), log_every=1000, eval_every=1, save_every=0,
        resume=False, timing=False, patience=0, compute_dtype="bfloat16",
        device="cuda", profile=True)
    Trainer(cfg, golden_dataset()).fit()
    traces = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum(e.get("cat") == "kernel" for e in events) > 0


# What one call of each harness column launches: the CBSR forward is the
# expansion (K6) then K2, the backward K2 then K3, the mask route's
# forward K1 then K2; COO and GNNA are torch ops.
HARNESS_COLUMNS = {
    "baseline_spmm": {"k2": 1}, "coo_spmm": {}, "gnna_sag": {},
    "topk": {"k4": 1}, "maxk": {"k2": 1, "k6": 1},
    "maxk_fused_mask": {"k1": 1, "k2": 1},
    "baseline_spmm_T": {"k2": 1}, "maxk_backward": {"k2": 1, "k3": 1}}


def _counting_time_fn(per_call: list):
    """harness.time_fn, with one call of fn made first and its launches
    appended to per_call."""
    real = harness.time_fn

    def time_fn(fn, *args, **kwargs):
        before = counts()
        fn()
        torch.cuda.synchronize()
        per_call.append(since(before))
        return real(fn, *args, **kwargs)
    return time_fn


@pytest.mark.parametrize("graph", ["syn_small_d64", "cell"])
def test_benchmark_graph_launches_per_column(card, monkeypatch, graph):
    """benchmark_graph with GNNA, COO and the fused mask: syn_small_d64
    validated against the host oracle, the cell without it."""
    csr = (harness.synthetic_by_name(graph) if graph == "syn_small_d64"
           else cell_csr())
    per_call, lines = [], []
    monkeypatch.setattr(harness, "time_fn", _counting_time_fn(per_call))
    before = counts()
    result = harness.benchmark_graph(
        csr, graph, validate=graph == "syn_small_d64", run_gnna=True,
        run_coo=True, run_fused_mask=True, log=lines.append, device=card)
    launches = since(before)
    kernels = [ln.split()[4] for ln in lines if not ln.startswith("#")]
    assert len(kernels) == len(per_call)
    for kernel, got in zip(kernels, per_call):
        assert got == {**NONE, **HARNESS_COLUMNS[kernel]}, kernel
    assert all(launches[n] > 0 for n in ("k1", "k2", "k3", "k4")), launches
    assert launches["k1_wide"] == launches["k4_wide"] == 0
    if graph == "syn_small_d64":
        assert result.validation["passed"], result.validation
        assert result.validation["mean_err"] < 1e-3
        assert result.validation["bwd_mean_err"] < 1e-3
    harness.analyze_speedups([result], log=lines.append)


def test_benchmark_graph_under_the_gather_mode(card, monkeypatch):
    """syn_small_d64 under CBSR_GATHER_MODE, validated: its float32
    validation runs K5."""
    monkeypatch.setattr(spgemm_module, "CBSR_GATHER_MODE", True)
    before = counts()
    small = harness.benchmark_graph(
        harness.synthetic_by_name("syn_small_d64"), "syn_small_d64",
        validate=True, run_gnna=False, run_coo=False, run_fused_mask=False,
        log=lambda line: None, device=card)
    assert small.validation["passed"], small.validation
    assert since(before)["k5"] > 0


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_cbsr_forward_at_the_cell_against_torch_sparse(card, compute_dtype):
    """The harness's k = 32 forward on the cell's operands, within the
    two-order bound of torch.sparse.mm on the expanded operand."""
    csr_v, x_np, _ = harness._operands(cell_csr(), D, 123)
    g = DeviceCSR.from_csr(csr_v, card)
    values, selector = cbsr_topk(torch.from_numpy(x_np).to(card), K)
    y = spgemm_forward_cbsr(g, values, selector, D, compute_dtype)
    xe = cbsr_expand(values, selector, D).to(compute_dtype).float()
    ref = torch.sparse.mm(torch_sparse(g), xe)
    assert sum_error_ratio(y, ref, g, xe.abs()) <= 1.0


def test_headline_cli(card):
    """python -m maxk_tpu_torch.bench.headline prints one JSON line."""
    proc = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.bench.headline"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    head = json.loads(lines[0])
    assert set(head) == {"metric", "value", "unit", "vs_baseline",
                         "train_step_ms"}
    assert all(math.isfinite(head[key]) and head[key] > 0
               for key in ("value", "vs_baseline", "train_step_ms")), head


def test_sage_under_the_gather_mode(cell, first_losses, monkeypatch):
    """K5 in place of the forward's expansion and K2: K1-K5 4 times a
    step, K6 4 (the backward's expansion); the first loss the CBSR
    route's."""
    monkeypatch.setattr(spgemm_module, "CBSR_GATHER_MODE", True)
    losses = _train(cell, {"k1": LAYERS, "k2": LAYERS, "k3": LAYERS,
                           "k4": LAYERS, "k5": LAYERS, "k6": LAYERS})
    assert losses[0] == first_losses["cbsr"]


# -- the reddit shape ----------------------------------------------------

REDDIT_V, REDDIT_E = 232965, 114618780


def test_train_bench_cli_at_the_reddit_shape(card):
    """python -m maxk_tpu_torch.bench.train_bench at its defaults."""
    from maxk_tpu_torch.bench.train_bench import JAX_KEYS
    proc = subprocess.run(
        [sys.executable, "-m", "maxk_tpu_torch.bench.train_bench"],
        capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(JAX_KEYS) <= set(bench)
    assert (bench["n_nodes"], bench["n_edges"]) == (REDDIT_V, REDDIT_E)
    assert math.isfinite(bench["loss"])
    assert bench["launches_per_step"] == {**NONE, **MASK_STEP}


@pytest.fixture(scope="module")
def reddit(card):
    """train_bench's dataset at the reddit shape and its Trainer's
    graphs, with x of (V, 256) float32."""
    from maxk_tpu_torch.bench.train_bench import (bench_config, parse_args,
                                                  reddit_dataset)
    ds = reddit_dataset()
    graphs = Trainer(bench_config(parse_args([])), ds).graphs
    gen = torch.Generator(device=card).manual_seed(20)
    x = torch.randn(ds.csr.n_nodes, D, device=card, generator=gen)
    return types.SimpleNamespace(ds=ds, graphs=graphs, x=x)


@pytest.mark.parametrize("kernel", ["k2", "k7"])
def test_rows_past_edge_2_31_over_d_at_the_reddit_shape(reddit, kernel):
    """The hub row and the last 3 rows, where an index computed as edge x
    D in 32 bits would overflow: K2 on bf16 x, and K7 on x's per-column
    int8 table, each within the two-order bound of its float64 sum
    (n_r + 1 terms' roundings for K7's scale)."""
    from maxk_tpu_torch.ops.spmm import quantize_columns
    g, v = reddit.graphs.g_mean, reddit.ds.csr.n_nodes
    assert (v, g.n_edges) == (REDDIT_V, REDDIT_E)
    if kernel == "k2":
        table, scale, extra = reddit.x.to(torch.bfloat16), None, 0
        out = spmm_csr(g, table)
    else:
        table, scale = quantize_columns(reddit.x)
        extra = 1
        out = spmm_int8_csr(g, table, scale, False)
    deg = torch.diff(g.indptr)
    rows = sorted({int(deg.argmax())} | set(range(v - 3, v)))
    assert int(g.indptr[v - 1]) * D > 2**31
    for r in rows:
        lo, hi = int(g.indptr[r]), int(g.indptr[r + 1])
        terms = (g.values[lo:hi].double()[:, None]
                 * table[g.indices[lo:hi].long()].double())
        if scale is not None:
            terms = terms * scale.double()
        bound = 2 * (hi - lo + extra) * 2.0 ** -24 * terms.abs().sum(0)
        ratio = float(((out[r].double() - terms.sum(0)).abs()
                       / bound.clamp_min(1e-30)).max())
        assert ratio <= 1.0, (r, lo, hi, ratio)


def test_k1_at_the_reddit_rows(reddit):
    y, m = maxk_forward(reddit.x, K)
    y_ref, m_ref = maxk_forward_plain(reddit.x, K)
    assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
    assert torch.equal(m, m_ref)


def test_train_bench_int8_at_the_reddit_shape(reddit, card):
    """train_bench's measurement under --compute_dtype int8 on the same
    dataset and graphs: K7 in K2's place."""
    from maxk_tpu_torch.bench.train_bench import measure, parse_args
    int8 = measure(parse_args(["--compute_dtype", "int8"]), reddit.ds, card,
                   graphs=reddit.graphs)
    assert int8["launches_per_step"] == {**NONE, "k1": LAYERS,
                                         "k7": 2 * LAYERS}
    assert math.isfinite(int8["loss"])


# -- the opt-in compute modes at the cell ---------------------------------

def test_sage_under_int8(cell):
    cfg = types.SimpleNamespace(**{**vars(cell.cfg), "compute_dtype": "int8"})
    _train(cell, {"k1": LAYERS, "k7": 2 * LAYERS}, cfg)


def test_maxk_spgemm_under_int8_rowscale_at_the_cell(cell, monkeypatch):
    """Forward K4, K6's int8 mode and K7; backward K2, K3 and K6. The
    forward within the JAX test's bounds of the dense float32 product
    (mean error over max(1, mean |ref|) < 5e-3, none > 0.1) and within
    K7's bound of its plain composition; dx the CBSR route's at bf16."""
    g, g_t = cell.bundle.g_mean, cell.bundle.g_mean_t
    gen = torch.Generator(device=cell.dev).manual_seed(24)
    x = torch.randn(V, D, device=cell.dev, generator=gen)
    dy = torch.randn(V, D, device=cell.dev, generator=gen)
    xg = x.clone().requires_grad_(True)
    before = counts()
    y = maxk_spgemm(g, g_t, xg, K, "int8_rowscale")
    fwd = since(before)
    mid = counts()
    y.backward(dy)
    assert fwd == {**NONE, "k4": 1, "k6_int8": 1, "k7": 1}
    assert since(mid) == {**NONE, "k2": 1, "k3": 1, "k6": 1}
    dense = spmm_csr(g, maxk_forward(x, K)[0])
    err = (y.detach() - dense).abs() / max(1.0, float(dense.abs().mean()))
    assert float(err.mean()) < 5e-3 and float(err.max()) <= 0.1
    q, scale = cbsr_expand_int8(*cbsr_topk(x, K), D)
    plain = spmm_int8_plain(g, q, scale, True)
    assert bool(torch.all((y.detach().double() - plain.double()).abs()
                          <= k7_bound(g, q, scale, True)))
    _route(monkeypatch, "cbsr")
    xc = x.clone().requires_grad_(True)
    maxk_spgemm(g, g_t, xc, K).backward(dy)
    assert torch.equal(xg.grad.view(torch.int32), xc.grad.view(torch.int32))


@pytest.fixture(scope="module")
def hub(cell):
    """The cell's GraphBundle with the hub split that MAXK_HUB_AUTO=1
    turns on (ops/graph.py reads the variable at import, so its flag is
    set here)."""
    from maxk_tpu_torch.ops import graph as graph_module
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graph_module, "_HUB_AUTO", True)
        return GraphBundle.from_csr(cell.csr, norms=("mean",),
                                    symmetric=True, device=cell.dev)


def test_hub_split_maxk_spgemm_at_the_cell(cell, hub):
    """A float32 maxk_spgemm and its dx on the mask route: the same MaxK
    masks, so the hub graph's differ from the hub-free graph's only in
    the order of each row's sums over its edges and H columns."""
    assert hub.g_mean.hub_ids is not None
    assert hub.g_mean_t.hub_ids is not None
    h = int(hub.g_mean.hub_ids.numel())
    gen = torch.Generator(device=cell.dev).manual_seed(24)
    x = torch.randn(V, D, device=cell.dev, generator=gen)
    dy = torch.randn(V, D, device=cell.dev, generator=gen)
    results = {}
    for name, graphs in (("hub", hub), ("free", cell.bundle)):
        xx = x.clone().requires_grad_(True)
        yy = maxk_spgemm(graphs.g_mean, graphs.g_mean_t, xx, K, "float32")
        yy.backward(dy)
        results[name] = (yy.detach(), xx.grad)
    y_s, mask = maxk_forward(x, K)
    g, g_t = cell.bundle.g_mean, cell.bundle.g_mean_t
    for i, (name, g0, operand) in enumerate((("y", g, y_s),
                                             ("dx", g_t, dy))):
        g_abs = dataclasses.replace(g0, values=g0.values.abs())
        terms = spmm_csr_plain(g_abs, operand.abs()).double()
        if name == "dx":
            terms = terms * mask
        n = torch.diff(g0.indptr).to(torch.float64)[:, None] + h + 1
        bound = 2 * n * 2.0 ** -24 * terms
        diff = (results["hub"][i].double() - results["free"][i].double())
        assert float((diff.abs() / bound.clamp_min(1e-30)).max()) <= 1.0, \
            name


@pytest.mark.parametrize("route", ["mask", "cbsr"])
def test_hub_split_train_steps(cell, hub, first_losses, monkeypatch, route):
    _route(monkeypatch, route)
    losses = _train(cell, MASK_STEP if route == "mask" else CBSR_STEP,
                    graphs=hub)
    free = first_losses[route]
    assert abs(losses[0] - free) <= 1e-4 * abs(free)
