"""The port's spans and set-up phases (``maxk_tpu_torch/obs.py``): the
shared no-op without a profiler, the train step's and the evaluation's
spans in an exported trace, each child inside its parent, and the
Trainer's build phases."""

import contextlib
import dataclasses
import json
import time
import types

import numpy as np
import pytest
from torch import profiler

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu_torch import obs
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.ops.graph import CSRGraph
from maxk_tpu_torch.train.loop import Trainer

STEP = ("maxk.step", ("maxk.step.forward", "maxk.step.backward",
                      "maxk.step.optimizer"))
EVAL = ("maxk.eval", ("maxk.eval.forward", "maxk.eval.to_host",
                      "maxk.eval.metrics"))


def _config(model="sage"):
    return types.SimpleNamespace(
        model=model, hidden_dim=16, hidden_layers=2, maxk=4, dropout=0.5,
        norm=True, nonlinear="maxk", w_lr=0.01, w_weight_decay=0.0,
        enable_lookahead=False, seed=5, compute_dtype="float32",
        device="cpu")


def _dataset(symmetric=False):
    ds = make_synthetic_dataset(n_nodes=200, avg_degree=6.0, n_classes=4,
                                in_size=12, seed=1)
    if not symmetric:
        return ds
    rows, cols = ds.csr.to_coo()
    csr = CSRGraph.from_coo(np.concatenate([rows, cols]),
                            np.concatenate([cols, rows]).astype(np.int32),
                            ds.csr.n_nodes)
    return dataclasses.replace(ds, csr=csr, symmetric=True)


def test_span_without_profiler_is_the_shared_noop():
    a, b = obs.span("maxk.step"), obs.span("maxk.eval")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a, b:
        pass
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU]):
        assert obs.span("maxk.step") is not a
    assert obs.span("maxk.step") is a


def _spans(prof, tmp_path) -> dict:
    """name -> [(start, end)] of the exported trace's ``maxk.`` spans."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("maxk."):
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    return out


def test_step_and_eval_spans_nest(tmp_path):
    tr = Trainer(_config(), _dataset())
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU]) as p:
        tr.train_step()
        tr.evaluate_masks()
    spans = _spans(p, tmp_path)
    for parent, children in (STEP, EVAL):
        assert len(spans.get(parent, ())) == 1, spans
        (lo, hi), = spans[parent]
        last = lo
        for child in children:
            assert len(spans.get(child, ())) == 1, (child, spans)
            (s, e), = spans[child]
            assert last <= s <= e <= hi, (child, spans)
            last = e
    # No span of a set-up phase: the Trainer was built before the trace.
    assert not [n for n in spans if n.startswith("maxk.build.")]


@pytest.mark.parametrize("symmetric", [False, True],
                         ids=["transposed", "symmetric"])
def test_build_phases(symmetric):
    ds = _dataset(symmetric)
    t0 = time.perf_counter()
    tr = Trainer(_config(), ds)
    wall = time.perf_counter() - t0
    phases = tr.build_phases
    assert tuple(phases) == obs.BUILD_PHASES
    assert all(s >= 0.0 for s in phases.values())
    assert sum(phases.values()) <= wall
    for name in ("build.normalize", "build.segment_plan", "build.upload",
                 "build.model"):
        assert phases[name] > 0.0, phases
    # A symmetric graph's mean transpose is a rescale of A's values.
    assert (phases["build.transpose"] > 0.0) is not symmetric
    assert obs.last_build() == phases


def test_build_phases_under_the_profiler(tmp_path):
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU]) as p:
        tr = Trainer(_config("gcn"), _dataset())
    spans = _spans(p, tmp_path)
    for name, seconds in tr.build_phases.items():
        assert (f"maxk.{name}" in spans) is (seconds > 0.0), (name, spans)


def test_phases_do_not_nest():
    with obs.building() as phases:
        with obs.phase("build.upload"):
            with obs.phase("build.model"):
                time.sleep(0.01)
    assert phases["build.model"] == 0.0
    assert phases["build.upload"] >= 0.01
    assert obs.last_build() == phases


def test_nothing_published_outside_a_build_or_from_a_failed_one():
    before = obs.last_build()
    with obs.phase("build.upload"):
        pass
    with pytest.raises(RuntimeError):
        with obs.building():
            with obs.phase("build.model"):
                raise RuntimeError("the constructor failed")
    assert obs.last_build() == before
