"""The readers of the program's spans and set-up phases (``spans.py`` and
the metrics that use it) on hand-made traces: operations launched inside
and outside a span, a span that starts while earlier work is queued,
backward operations launched from another thread under the backward
span, and None where there is nothing to read."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from benchmark.spec import load_cell
from benchmark.trace import DeviceOp, Trace

STEP_HOST = [
    (0.0, 400.0, "maxk.step"),
    (0.0, 100.0, "maxk.step.forward"),
    (100.0, 300.0, "maxk.step.backward"),
    (300.0, 310.0, "maxk.step.optimizer"),
    (1000.0, 1400.0, "maxk.step"),
    (1000.0, 1100.0, "maxk.step.forward"),
    (1100.0, 1300.0, "maxk.step.backward"),
    (1300.0, 1310.0, "maxk.step.optimizer"),
]
# (launch, start, end): the host queues ahead, so most run after their
# span has ended; 150 and 1150 are launched by autograd's device thread
# while the main thread waits inside the backward span.
STEP_OPS = [(10, 50, 80), (20, 80, 120), (150, 200, 260),
            (305, 400, 402), (320, 402, 410),        # 320: outside a span
            (1010, 1050, 1090), (1150, 1200, 1300), (1305, 1400, 1401)]

EVAL_HOST = [
    (2000.0, 2900.0, "maxk.eval"),
    (2000.0, 2100.0, "maxk.eval.forward"),
    (2100.0, 2600.0, "maxk.eval.to_host"),
    (2600.0, 2900.0, "maxk.eval.metrics"),
]
# The forward's operations run until 2400, inside the copy's span; the
# copy is launched at 2110 and runs 2400-2550.
EVAL_OPS = [(1990, 1995, 2050), (2010, 2050, 2300), (2020, 2300, 2400),
            (2110, 2400, 2550)]


def _run(host, ops, epochs=2):
    ops = [DeviceOp("k", "other", s, e, launch) for launch, s, e in ops]
    tr = Trace(sorted(ops, key=lambda o: o.start), {},
               sorted(host), (0.0, 3000.0), 0)
    return SimpleNamespace(trace=tr, epochs=epochs)


def _reader(cell: str, metric: str):
    return load_cell(cell).reader(metric)


@pytest.mark.parametrize("metric,us", [("step_fwd_ms.train", 30 + 40 + 40),
                                       ("step_bwd_ms.train", 60 + 100),
                                       ("step_opt_ms.train", 2 + 1)])
def test_step_spans_count_the_ops_they_launched(metric, us):
    got = _reader("gcn-products.train", metric)(_run(STEP_HOST, STEP_OPS))
    assert got == pytest.approx(us / 1e3 / 2)


def test_eval_forward_counts_its_launches_only():
    got = _reader("sage-reddit.fit", "eval_fwd_ms.fit")(
        _run(EVAL_HOST, EVAL_OPS, epochs=1))
    assert got == pytest.approx((250 + 100) / 1e3)


def test_eval_copy_starts_when_the_queue_drains():
    # From 2400, when the forward launched before the span is done, to
    # 2600: the device copy and the host's staging.
    run = _run(EVAL_HOST, EVAL_OPS, epochs=1)
    assert _reader("sage-reddit.fit", "eval_copy_ms.fit")(run) == \
        pytest.approx(0.2)
    # With nothing queued the span counts from its start.
    early = _run(EVAL_HOST, [(1990, 1995, 2050), (2110, 2150, 2200)], 1)
    assert _reader("sage-reddit.fit", "eval_copy_ms.fit")(early) == \
        pytest.approx(0.5)


def test_eval_host_is_the_metrics_spans():
    run = _run(EVAL_HOST + [(2950.0, 3000.0, "maxk.eval.metrics")],
               EVAL_OPS, epochs=2)
    assert _reader("sage-reddit.fit", "eval_host_ms.fit")(run) == \
        pytest.approx((300 + 50) / 1e3 / 2)


NEW = [("sage-reddit.fit", "eval_fwd_ms.fit"),
       ("sage-reddit.fit", "eval_copy_ms.fit"),
       ("sage-reddit.fit", "eval_host_ms.fit"),
       ("gcn-products.train", "step_fwd_ms.train"),
       ("gcn-products.train", "step_bwd_ms.train"),
       ("gcn-products.train", "step_opt_ms.train"),
       ("sage-reddit.fit", "build_normalize_s"),
       ("gcn-products.train", "build_plan_s"),
       ("gcn-products.train", "build_upload_s")]


@pytest.mark.parametrize("cell,metric", NEW)
def test_none_without_ops_or_spans(cell, metric):
    read = _reader(cell, metric)
    assert read(_run(STEP_HOST + EVAL_HOST, [])) is None
    if not metric.startswith("build_"):
        assert read(_run([(0.0, 9.0, "maxk.other")], STEP_OPS)) is None


@pytest.mark.parametrize("metric,phase", [
    ("build_normalize_s", "build.normalize"),
    ("build_plan_s", "build.segment_plan"),
    ("build_upload_s", "build.upload")])
def test_build_phases_read_the_last_build(monkeypatch, metric, phase):
    from maxk_tpu_torch import obs
    monkeypatch.setattr(obs, "_last", {phase: 1.25})
    read = _reader("sage-reddit.fit", metric)
    assert read(_run([], STEP_OPS)) == 1.25
    monkeypatch.setattr(obs, "_last", {})
    assert read(_run([], STEP_OPS)) is None
    # A program without the phases' module reads None.
    monkeypatch.setitem(sys.modules, "maxk_tpu_torch.obs", None)
    assert read(_run([], STEP_OPS)) is None


def test_every_new_metric_has_its_entry():
    for cell, metric in NEW:
        names = [m["name"] for m in load_cell(cell).per_layer]
        assert metric in names, (cell, metric)
