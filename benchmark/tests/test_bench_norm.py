"""BatchNorm's yardstick: its bytes and least time (``counts/batchnorm.py``)
at the ``gnnres-products.fit`` cell's shape, and the readers of its spans
(``norm_ms``, ``norm_roofline``) on hand-made traces, None where there is
nothing to read or the spans are not as many as the passes."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.counts import batchnorm
from benchmark.spec import load_cell
from benchmark.trace import DeviceOp, Trace

CELL = "gnnres-products.fit"


def test_bytes_an_epoch_at_the_cell():
    cell = load_cell(CELL)
    cfg = cell.config
    v, d, layers = cfg["graph"]["n_nodes"], cfg["hidden_dim"], \
        cfg["hidden_layers"]
    nbytes = layers * sum(batchnorm.pass_cost(kind, v, d)[1]
                          for kind in batchnorm.PASSES)
    assert nbytes == 3 * (2 + 3 + 2) * 2449029 * 256 * 4
    assert round(nbytes / 1e9, 2) == 52.66
    least = batchnorm.least_s(layers, v, d, 1, 1, cell.peaks())
    assert least == pytest.approx(nbytes / 3.35e12)     # bytes-bound
    assert round(least * 1e3, 2) == 15.72


def test_the_cell_reports_the_fit_metrics_and_its_own():
    names = {m["name"] for m in load_cell(CELL).per_layer}
    fit = {m["name"] for m in load_cell("sage-reddit.fit").per_layer}
    assert fit <= names
    assert {"norm_ms.fit", "norm_roofline.fit"} <= names
    assert "norm_ms.fit" not in fit


def _run(epochs=1, evals=1, drop=None, ops=True):
    """A window of ``epochs`` train steps and ``evals`` evaluations of
    the cell's 3 layers: each BatchNorm forward span launches one 20 us
    operation, each backward span one 30 us operation (launched by
    another thread, inside the span). ``drop`` leaves out the first span
    of that name."""
    host, device, t = [], [], 0.0
    eval_spans = []
    for e in range(epochs):
        host.append((t, t + 400.0, "maxk.step"))
        for i in range(3):
            host.append((t + 10 * i, t + 10 * i + 5, "maxk.norm.forward"))
            device.append(DeviceOp("k", "other", t + 100 + 20 * i,
                                   t + 120 + 20 * i, t + 10 * i + 1))
        for i in range(3):
            s = t + 200 + 10 * i
            host.append((s, s + 5, "maxk.norm.backward"))
            device.append(DeviceOp("k", "other", t + 300 + 30 * i,
                                   t + 330 + 30 * i, s + 2))
        t += 1000.0
        if e < evals:
            eval_spans.append((t, t + 400.0))
            for i in range(3):
                host.append((t + 10 * i, t + 10 * i + 5,
                             "maxk.norm.forward"))
                device.append(DeviceOp("k", "other", t + 100 + 20 * i,
                                       t + 120 + 20 * i, t + 10 * i + 1))
            t += 1000.0
    # An operation launched outside any span does not count.
    device.append(DeviceOp("k", "other", t, t + 500.0, t - 1.0))
    if drop:
        host.remove(next(h for h in host if h[2] == drop))
    trace = Trace(sorted(device, key=lambda o: o.start) if ops else [],
                  {"bench.eval": eval_spans}, sorted(host), (0.0, t + 600),
                  0)
    return SimpleNamespace(cell=load_cell(CELL), trace=trace, epochs=epochs,
                           n_nodes=1000)


def _read(metric, run):
    return run.cell.reader(metric)(run)


def test_norm_ms_sums_both_spans():
    # 3 forward ops of 20 us in the step and 3 in the evaluation, 3
    # backward ops of 30 us, over 2 epochs.
    assert _read("norm_ms.fit", _run(epochs=2, evals=2)) == \
        pytest.approx((6 * 20 + 3 * 30) * 2 / 1e3 / 2)


def test_norm_roofline_is_least_time_over_norm_ms():
    run = _run(epochs=2, evals=1)
    measured_us = 2 * (3 * 20 + 3 * 30) + 3 * 20
    least_us = 1e6 * 3 * (2 * (2 + 3) + 2) * 1000 * 256 * 4 / 3.35e12
    assert _read("norm_roofline.fit", run) == \
        pytest.approx(100 * least_us / measured_us)


def _without(run, name):
    run.trace.host = [h for h in run.trace.host if h[2] != name]
    return run


@pytest.mark.parametrize("metric", ["norm_ms.fit", "norm_roofline.fit"])
def test_none_without_ops_or_spans(metric):
    assert _read(metric, _run(ops=False)) is None
    # A program without the spans, as the parent of the spans has not.
    bare = _without(_without(_run(), "maxk.norm.forward"),
                    "maxk.norm.backward")
    assert _read(metric, bare) is None
    assert _read(metric, _without(_run(), "maxk.norm.backward")) is None


@pytest.mark.parametrize("drop", ["maxk.norm.forward", "maxk.norm.backward"])
def test_roofline_none_on_a_wrong_span_count(drop):
    run = _run(epochs=2, evals=2, drop=drop)
    assert _read("norm_ms.fit", run) is not None
    assert _read("norm_roofline.fit", run) is None
    # One evaluation fewer than the window held.
    run = _run(epochs=2, evals=2)
    run.trace.spans["bench.eval"].pop()
    assert _read("norm_roofline.fit", run) is None
