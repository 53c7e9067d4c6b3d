"""A whole run of each cell on the CPU at a small graph, every width as
configured, the conftest's GNN_res cell among them: the result line's
format, ``correct`` true; ``correct`` false with the timed path broken
underneath (each fault the cell can have); the control (the reference
with TF32 Dense products in the program's place) failing the cell's
limits on three seeds; and the inputs of the cells whose model has no
state drawn as they were before models could have state."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import cell as bench_cell
from benchmark import run as bench_run
from benchmark import readings
from benchmark.check import judge
from benchmark.spec import load_cell
from benchmark.tests.conftest import GNNRES_CELL

CELLS = ("sage-reddit.fit", "gcn-products.train", GNNRES_CELL)
SEED = 2**31 + 1234


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(small, name, trace):
    cell = load_cell(name, small)
    result = bench_run.run(cell, SEED, 0.2, bool(trace), "cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    want = cell.per_layer if trace else cell.end_to_end
    units = {m["name"]: m["unit"] for m in want}
    for key, m in line["metrics"].items():
        assert m["unit"] == units[key] and isinstance(m["value"], float)
    if trace:
        # On the CPU only the host's reading: no device metric.
        assert set(line["metrics"]) == {"trainer_build_s"}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == set(units)
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])


def _frozen_step(monkeypatch):
    from maxk_tpu_torch.train.loop import Trainer
    step = Trainer.train_step

    def frozen(self):
        saved = [p.detach().clone() for p in self.model.parameters()]
        loss = step(self)
        with torch.no_grad():
            for p, s in zip(self.model.parameters(), saved):
                p.copy_(s)
        return loss

    monkeypatch.setattr(Trainer, "train_step", frozen)


def _half_batch(monkeypatch):
    from maxk_tpu_torch.train import loop
    loss = loop.masked_loss

    def half(logits, labels, mask, multilabel):
        idx = torch.nonzero(mask)[:, 0]
        kept = torch.zeros_like(mask)
        kept[idx[:idx.shape[0] // 2]] = True
        return loss(logits, labels, kept, multilabel)

    monkeypatch.setattr(loop, "masked_loss", half)


def _altered_answer(monkeypatch):
    from maxk_tpu_torch.train.loop import Trainer
    logits = Trainer.eval_logits

    def altered(self):
        out = logits(self).clone()
        out[::10] += 1.0
        return out

    monkeypatch.setattr(Trainer, "eval_logits", altered)


def _still_running_stats(monkeypatch):
    """BatchNorm's running statistics never move: state_gap reads 1."""
    from maxk_tpu_torch.models.models import BatchNorm
    monkeypatch.setattr(BatchNorm, "momentum", 1.0)


def _eval_batch_stats(monkeypatch):
    """The evaluation normalises with the batch's statistics, not the
    running ones, and leaves those as they were."""
    from maxk_tpu_torch.models.models import BatchNorm
    forward = BatchNorm.forward

    def batch_stats(self, x, training, n_valid=None):
        if training:
            return forward(self, x, training, n_valid)
        kept = self.running_mean.clone(), self.running_var.clone()
        out = forward(self, x, True, n_valid)
        self.running_mean.copy_(kept[0])
        self.running_var.copy_(kept[1])
        return out

    monkeypatch.setattr(BatchNorm, "forward", batch_stats)


FAULTS = [("sage-reddit.fit", _frozen_step), ("sage-reddit.fit", _half_batch),
          ("sage-reddit.fit", _altered_answer),
          ("gcn-products.train", _frozen_step),
          ("gcn-products.train", _half_batch),
          (GNNRES_CELL, _frozen_step), (GNNRES_CELL, _half_batch),
          (GNNRES_CELL, _altered_answer), (GNNRES_CELL, _still_running_stats),
          (GNNRES_CELL, _eval_batch_stats)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_fault_is_not_correct(small, monkeypatch, name, fault):
    fault(monkeypatch)
    result = bench_run.run(load_cell(name, small), SEED, 0.1, False, "cpu")
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(small, name):
    cell = load_cell(name, small)
    for seed in (1, 2**31 + 3, 2**32 + 7):
        got = readings.readings(cell, seed, "cpu", control=True)
        assert judge(got["program"], cell.limits)[0], got["program"]
        assert not judge(got["control"], cell.limits)[0], got["control"]
        assert not judge(got["half_batch"], cell.limits)[0]
        # Only a model with state has a state_gap.
        assert ("state_gap" in got["program"]) \
            == hasattr(cell.reference(), "state_specs")


def _digest(inputs) -> str:
    h = hashlib.sha256()
    for a in (inputs.indptr, inputs.indices, inputs.features, inputs.labels,
              *inputs.masks, *inputs.ref_graph):
        h.update(np.ascontiguousarray(a).tobytes())
    for name, v in inputs.params.items():
        h.update(name.encode())
        h.update(v.numpy().tobytes())
    h.update(str(inputs.dropout_seed).encode())
    return h.hexdigest()


# make_inputs's graph, node data, weights and dropout seed for SEED at the
# small graph, as drawn before models could have state.
DIGESTS = {
    "sage-reddit.fit":
        "4b2d0f2f42196f52e66ced0caf78809fc5ebc1fd5f9471a20508ba7b6662b9b6",
    "gcn-products.train":
        "5152901bbb24a47a56c96712d96b1da43295ea32c8fd7a385ea00890490d633e",
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_inputs_without_state_are_as_before(small, name):
    inputs = bench_cell.make_inputs(load_cell(name, small), SEED, "cpu")
    assert inputs.state == {}
    assert _digest(inputs) == DIGESTS[name]
