"""The evaluation's metrics from counts made where the logits are
(``metrics.micro_f1_counts``, ``FitLoop.evaluate_masks``): the counts and
the host's arithmetic on them equal ``metrics.evaluate_logits`` on the
copied logits, bit for bit (``==``), and the counter says where the
metrics ran. ``tests/test_torch_cuda.py`` holds the same cases on the
card."""

import types

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu_torch import obs
from maxk_tpu_torch.data.datasets import (make_synthetic_dataset,
                                          make_synthetic_multilabel_dataset)
from maxk_tpu_torch.train import metrics
from maxk_tpu_torch.train.loop import Trainer

MASKS = ["random", "empty", "all_right", "none_right"]


def eval_case(multilabel: bool, v: int = 300, c: int = 5, seed: int = 3):
    """(logits (v, c) float32, labels, masks (4, v) bool in MASKS order).
    Logits rounded to 0.1, so rows tie, and the first 10 all_right rows
    tie at their largest value with the last column; row 7 holds a NaN,
    which np.argmax picks, and is labelled so in the random mask. The
    all_right and none_right rows get labels that make every prediction
    right or wrong."""
    rng = np.random.default_rng(seed)
    logits = np.round(rng.normal(size=(v, c)), 1).astype(np.float32)
    rows = rng.permutation(np.delete(np.arange(v), 7))
    right, wrong = rows[:40], rows[40:80]
    logits[right[:10], c - 1] = logits[right[:10]].max(axis=-1)
    logits[7, 2] = np.nan
    if multilabel:
        labels = (rng.uniform(size=(v, c)) < 0.4).astype(np.float32)
        pred = logits > 0
        labels[right] = pred[right]
        # No row of the none_right mask has a true positive.
        labels[wrong] = ~pred[wrong]
    else:
        labels = rng.integers(0, c, v)
        top = np.argmax(logits, axis=-1)
        labels[right] = top[right]
        labels[wrong] = (top[wrong] + 1) % c
        labels[7] = 2
    masks = np.zeros((len(MASKS), v), bool)
    masks[0] = rng.uniform(size=v) < 0.6
    masks[0, 7] = True
    masks[2, right] = True
    masks[3, wrong] = True
    return logits, labels, masks


def counted_metrics(logits, labels, masks, device):
    """Each mask's micro_f1 from the counts made on ``device``."""
    counts = metrics.micro_f1_counts(
        torch.from_numpy(logits).to(device),
        torch.from_numpy(labels).to(device),
        torch.from_numpy(masks).to(device)).tolist()
    return [metrics.micro_f1_from_counts(c, int(m.sum()))
            for c, m in zip(counts, masks)]


@pytest.mark.parametrize("multilabel", [False, True],
                         ids=["single_label", "multilabel"])
def test_counts_equal_the_host_metrics(multilabel):
    logits, labels, masks = eval_case(multilabel)
    want = [metrics.evaluate_logits(logits, labels, m, "micro_f1")
            for m in masks]
    assert counted_metrics(logits, labels, masks, "cpu") == want
    assert want[1] == 0.0 and want[2] == 1.0 and want[3] == 0.0
    assert 0.0 < want[0] < 1.0


def _config(**over):
    return types.SimpleNamespace(**{**dict(
        model="sage", hidden_dim=16, hidden_layers=2, maxk=4, dropout=0.5,
        norm=True, nonlinear="maxk", w_lr=0.01, w_weight_decay=0.0,
        enable_lookahead=False, seed=5, compute_dtype="float32",
        device="cpu"), **over})


def _host_triple(tr):
    ds = tr.dataset
    logits = tr.eval_logits().float().numpy()
    return tuple(metrics.evaluate_logits(logits, ds.labels, m, ds.metric)
                 for m in (ds.train_mask, ds.val_mask, ds.test_mask))


@pytest.mark.parametrize("dataset,where", [
    (lambda: make_synthetic_dataset(n_nodes=200, avg_degree=6.0,
                                    n_classes=4, in_size=12, seed=1),
     "device"),
    (lambda: make_synthetic_multilabel_dataset(
        n_nodes=200, avg_degree=6.0, n_clusters=4, n_targets=6,
        in_size=12, seed=1),
     "device"),
    (lambda: make_synthetic_multilabel_dataset(
        n_nodes=200, avg_degree=6.0, n_clusters=4, n_targets=6,
        in_size=12, seed=1, metric="rocauc"), "host"),
], ids=["single_label", "multilabel", "rocauc"])
def test_evaluate_masks_is_the_host_triple(dataset, where):
    """``evaluate_masks`` after two steps gives the triple the host path
    computes from ``eval_logits()``, calls ``eval_logits`` once, keeps the
    device's targets, and counts where its metrics ran."""
    tr = Trainer(_config(), dataset())
    for _ in range(2):
        tr.train_step()
    counters = obs.counters()
    before = dict(counters)
    calls = []
    eval_logits = tr.eval_logits

    def spy():
        calls.append(1)
        return eval_logits()

    tr.eval_logits = spy
    got = tr.evaluate_masks()
    del tr.eval_logits
    assert calls == [1]
    assert got == _host_triple(tr)
    other = {"device": "host", "host": "device"}[where]
    assert counters[f"eval.metrics.{where}"] == \
        before[f"eval.metrics.{where}"] + 1
    assert counters[f"eval.metrics.{other}"] == \
        before[f"eval.metrics.{other}"]
    assert (tr._eval_targets is None) is (where == "host")
    targets = tr._eval_targets
    if targets is not None:
        # The Trainer's labels serve: no second copy on the device.
        assert targets[0] is tr.labels
    assert tr.evaluate_masks() == got
    assert tr._eval_targets is targets
