"""Evaluation metrics matching the reference's definitions.

- compute_micro_f1: single-label -> plain argmax accuracy; multilabel ->
  micro-F1 with predictions at logit > 0 and truth at label > 0.5
  (reference utils/general_utils.py:79-99). It counts on the host, then
  micro_f1_from_counts does the arithmetic; micro_f1_counts makes the
  same counts with torch ops where the logits are (the card), so only
  the counts leave it.
- rocauc: mean ROC-AUC over targets with both classes present — the ogb
  Evaluator('ogbn-proteins') definition used at
  reference maxk_gnn_dgl.py:41-53.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def compute_micro_f1(logits: np.ndarray, y: np.ndarray,
                     mask: np.ndarray | None = None) -> float:
    logits = np.asarray(logits)
    y = np.asarray(y)
    if mask is not None:
        mask = np.asarray(mask)
        logits, y = logits[mask], y[mask]
    if y.ndim == 1:
        hits = int((logits.argmax(axis=-1) == y).sum())
        return micro_f1_from_counts((hits,), y.shape[0])
    y_pred = logits > 0
    y_true = y > 0.5
    return micro_f1_from_counts((int((y_true & y_pred).sum()),
                                 int((~y_true & y_pred).sum()),
                                 int((y_true & ~y_pred).sum())), y.shape[0])


def micro_f1_counts(logits: torch.Tensor, labels: torch.Tensor,
                    masks: torch.Tensor) -> torch.Tensor:
    """compute_micro_f1's counts for each row of ``masks`` (M, V) bool, by
    torch ops on the logits' device: (M, 1) int64 hits where ``labels`` is
    (V,) (argmax, the first index on ties and a row's first NaN, as
    ``np.argmax``), else (M, 3) tp, fp, fn of logit > 0 against
    label > 0.5."""
    if labels.dim() == 1:
        per_node = (logits.argmax(dim=-1) == labels)[:, None]
    else:
        pred, true = logits > 0, labels > 0.5
        per_node = torch.stack([(true & pred).sum(-1), (~true & pred).sum(-1),
                                (true & ~pred).sum(-1)], dim=-1)
    return (masks[:, :, None] * per_node).sum(dim=1)


def micro_f1_from_counts(counts: Sequence[int], n: int) -> float:
    """compute_micro_f1 of a mask of ``n`` nodes from its counts: (hits,)
    single-label, (tp, fp, fn) multilabel. Counts below 2**53 divide to
    the bits numpy's int64 / int gives."""
    if len(counts) == 1:
        return float(counts[0] / n) if n else 0.0
    tp, fp, fn = counts
    if tp + fp == 0 or tp + fn == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def _binary_auc(score: np.ndarray, truth: np.ndarray) -> float:
    """ROC-AUC via the rank statistic (ties handled by average rank)."""
    order = np.argsort(score, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = score[order]
    # average ranks for tied groups
    n = len(score)
    ranks[order] = np.arange(1, n + 1)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            avg = (i + j) / 2.0 + 1.0
            ranks[order[i:j + 1]] = avg
        i = j + 1
    n_pos = int(truth.sum())
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    pos_rank_sum = ranks[truth].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def rocauc(logits: np.ndarray, labels: np.ndarray,
           mask: np.ndarray | None = None) -> float:
    """Mean per-target ROC-AUC over targets with both classes present
    (ogb Evaluator 'rocauc' semantics for ogbn-proteins)."""
    logits = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels)
    if mask is not None:
        mask = np.asarray(mask)
        logits, labels = logits[mask], labels[mask]
    if labels.ndim == 1:
        labels = labels[:, None]
        logits = logits[:, None]
    aucs = []
    for t in range(labels.shape[1]):
        truth = labels[:, t] > 0.5
        a = _binary_auc(logits[:, t], truth)
        if not np.isnan(a):
            aucs.append(a)
    if not aucs:
        raise ValueError("no target column has both classes present")
    return float(np.mean(aucs))


def evaluate_logits(logits: np.ndarray, labels: np.ndarray,
                    mask: np.ndarray, metric: str) -> float:
    if metric == "micro_f1":
        return compute_micro_f1(logits, labels, mask)
    if metric == "rocauc":
        return rocauc(logits, labels, mask)
    raise ValueError(f"unknown metric {metric!r}")
