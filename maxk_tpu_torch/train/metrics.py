"""Evaluation metrics matching the reference's definitions.

- compute_micro_f1: single-label -> plain argmax accuracy; multilabel ->
  micro-F1 with predictions at logit > 0 and truth at label > 0.5
  (reference utils/general_utils.py:79-99).
- rocauc: mean ROC-AUC over targets with both classes present — the ogb
  Evaluator('ogbn-proteins') definition used at
  reference maxk_gnn_dgl.py:41-53.
"""

from __future__ import annotations

import numpy as np


def compute_micro_f1(logits: np.ndarray, y: np.ndarray,
                     mask: np.ndarray | None = None) -> float:
    logits = np.asarray(logits)
    y = np.asarray(y)
    if mask is not None:
        mask = np.asarray(mask)
        logits, y = logits[mask], y[mask]
    if y.ndim == 1:
        if y.size == 0:
            return 0.0
        return float((logits.argmax(axis=-1) == y).sum() / y.shape[0])
    y_pred = logits > 0
    y_true = y > 0.5
    tp = int((y_true & y_pred).sum())
    fp = int((~y_true & y_pred).sum())
    fn = int((y_true & ~y_pred).sum())
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
