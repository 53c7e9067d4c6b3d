"""The yardstick's counts against hand counts at a small shape: K2's
operations and bytes and its plan's size, and each model's FLOPs."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.counts import k2
from benchmark.reference import gcn, sage


def test_k2_launch_by_hand():
    # V = 3 rows, E = 5 edges, D = 4: segments 1 + 2 + 0 at seg_len 2.
    deg = torch.tensor([1, 4, 0])
    n_seg, n_fin = k2.plan_sizes(deg, seg_len=2)
    assert (n_seg, n_fin) == (3, 2)      # row 1 is split, row 2 empty
    flops, nbytes = k2.launch_cost(3, 5, n_seg, n_fin, 4, table_bytes=2)
    assert flops == 2 * 5 * 4
    assert nbytes == (3 * 4 * 2 + 4 * 8 + 5 * 8 + 3 * 16 + 2 * 4 + 3 * 8
                      + 3 * 4 * 4)


def test_plan_sizes_follow_the_program_plan():
    from maxk_tpu_torch.ops.graph import CSRGraph, SegmentPlan
    rng = np.random.default_rng(0)
    deg = np.concatenate([[0, 0, 700, 256, 257, 1], rng.integers(0, 40, 50)])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    csr = CSRGraph(indptr, rng.integers(0, len(deg), int(deg.sum())))
    plan = SegmentPlan.build(csr, k2.SEG_LEN)
    assert k2.plan_sizes(torch.from_numpy(deg)) == (
        plan.n_segments, int(plan.fin_row.shape[0]))


CFG = {"hidden_dim": 8, "hidden_layers": 2}


def test_sage_flops_by_hand():
    v, e, f, c, d = 10, 30, 5, 3, 8
    lin_in = 2 * v * f * d
    hidden = 2 * v * d * d
    lin_out = 2 * v * d * c
    agg = 2 * e * d
    fwd = lin_in + 2 * 2 * hidden + lin_out + 2 * agg
    bwd = lin_in + 2 * 2 * 2 * hidden + 2 * lin_out + 2 * agg
    assert sage.flops(CFG, v, e, f, c) == (fwd + bwd, fwd)
    assert sage.k2_launches(CFG) == {"train": [(4, d)], "eval": [(2, d)]}


def test_gcn_flops_by_hand():
    v, e, f, c, d = 10, 30, 5, 3, 8
    lin_in = 2 * v * f * d
    hidden = 2 * v * d * d
    lin_out = 2 * v * d * c
    agg = 2 * e * d
    fwd = lin_in + 2 * hidden + lin_out + 2 * agg
    bwd = lin_in + 2 * 2 * hidden + 2 * lin_out + 2 * agg
    assert gcn.flops(CFG, v, e, f, c) == (fwd + bwd, fwd)
    assert gcn.k2_launches(CFG) == {"train": [(4, d)], "eval": [(2, d)]}
