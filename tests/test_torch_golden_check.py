"""The golden checks of maxk_tpu_torch/tools/golden_accuracy.py, on the
CPU: the one-sided Fisher exact tail test, and what check_golden holds
on made-up runs. Exact arithmetic: the p values are compared at rel
1e-12."""

import math

import pytest

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu_torch.tools import golden_accuracy as ga


@pytest.mark.parametrize("k,n,k_ref,n_ref,p", [
    (0, 32, 0, 32, 1.0),
    # All k of the k runs below the tail fall among the port's: C(n,k)/C(n+n_ref,k).
    (2, 32, 0, 32, math.comb(32, 2) / math.comb(64, 2)),
    (5, 32, 0, 32, math.comb(32, 5) / math.comb(64, 5)),
    # k = 1 of 2: the tail sums the outcomes 1 and 2 below among the port's.
    (1, 32, 1, 32, (32 * 32 + math.comb(32, 2)) / math.comb(64, 2)),
])
def test_tail_p(k, n, k_ref, n_ref, p):
    assert ga.tail_p(k, n, k_ref, n_ref) == pytest.approx(p, rel=1e-12)


def _runs(model, tests, seeds=None):
    seeds = seeds or range(97, 97 + len(tests))
    return [dict(model=model, seed=s, best_test=t) for s, t in zip(seeds, tests)]


def _gnn_res(tests):
    return ga.golden_row("gnn_res", _runs(
        "gnn_res", tests, ga.GOLDEN_REF["gnn_res"]["seeds"]))


def test_row_models_held_to_baseline():
    ok = ga.golden_row("gcn", _runs("gcn", [0.999] * 16))
    ga.check_golden(ok)
    low = ga.golden_row("gcn", _runs("gcn", [0.97] * 16))
    with pytest.raises(RuntimeError, match="from 0.999"):
        ga.check_golden(low)


def test_gnn_res_two_low_seeds_pass():
    """The card's draw: 2 of 32 below 0.93, the mean 0.010 below the
    reference's."""
    tests = [0.9748] * 30 + [0.66, 0.926]
    row = _gnn_res(tests)
    assert row["n_below_tail"] == 2
    ga.check_golden(row)


def test_gnn_res_collapse_on_a_quarter_fails():
    row = _gnn_res([0.99] * 24 + [0.5] * 8)
    with pytest.raises(RuntimeError, match="from the reference's"):
        ga.check_golden(row)


def test_gnn_res_tail_fails_with_a_good_mean():
    """Five seeds just below the tail and the rest high: the mean holds,
    the tail does not."""
    row = _gnn_res([0.98] * 27 + [0.92] * 5)
    assert abs(row["reference_gap"]) <= ga.GOLDEN_TOL
    with pytest.raises(RuntimeError, match="Fisher"):
        ga.check_golden(row)


def test_gnn_res_other_seeds_fail():
    row = ga.golden_row("gnn_res", _runs("gnn_res", [0.98] * 32,
                                         range(200, 232)))
    with pytest.raises(RuntimeError, match="not the reference's"):
        ga.check_golden(row)
