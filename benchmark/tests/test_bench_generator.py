"""The graph and node generator: exact counts, a simple symmetric graph,
a heavy tail of the published order, and the same seed the same data."""

from __future__ import annotations

import pytest
import torch

from benchmark.graphs.generate import (add_self_loops, degree_profile,
                                       make_graph, make_nodes)

V, E, MAX_DEG = 4000, 200000, 1200


def _edges(g):
    rows = torch.repeat_interleave(torch.arange(g.n_nodes), g.degrees())
    return rows, g.indices


@pytest.fixture(scope="module")
def graph():
    return make_graph(V, E, MAX_DEG, 2.0,
                      torch.Generator().manual_seed(2**31 + 9))


def test_exact_counts(graph):
    assert graph.n_nodes == V and graph.n_edges == E
    assert graph.indptr.shape == (V + 1,) and int(graph.indptr[-1]) == E


def test_simple_and_symmetric(graph):
    rows, cols = _edges(graph)
    keys = rows * V + cols
    assert torch.unique(keys).numel() == E            # no duplicates
    assert not bool((rows == cols).any())             # no self-loops
    back = torch.sort(cols * V + rows).values
    assert torch.equal(torch.sort(keys).values, back)  # symmetric
    for r in range(0, V, 397):                        # columns sorted
        seg = graph.indices[graph.indptr[r]:graph.indptr[r + 1]]
        assert bool((seg[1:] > seg[:-1]).all())


def test_heavy_tail_of_the_published_order(graph):
    deg = graph.degrees()
    assert 0.5 * MAX_DEG <= int(deg.max()) <= 1.2 * MAX_DEG
    assert float(deg.float().median()) < 0.5 * E / V
    # Node ids in random order: the largest degrees are not the first ids.
    top = torch.topk(deg, 20).indices
    assert int(top.min()) > 0 and int(top.float().mean()) > V // 10


def test_profile_is_the_same_for_every_seed():
    w = degree_profile(V, MAX_DEG / (E / V), 2.0, "cpu")
    assert w.mean().item() == pytest.approx(1.0)
    assert w[0].item() * E / V == pytest.approx(MAX_DEG, rel=0.05)
    assert bool((w[1:] <= w[:-1]).all())


def test_seeded():
    a = make_graph(500, 6000, 120, 2.0, torch.Generator().manual_seed(5))
    b = make_graph(500, 6000, 120, 2.0, torch.Generator().manual_seed(5))
    c = make_graph(500, 6000, 120, 2.0, torch.Generator().manual_seed(6))
    assert torch.equal(a.indices, b.indices)
    assert not torch.equal(a.indices, c.indices)


def test_self_loops(graph):
    g = add_self_loops(graph)
    rows, cols = _edges(g)
    assert g.n_edges == E + V
    assert int((rows == cols).sum()) == V
    assert torch.equal(g.degrees(), graph.degrees() + 1)


def test_nodes():
    n = make_nodes(1000, 7, 5, (600, 100, 300),
                   torch.Generator().manual_seed(3))
    assert n.features.shape == (1000, 7) and n.features.dtype == torch.float32
    assert int(n.labels.min()) >= 0 and int(n.labels.max()) < 5
    masks = torch.stack([n.train_mask, n.val_mask, n.test_mask])
    assert masks.sum(1).tolist() == [600, 100, 300]
    assert bool((masks.sum(0) == 1).all())           # disjoint, covering


def test_refuses_an_odd_edge_count():
    with pytest.raises(ValueError):
        make_graph(10, 7, 3, 2.0, torch.Generator())
