"""On the card: a whole run of each cell on a 20,000-node graph, through
the program's CUDA kernels, comes out correct; so does the conftest's
GNN_res cell. Skips without a card.

The graph is larger than the CPU tests' 600 nodes: at 600 nodes the
worst parameter's change after three steps (``change_gap``) is a
LayerNorm vector's, moved by Adam's first sign step on gradients that are
round-off, and reads up to 3.2e-3 on the card, over the fit cell's limit;
at 20,000 nodes, as at the cell's size, it reads under half of it."""

from __future__ import annotations

import pytest

from benchmark import run as bench_run
from benchmark.spec import load_cell
from benchmark.tests.conftest import (GNNRES_CELL, GNNRES_LIMITS,
                                      add_gnnres_cell, small_root)

CARD_GRAPH = {"n_nodes": 20000, "n_edges": 400000, "max_degree": 150,
              "split": [10000, 3333, 6667]}


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    return add_gnnres_cell(
        small_root(tmp_path_factory.mktemp("bench_card_root"), CARD_GRAPH),
        GNNRES_LIMITS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sage-reddit.fit", "gcn-products.train",
                                  GNNRES_CELL])
def test_small_cell_on_the_card(card_root, cuda_device, name):
    result = bench_run.run(load_cell(name, card_root), 2**31 + 99, 0.5,
                           True, cuda_device)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    quantities = {name.split(".")[0] for name in result["metrics"]}
    assert {"k2_ms", "gemm_ms", "idle_share", "step_mfu"} <= quantities
