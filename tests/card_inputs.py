"""What the card tests share (``tests/test_torch_card_*.py`` and the
kernel tests of ``tests/test_torch_cuda.py``): the ``card`` fixture,
which skips without a CUDA device, the cell, the small and split-row
graphs, the two-order error bounds and the launch counts.

Nothing here touches a device when it is imported.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from maxk_tpu_torch.bench.kernel_table import (bench_dataset, cell_csr,
                                               train_config)
from maxk_tpu_torch.ops import kernel_counters
from maxk_tpu_torch.ops.graph import SEG_LEN, CSRGraph

# The cell's hidden layers.
LAYERS = 4
# The small graph's rows, and the split-row graphs'.
N_SMALL, N_SPLIT = 16384, 4096


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cell(card):
    """The 131,072-node cell on the card: its host graph, bench.py's
    dataset on it, the mean-normalised GraphBundle and SAGE 4x256's
    config (bf16, k = 32)."""
    from maxk_tpu_torch.models.models import GraphBundle
    csr = cell_csr()
    return types.SimpleNamespace(
        csr=csr, ds=bench_dataset(csr), cfg=train_config(LAYERS), dev=card,
        bundle=GraphBundle.from_csr(csr, norms=("mean",), symmetric=True,
                                    device=card))


def counts() -> dict:
    """Every kernel's launches so far, by kernel id."""
    return {name: fn.launches for name, fn in kernel_counters().items()}


def since(before: dict) -> dict:
    return {name: c - before[name] for name, c in counts().items()}


# Every kernel id at 0 launches: what a step launches, less what it names.
NONE = {name: 0 for name in kernel_counters()}


@functools.cache
def small_csr() -> CSRGraph:
    """16,384 rows of ~15 edges: every 4th row without edges, power-law
    columns, uniform values; not symmetric."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, N_SMALL, 20 * N_SMALL)
    src = src[src % 4 != 0]
    dst = np.minimum((N_SMALL * rng.power(0.3, len(src))).astype(np.int64),
                     N_SMALL - 1)
    return CSRGraph.from_coo(src, dst.astype(np.int32), N_SMALL,
                             rng.uniform(size=len(src)).astype(np.float32))


@functools.cache
def split_csr(kind: str) -> CSRGraph:
    """4,096 rows split at the segment plan's S (SEG_LEN): 'star', one
    row holding every edge (40 S + 3 of them), or 'boundary', rows of
    S - 1, S, S + 1 and 2 S + 1 edges among short and empty rows."""
    rng = np.random.default_rng({"star": 2, "boundary": 3}[kind])
    if kind == "star":
        src = np.zeros(40 * SEG_LEN + 3, np.int64)
    else:
        lens = (SEG_LEN - 1, SEG_LEN, SEG_LEN + 1, 2 * SEG_LEN + 1)
        src = np.concatenate(
            [np.full(m, 7 * (i + 1)) for i, m in enumerate(lens)]
            + [rng.integers(100, N_SPLIT // 2, 8 * N_SPLIT)])
    return CSRGraph.from_coo(
        src, rng.integers(0, N_SPLIT, len(src)).astype(np.int32), N_SPLIT,
        rng.uniform(size=len(src)).astype(np.float32))


def k7_bound(g, q, scale, row_scale: bool) -> torch.Tensor:
    """K7's bound on each entry against its plain version, 2 (n_r + 1)
    2**-24 sum_e |w_e| |q[col_e]| scale: two summation orders of the
    row's terms, and the column scale's multiply."""
    from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_plain
    g_abs = dataclasses.replace(g, values=g.values.abs())
    terms = spmm_int8_plain(g_abs, q.abs(), scale.abs(), row_scale)
    n = torch.diff(g.indptr).to(torch.float32)[:, None]
    return 2 * (n + 1) * 2.0 ** -24 * terms.double() + 1e-30


def sum_error_ratio(out, ref, g, x_abs, rel: float = 0.0) -> float:
    """max |out - ref| / bound, where bound_r = 2 * n_r * 2**-24 *
    sum_e |v_e| |x[c_e]| is the worst-case float32 error between two
    summation orders of row r's n_r terms. Hub rows (n_r ~ 1e5) make a
    fixed rtol meaningless; <= 1 is agreement. `rel` adds a rounding of
    out after the sum: bound * (1 + rel) + rel * |ref|."""
    from maxk_tpu_torch.ops.cuda_spmm import spmm_csr_plain
    g_abs = dataclasses.replace(g, values=g.values.abs())
    n = torch.diff(g.indptr).to(torch.float32)[:, None]
    bound = 2 * n * 2.0 ** -24 * spmm_csr_plain(g_abs, x_abs)
    # In float64, so that the sum of the two terms does not round below
    # what they bound.
    bound = bound.double() * (1 + rel) + rel * ref.double().abs()
    diff = (out.double() - ref.double()).abs()
    return float((diff / bound.clamp_min(1e-30)).max())
