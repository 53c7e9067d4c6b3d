"""K5's host-side parts, on the CPU: the pack pass's plain version and
the plan's work list (``SegmentPlan.work``), which the kernel
(``csrc/spgemm_cbsr.cu``) takes in items of P segments (P = 4 at k <= 8,
2 at k <= 16, else 1), one item a warp, the blocks started in list order.

The record of a kept entry with a bfloat16 value is ``bf16 bits << 16 |
selector``, and unpacking gives back both bit for bit. The work list
holds every segment exactly once, longest first, with its first edge,
its length and its destination (its output row, or -1 - its partials
row). Longest first bounds the schedule's
waste: the lanes a shorter segment leaves idle in an item add up to at
most (P - 1) * seg_len steps over the whole list (the lengths telescope),
and W warp slots that each take the next item when free finish within
the longest segment (seg_len) of total / W steps (list scheduling).
"""

import heapq

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu_torch.ops.cuda_spgemm_cbsr import (pack_records,
                                                 pack_records_plain)
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR

from conftest import random_graph


def _table(dtype, n=257, k=33, seed=0):
    """values with both signs, +-0, +-inf, NaN and denormals; distinct
    selectors in [0, 256) per row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k)).astype(np.float32)
    x[0, :6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40]
    sel = np.stack([rng.permutation(256)[:k] for _ in range(n)])
    return (torch.from_numpy(x).to(dtype),
            torch.from_numpy(sel.astype(np.uint8)))


def test_pack_records_plain_bits():
    values, sel = _table(torch.bfloat16)
    rec = pack_records(values, sel)       # CPU tensors: the plain version
    assert torch.equal(rec, pack_records_plain(values, sel))
    bits = values.view(torch.int16).numpy().view(np.uint16)
    want = bits.astype(np.uint32) << 16 | sel.numpy().astype(np.uint32)
    assert rec.dtype == torch.int32 and rec.shape == values.shape
    np.testing.assert_array_equal(rec.numpy().view(np.uint32), want)
    # Unpacked: the value's bits and the selector, bit for bit.
    assert torch.equal((rec >> 16).to(torch.int16), values.view(torch.int16))
    assert torch.equal((rec & 0xFF).to(torch.uint8), sel)


def test_pack_records_refuses_float32():
    """float32 values keep their two arrays: no records."""
    with pytest.raises(ValueError, match="bfloat16"):
        pack_records(*_table(torch.float32))


def _graphs():
    star = CSRGraph.from_coo(np.zeros(40, np.int64),
                             np.arange(40, dtype=np.int32) % 9, 9,
                             np.ones(40, np.float32))
    g = random_graph(500, 12.0, seed=5, power_law=True)
    rows, cols = g.to_coo()
    keep = rows % 5 != 0
    holes = CSRGraph.from_coo(rows[keep], cols[keep].astype(np.int32),
                              g.n_nodes, g.values[keep])
    return {"star": star, "power_law": g, "empty_rows": holes}


@pytest.mark.parametrize("seg_len", [4, 16, 256])
@pytest.mark.parametrize("name", ["star", "power_law", "empty_rows"])
def test_work_list_covers_each_segment_once(name, seg_len):
    csr = _graphs()[name]
    plan = DeviceCSR.from_csr(csr, "cpu", seg_len=seg_len).plan
    work = plan.work
    assert work.dtype == torch.int64 and work.shape == (plan.n_segments, 2)
    start = work[:, 0]
    n = (work[:, 1] >> 32).to(torch.int32)
    dst = (work[:, 1] & 0xFFFFFFFF).to(torch.int64)
    dst = torch.where(dst >= 2**31, dst - 2**32, dst)
    # Longest first, ties in plan order: each segment once.
    assert bool((n[:-1] >= n[1:]).all())
    order = torch.argsort(start)
    assert torch.equal(start[order], plan.seg_start)
    assert torch.equal(n[order], plan.seg_edges)
    indptr = torch.from_numpy(csr.indptr)
    row = plan.seg_row.long()
    assert torch.equal(plan.seg_edges.long(), torch.clamp(
        indptr[row + 1] - plan.seg_start, max=seg_len))
    slot = plan.seg_slot.long()
    assert torch.equal(dst[order], torch.where(slot < 0, row, -1 - slot))
    assert int(n.sum()) == csr.indices.shape[0]


@pytest.mark.parametrize("per", [1, 2, 4])
@pytest.mark.parametrize("warps", [1, 3, 64, 1000])
def test_work_list_balances_warps(per, warps):
    seg_len = 16
    csr = random_graph(2000, 20.0, seed=7, power_law=True)
    plan = DeviceCSR.from_csr(csr, "cpu", seg_len=seg_len).plan
    n = (plan.work[:, 1] >> 32).numpy()
    pad = -len(n) % per
    items = np.concatenate([n, np.zeros(pad, n.dtype)]).reshape(-1, per)
    steps = items[:, 0]                   # an item runs its longest
    assert (steps == items.max(axis=1)).all()
    idle = int((steps[:, None] - items).sum())
    assert idle <= (per - 1) * seg_len
    # Each item to the slot that frees first, in list order.
    busy = [0] * warps
    for s in steps:
        heapq.heappush(busy, heapq.heappop(busy) + int(s))
    assert max(busy) <= steps.sum() / warps + seg_len
