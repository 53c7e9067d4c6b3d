"""K1-K7, and the wide top-k kernel for D > 1024, on the card against
their plain PyTorch versions; every kernel's build, with no spill in the
wide kernel and no int-to-float conversion in K7's SASS.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the ``cuda_device`` fixture, never at import). Run on a machine with an
H100 from the repo root:

  python -m pytest -m cuda --noconftest -p no:cacheprovider \
      tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need.) Tolerances: K1, K4 and both entries of the wide
kernel are bit-equal to their plain versions (same integer descent), and
K4 expanded is bit-equal to K1's y, on every kind of input (every exit
of the descent) also at the cell's 131,072 rows, and the wide kernel on
8,192 rows a D in shared memory (1,024 at its cap, 256 streamed); K3 is exact (it moves bits); K2 at float32 agrees at rtol=1e-5,
atol=1e-5, since CUDA index_add_ sums in another order than the kernel's
CSR order. On the split-boundary graphs (a star row, rows of S-1, S, S+1
and 2S+1 edges) K2 is held to that plus the two-order bound of each
row's sum, 2 n_r 2**-24 sum_e |v_e x_e|, since the star row sums
hundreds of terms. K2 is bit-for-bit deterministic: two calls give the
same bits. The same holds on the 131,072-node cell graph of
``bench/kernel_table.py`` (its hub rows and its rows past edge 2**31 /
D), where K2 at float32 also agrees with torch.sparse.mm at rtol 1e-5,
atol 1e-5, and on split-row graphs of 4,096 rows at the default S,
where each row of K2 lies within its two-order bound of the plain
version's and torch.sparse's. K5 equals its plain version and K2 on the
expanded operand (torch.equal: all three sum each column in edge order
with one rounding per term), and two calls give the same bits, at every
k where its dispatch changes, on graphs with an odd number of segments,
a zero-degree row between split rows, and tens of thousands of segments,
and at the cell; its pack pass equals its plain version. K6
(cbsr_expand) is bit-equal to its plain version (it moves values,
converts them with one rounding, and in its int8 mode computes the plain
version's fma, IEEE quotient and rint). K7 (the int8 SpMM) agrees with
its plain version to the two-order bound of each row's sum, 2 (n_r + 1)
2**-24 sum_e |w_e q_e scale| (the + 1: the column scale's multiply), in
both scale modes and slab widths, and at the cell also at rtol 1e-5,
atol 1e-5; two calls give the same bits, and so do its two slab widths.
The evaluation's counts made on the card (``metrics.micro_f1_counts``:
argmax with ties and a NaN, and multilabel tp, fp, fn) give the host
path's metrics exactly (``tests/test_torch_eval.py``'s cases, and at the
Reddit shape).
"""

import dataclasses

import numpy as np
import pytest
import torch

from maxk_tpu_torch.bench.kernel_table import (cell_csr, count_int_to_float,
                                               ptxas_summary, sass_functions,
                                               torch_sparse)
from maxk_tpu_torch.native.build import KERNELS, build_all, load
from maxk_tpu_torch.ops.cbsr import cbsr_expand
from maxk_tpu_torch.ops.cuda_expand import (cbsr_expand_forward,
                                            cbsr_expand_int8,
                                            cbsr_expand_int8_plain,
                                            cbsr_expand_plain)
from maxk_tpu_torch.ops.cuda_gather import (cbsr_gather_forward,
                                            cbsr_gather_plain)
from maxk_tpu_torch.ops.cuda_spgemm_cbsr import (pack_records,
                                                 pack_records_plain,
                                                 spgemm_cbsr_csr,
                                                 spgemm_cbsr_plain)
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_csr, spmm_int8_plain
from maxk_tpu_torch.ops.cuda_topk import (WIDE_SMEM_CAP, cbsr_topk_forward,
                                          cbsr_topk_forward_wide,
                                          cbsr_topk_plain, maxk_forward,
                                          maxk_forward_plain,
                                          maxk_forward_wide, wide_plan)
from maxk_tpu_torch.ops.graph import SEG_LEN, CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.train import metrics
from test_torch_eval import counted_metrics, eval_case
from card_inputs import (N_SMALL, N_SPLIT, card,  # noqa: F401
                         k7_bound, small_csr, split_csr, sum_error_ratio)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device(card):
    return card


def _x(kind, v, d, seed):
    """float32 (v, d): 'normal' (every 5th row mixed +-0.0), 'ties'
    (integers in [-3, 3]), and for K1's descent exits 'inf' (+-inf),
    'denormal' (random-sign denormals), 'zeros' (mixed +-0.0, 30 %
    normals) and 'neg_nan' (-NaN 0xFFFFFFFF, key 0; every 7th row all)."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(-3, 4, size=(v, d))
    elif kind == "denormal":
        bits = (rng.integers(0, 1 << 23, size=(v, d), dtype=np.uint32)
                | rng.integers(0, 2, size=(v, d), dtype=np.uint32) << 31)
        return torch.from_numpy(bits.view(np.float32))
    elif kind == "zeros":
        x = np.where(rng.uniform(size=(v, d)) < 0.5, 0.0, -0.0)
        x = np.where(rng.uniform(size=(v, d)) < 0.3,
                     rng.normal(size=(v, d)), x)
    else:
        x = rng.normal(size=(v, d))
        if kind == "normal":
            x[::5] = np.where(rng.uniform(size=(len(x[::5]), d)) < 0.5,
                              0.0, -0.0)
        elif kind == "inf":
            r = rng.uniform(size=(v, d))
            x[r < 0.1], x[r > 0.9] = np.inf, -np.inf
    x = x.astype(np.float32)
    if kind == "neg_nan":
        x[rng.uniform(size=(v, d)) < 0.3] = np.uint32(0xFFFFFFFF).view(
            np.float32)
        x[::7] = np.uint32(0xFFFFFFFF).view(np.float32)
    return torch.from_numpy(x)


KINDS = ["normal", "ties", "inf", "denormal", "zeros", "neg_nan"]
# The widest row the wide kernel holds in shared memory (4-byte keys).
WIDE_CAP_D = WIDE_SMEM_CAP // 4


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 8, 32, "D"])
@pytest.mark.parametrize("d", [33, 128, 200, 256, 1024])
def test_k1_bit_equal_to_plain(cuda_device, d, k, kind):
    """Every exit of the descent (none at k = D, late on ties, early
    elsewhere) meets invalid slots at D = 33 and 200."""
    k = d if k == "D" else k
    x = _x(kind, 512, d, seed=d + (0 if k == d else k)).to(cuda_device)
    y, mask = maxk_forward(x, k)
    y_ref, m_ref = maxk_forward_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
    assert torch.equal(mask, m_ref)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 8, 32, 33, "D"])
@pytest.mark.parametrize("d", [33, 128, 200, 256, 1024])
def test_k4_bit_equal_to_plain_and_to_k1(cuda_device, d, k, kind):
    """K4's descent meets every exit as K1's does; at D = 33, k = 33 is
    k = D."""
    k = d if k == "D" else k
    x = _x(kind, 512, d, seed=d + (0 if k == d else k)).to(cuda_device)
    values, selector = cbsr_topk_forward(x, k)
    v_ref, s_ref = cbsr_topk_plain(x, k)
    y, _ = maxk_forward(x, k)
    torch.cuda.synchronize()
    assert values.dtype == torch.float32 and selector.dtype == torch.int32
    assert torch.equal(values.view(torch.int32), v_ref.view(torch.int32))
    assert torch.equal(selector, s_ref)
    assert torch.equal(cbsr_expand(values, selector, d).view(torch.int32),
                       y.view(torch.int32))


# The cell's rows: K1 and K4 on every kind of input at the main path's
# row count.
CELL_ROWS = 131072


@pytest.mark.parametrize("kind", KINDS + ["randn"])
@pytest.mark.parametrize("d", [200, 256, 384])
def test_k1_and_k4_bit_equal_to_plain_at_the_cells_rows(cuda_device, d,
                                                        kind):
    """131,072 rows of each kind (and plain randn) at k = 1, 8, 32, 33,
    64 and D: K1 and K4 bit-equal to their plain versions, K4 expanded
    bit-equal to K1's y."""
    x = _x(kind, CELL_ROWS, d, seed=d).to(cuda_device)
    for k in (1, 8, 32, 33, 64, d):
        y, mask = maxk_forward(x, k)
        y_ref, m_ref = maxk_forward_plain(x, k)
        values, selector = cbsr_topk_forward(x, k)
        v_ref, s_ref = cbsr_topk_plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32)), k
        assert torch.equal(mask, m_ref), k
        assert torch.equal(values.view(torch.int32),
                           v_ref.view(torch.int32)), k
        assert torch.equal(selector, s_ref), k
        assert torch.equal(cbsr_expand(values, selector, d)
                           .view(torch.int32), y.view(torch.int32)), k


# The wide kernel's rows by D: 8,192 in shared memory, 1,024 at the plan's
# cap and one column past it, 256 well past it (streamed).
WIDE_ROWS = {WIDE_CAP_D: 1024, WIDE_CAP_D + 1: 1024, 20000: 256}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32, "D"])
@pytest.mark.parametrize("d", [1025, 1100, 2048, 4096, WIDE_CAP_D,
                               WIDE_CAP_D + 1, 20000])
def test_wide_kernel_bit_equal_to_plain(cuda_device, d, k, kind):
    """Both entries of csrc/topk_wide.cu, through the public ops (which
    send D > 1024 to it) and called directly; the row in shared memory up
    to the plan's cap, streamed past it."""
    k = d if k == "D" else k
    in_smem = wide_plan(d).in_smem
    x = _x(kind, WIDE_ROWS.get(d, 8192), d,
           seed=d + (0 if k == d else k)).to(cuda_device)
    before = (maxk_forward_wide.launches, cbsr_topk_forward_wide.launches,
              maxk_forward_wide.streamed, cbsr_topk_forward_wide.streamed)
    y, mask = maxk_forward(x, k)
    values, selector = cbsr_topk_forward(x, k)
    assert (maxk_forward_wide.launches, cbsr_topk_forward_wide.launches,
            maxk_forward_wide.streamed, cbsr_topk_forward_wide.streamed) \
        == (before[0] + 1, before[1] + 1, before[2] + (not in_smem),
            before[3] + (not in_smem))
    y_ref, m_ref = maxk_forward_plain(x, k)
    v_ref, s_ref = cbsr_topk_plain(x, k)
    y_w, m_w = maxk_forward_wide(x, k)
    torch.cuda.synchronize()
    for a, b in ((y, y_ref), (y_w, y_ref), (values, v_ref)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(mask, m_ref) and torch.equal(m_w, m_ref)
    assert torch.equal(selector, s_ref)
    assert torch.equal(cbsr_expand(values, selector, d).view(torch.int32),
                       y.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,k", [(512, 256, 32), (1001, 200, 33),
                                   (77, 1100, 5)])
def test_k3_equals_torch_gather(cuda_device, v, d, k, dtype):
    dense = _x("normal", v, d, seed=k).to(cuda_device).to(dtype)
    sel = torch.from_numpy(np.random.default_rng(d).integers(
        0, d, size=(v, k)).astype(np.int32)).to(cuda_device)
    sel[:, 0], sel[:, -1] = 0, d - 1
    out = cbsr_gather_forward(dense, sel)
    ref = cbsr_gather_plain(dense, sel)
    torch.cuda.synchronize()
    assert out.dtype == dtype and tuple(out.shape) == (v, k)
    assert torch.equal(out.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       ref.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32))


@pytest.mark.parametrize("compute_dtype", ["float32", None])
def test_cbsr_route_agrees_with_mask_route(cuda_device, compute_dtype,
                                           monkeypatch):
    g = DeviceCSR.from_csr(_graph("power_law", 512, seed=8), cuda_device)
    x = _x("normal", 512, 64, seed=9).to(cuda_device)
    dy = _x("normal", 512, 64, seed=10).to(cuda_device)
    runs = []
    for route in ("1", "0"):
        monkeypatch.setenv("MAXK_FUSED_MASK", route)
        xg = x.clone().requires_grad_(True)
        y = maxk_spgemm(g, g, xg, 16, compute_dtype)
        y.backward(dy)
        runs.append((y.detach(), xg.grad))
    (y_mask, dx_mask), (y, dx) = runs
    assert dx.dtype == torch.float32
    assert torch.equal(y, y_mask)
    if compute_dtype is None:
        dx_mask = dx_mask.to(torch.bfloat16).float()
    assert torch.equal(dx, dx_mask)


def _graph(kind, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, 12 * n)
    if kind == "power_law":
        dst = np.minimum((n * rng.power(0.3, 12 * n)).astype(np.int64),
                         n - 1)
    else:
        dst = rng.integers(0, n, 12 * n)
    if kind == "empty_rows":
        keep = src % 3 != 0
        src, dst = src[keep], dst[keep]
    vals = rng.uniform(size=len(src)).astype(np.float32)
    return CSRGraph.from_coo(src, dst.astype(np.int32), n, vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 200, 256, 1100])
@pytest.mark.parametrize("kind", ["uniform", "power_law", "empty_rows"])
def test_k2_matches_plain(cuda_device, kind, d, dtype):
    g = DeviceCSR.from_csr(_graph(kind, 512, seed=d), cuda_device)
    x = _x("normal", 512, d, seed=1).to(cuda_device).to(dtype)
    out = spmm_csr(g, x)
    ref = spmm_csr_plain(g, x)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    empty = torch.diff(g.indptr) == 0
    assert torch.all(out[empty] == 0)


def test_k2_unaligned_x_uses_scalar_loads(cuda_device):
    g = DeviceCSR.from_csr(_graph("uniform", 256, seed=3), cuda_device)
    base = _x("normal", 256 * 64 + 1, 1, seed=2).to(cuda_device).view(-1)
    x = base[1:].view(256, 64)         # 4-byte offset: no 16-byte loads
    torch.testing.assert_close(spmm_csr(g, x), spmm_csr_plain(g, x),
                               rtol=1e-5, atol=1e-5)


def _split_graph(kind, seg_len, n=64, seed=0):
    """'star': row 0 holds every edge (5 seg_len + 3 of them); 'boundary':
    rows of seg_len - 1, seg_len, seg_len + 1 and 2 seg_len + 1 edges and
    a few short rows. Both have zero-degree rows."""
    rng = np.random.default_rng(seed)
    if kind == "star":
        src = np.zeros(5 * seg_len + 3, np.int64)
    else:
        lens = {1: seg_len - 1, 2: seg_len, 3: seg_len + 1,
                5: 2 * seg_len + 1}
        src = np.concatenate([np.full(m, r) for r, m in lens.items()]
                             + [rng.integers(8, n // 2, 3 * n)])
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    vals = rng.uniform(size=len(src)).astype(np.float32)
    return CSRGraph.from_coo(src, dst, n, vals)


def _assert_k2_close(g, x, out, ref):
    g_abs = dataclasses.replace(g, values=g.values.abs())
    n = torch.diff(g.indptr).double()[:, None]
    bound = 2 * n * 2.0 ** -24 * spmm_csr_plain(g_abs, x.float().abs())
    tol = 1e-5 + 1e-5 * ref.double().abs() + bound.double()
    assert bool(((out.double() - ref.double()).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 200, 256, 1100])
@pytest.mark.parametrize("seg_len", [8, SEG_LEN])
@pytest.mark.parametrize("kind", ["star", "boundary"])
def test_k2_split_rows_match_plain(cuda_device, kind, seg_len, d, dtype):
    csr = _split_graph(kind, seg_len)
    g = DeviceCSR.from_csr(csr, cuda_device, seg_len=seg_len)
    assert g.plan.n_partials > 0
    x = _x("normal", csr.n_nodes, d, seed=d).to(cuda_device).to(dtype)
    out = spmm_csr(g, x)
    ref = spmm_csr_plain(g, x)
    torch.cuda.synchronize()
    _assert_k2_close(g, x, out, ref)
    empty = torch.diff(g.indptr) == 0
    assert bool(empty.any()) and torch.all(out[empty] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["star", "boundary"])
def test_k2_split_rows_unaligned_x(cuda_device, kind, dtype):
    csr = _split_graph(kind, 8)
    g = DeviceCSR.from_csr(csr, cuda_device, seg_len=8)
    base = _x("normal", csr.n_nodes * 256 + 1, 1, seed=4).to(cuda_device)
    x = base.to(dtype).view(-1)[1:].view(csr.n_nodes, 256)
    assert x.data_ptr() % 16 != 0
    _assert_k2_close(g, x, spmm_csr(g, x), spmm_csr_plain(g, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_is_deterministic(cuda_device, dtype):
    """Two calls give the same bits: each lane sums its columns in CSR
    order, and each split row its partials in segment order."""
    g = DeviceCSR.from_csr(_graph("power_law", 4096, seed=11).transpose(),
                           cuda_device, seg_len=16)
    assert g.plan.n_partials > 0
    x = _x("normal", 4096, 256, seed=12).to(cuda_device).to(dtype)
    first = spmm_csr(g, x)
    second = spmm_csr(g, x)
    torch.cuda.synchronize()
    assert torch.equal(second.view(torch.int32), first.view(torch.int32))


def test_k2_refuses_graph_without_plan(cuda_device):
    g = DeviceCSR.from_csr(_graph("uniform", 64, seed=4), cuda_device)
    x = _x("normal", 64, 32, seed=5).to(cuda_device)
    before = spmm_csr.launches
    with pytest.raises(ValueError, match="from_csr"):
        spmm_csr(dataclasses.replace(g, plan=None), x)
    assert spmm_csr.launches == before


def _ragged_graph(kind, seg_len):
    """Graphs whose ends K5's schedule must meet: 'odd_segments' (7
    segments: rows of 3 seg_len + 1, 5, 2 and 1 edges), 'gap' (split rows
    2 and 4 of 2 seg_len + 3 edges, zero-degree row 3 between them, a few
    short rows) and 'many' (8192 rows of ~48 edges: ~51,000 segments,
    many waves of blocks)."""
    rng = np.random.default_rng(3)
    if kind == "odd_segments":
        n, lens = 16, {1: 3 * seg_len + 1, 5: 5, 9: 2, 12: 1}
    elif kind == "gap":
        n, lens = 64, {2: 2 * seg_len + 3, 4: 2 * seg_len + 3}
    else:
        n, lens = 8192, {}
    src = np.concatenate([np.full(m, r) for r, m in lens.items()]
                         + [rng.integers(8, n // 2, 48 * n if kind == "many"
                                         else n // 4 * (kind == "gap"))])
    dst = rng.integers(0, n, len(src)).astype(np.int32)
    vals = rng.uniform(size=len(src)).astype(np.float32)
    return CSRGraph.from_coo(src.astype(np.int64), dst, n, vals)


# K5's dispatch boundaries (8 lanes a segment up to k = 8, 16 up to 16,
# then 32 lanes with 1-4 entries each), each with a D that also takes
# the scalar flush where D % 4 != 0.
K5_SHAPES = [(1, 64), (7, 63), (8, 64), (9, 200), (15, 199), (16, 200),
             (17, 64), (31, 33), (32, 256), (33, 101), (63, 64), (64, 256),
             (65, 66), (128, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", K5_SHAPES)
@pytest.mark.parametrize("kind", ["star", "boundary", "odd_segments", "gap",
                                  "many"])
def test_k5_equals_plain_and_k2_on_expansion(cuda_device, kind, k, d,
                                             dtype):
    """K5 sums each column in edge order with fmaf, as its plain version
    and as K2 on the expanded operand do: equal as values (+-0 aside)."""
    csr = (_split_graph(kind, 8) if kind in ("star", "boundary")
           else _ragged_graph(kind, 8))
    g = DeviceCSR.from_csr(csr, cuda_device, seg_len=8)
    x = _x("normal", csr.n_nodes, d, seed=k).to(cuda_device)
    values, selector = cbsr_topk_forward(x, k)
    values, sel8 = values.to(dtype), selector.to(torch.uint8)
    out = spgemm_cbsr_csr(g, values, sel8, d)
    assert torch.equal(out, spgemm_cbsr_plain(g, values, sel8, d))
    assert torch.equal(out, spmm_csr(g, cbsr_expand(values, selector, d)))
    assert torch.equal(out.view(torch.int32),
                       spgemm_cbsr_csr(g, values, sel8, d).view(torch.int32))
    empty = torch.diff(g.indptr) == 0
    assert torch.all(out[empty] == 0)


@pytest.mark.parametrize("k", [1, 7, 32, 128])
def test_k5_pack_kernel_equals_plain(cuda_device, k):
    x = _x("normal", 1000, 256, seed=k).to(cuda_device)
    values, selector = cbsr_topk_forward(x, k)
    values, sel8 = values.to(torch.bfloat16), selector.to(torch.uint8)
    assert torch.equal(pack_records(values, sel8),
                       pack_records_plain(values, sel8))


def test_launch_counters_count_kernel_launches(cuda_device):
    g = DeviceCSR.from_csr(_graph("uniform", 64, seed=4), cuda_device)
    x = _x("normal", 64, 32, seed=5).to(cuda_device)
    wide = _x("normal", 8, 1100, seed=5).to(cuda_device)
    kernels = (maxk_forward, spmm_csr, cbsr_gather_forward,
               cbsr_topk_forward, maxk_forward_wide, cbsr_topk_forward_wide,
               spgemm_cbsr_csr)
    before = [fn.launches for fn in kernels]
    maxk_forward(x, 4)
    spmm_csr(g, x)
    vals, sel = cbsr_topk_forward(x, 4)
    cbsr_gather_forward(x, sel)
    spgemm_cbsr_csr(g, vals, sel.to(torch.uint8), 32)
    spgemm_cbsr_plain(g, vals, sel.to(torch.uint8), 32)
    maxk_forward(wide, 4)
    cbsr_topk_forward(wide, 4)
    maxk_forward_plain(x, 4)
    spmm_csr_plain(g, x)
    cbsr_topk_plain(x, 4)
    cbsr_gather_plain(x, sel)
    maxk_forward_plain(wide, 4)
    cbsr_topk_plain(wide, 4)
    assert [fn.launches for fn in kernels] == [n + 1 for n in before]


def test_kernels_reject_what_they_cannot_take(cuda_device):
    """Any D is taken: D = 1056 goes to the wide kernel."""
    x = _x("normal", 64, 32, seed=6).to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        maxk_forward(x.t(), 4)
    x_wide = _x("normal", 4, 1056, seed=6).to(cuda_device)
    y, mask = maxk_forward(x_wide, 4)
    y_ref, m_ref = maxk_forward_plain(x_wide, 4)
    assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
    assert torch.equal(mask, m_ref)
    g = DeviceCSR.from_csr(_graph("uniform", 32, seed=7), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_csr(g, x[:32, :].t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        cbsr_topk_forward(x.t(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        cbsr_topk_forward(x_wide.t(), 4)
    values, selector = cbsr_topk_forward(x_wide, 4)
    v_ref, s_ref = cbsr_topk_plain(x_wide, 4)
    assert torch.equal(values.view(torch.int32), v_ref.view(torch.int32))
    assert torch.equal(selector, s_ref)
    sel = torch.zeros(64, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        cbsr_gather_forward(x.t().contiguous().t(), sel)
    with pytest.raises(ValueError, match="on"):
        cbsr_gather_forward(x, sel.cpu())


@pytest.mark.parametrize("out", ["same", "float32", "bfloat16", "int8"])
@pytest.mark.parametrize("sel", [torch.int32, torch.uint8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(1, 61), (8, 64), (32, 256), (64, 200),
                                 (128, 256), (32, 1100), (64, 2048)])
def test_k6_bit_equal_to_plain(cuda_device, k, d, dtype, sel, out):
    """One pass up to 1024 float32 columns, several past it; 16-byte
    stores where a row is whole vectors (not at D = 61, nor bf16 or int8
    rows of 200 or 1100 bytes' odd multiples), element stores else."""
    if sel == torch.uint8 and d > 256:
        pytest.skip("uint8 selectors index D <= 256")
    x = _x("normal", 777, d, seed=k + d).to(cuda_device)
    values, selector = cbsr_topk_forward(x, k)
    values, selector = values.to(dtype), selector.to(sel)
    if out == "int8":
        q, scale = cbsr_expand_int8(values, selector, d)
        q_ref, s_ref = cbsr_expand_int8_plain(values, selector, d)
        torch.cuda.synchronize()
        assert torch.equal(q, q_ref)
        assert torch.equal(scale.view(torch.int32), s_ref.view(torch.int32))
        return
    out_dtype = None if out == "same" else getattr(torch, out)
    y = cbsr_expand_forward(values, selector, d, out_dtype)
    ref = cbsr_expand_plain(values, selector, d, out_dtype)
    torch.cuda.synchronize()
    assert y.dtype == ref.dtype
    bits = torch.int32 if y.dtype == torch.float32 else torch.int16
    assert torch.equal(y.view(bits), ref.view(bits))


@pytest.mark.parametrize("sel", [torch.int32, torch.uint8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d", [(1, 16), (16, 16), (8, 61), (32, 61),
                                 (32, 256), (128, 256), (32, 1024),
                                 (200, 1024)])
def test_k6_int8_widths(cuda_device, k, d, dtype, sel):
    """K6's int8 mode where its layout changes: L = 1, 4, 16, 32 lanes a
    row (groups of 32, 8, 2, 1 rows; 777 rows leave a partial group), k
    past the kInt8Prefetch pairs a lane holds in registers (16 at D = 16,
    32 at D = 61, 128 at D = 256, 200 at D = 1024), element stores at
    D = 61. q and scale bit-equal to the plain version."""
    if sel == torch.uint8 and d > 256:
        pytest.skip("uint8 selectors index D <= 256")
    x = _x("normal", 777, d, seed=k * d).to(cuda_device)
    values, selector = cbsr_topk_forward(x, k)
    values, selector = values.to(dtype), selector.to(sel)
    q, scale = cbsr_expand_int8(values, selector, d)
    q_ref, s_ref = cbsr_expand_int8_plain(values, selector, d)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref)
    assert torch.equal(scale.view(torch.int32), s_ref.view(torch.int32))


def test_k6_drops_out_of_range_selectors(cuda_device):
    v = torch.tensor([[1.0, -2.0, 3.0], [4.0, 5.0, -6.0]],
                     device=cuda_device)
    s = torch.tensor([[0, 16, 5], [-1, 15, 40]], dtype=torch.int32,
                     device=cuda_device)
    assert torch.equal(cbsr_expand_forward(v, s, 16),
                       cbsr_expand_plain(v, s, 16))
    q, scale = cbsr_expand_int8(v, s, 16)
    q_ref, s_ref = cbsr_expand_int8_plain(v, s, 16)
    assert torch.equal(q, q_ref) and torch.equal(scale, s_ref)


@pytest.mark.parametrize("slab", [128, 256])
@pytest.mark.parametrize("row_scale", [False, True])
@pytest.mark.parametrize("d", [4, 64, 132, 256, 512])
@pytest.mark.parametrize("kind", ["uniform", "power_law", "empty_rows",
                                  "star", "boundary"])
def test_k7_matches_plain(cuda_device, kind, d, row_scale, slab):
    if kind in ("star", "boundary"):
        g = DeviceCSR.from_csr(_split_graph(kind, 8), cuda_device,
                               seg_len=8)
    else:
        g = DeviceCSR.from_csr(_graph(kind, 300, seed=d), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randint(-127, 128, (g.n_nodes, d), generator=gen,
                      device=cuda_device, dtype=torch.int8)
    n = g.n_nodes if row_scale else d
    scale = torch.rand(n, generator=gen, device=cuda_device) + 0.01
    out = spmm_int8_csr(g, q, scale, row_scale, slab)
    ref = spmm_int8_plain(g, q, scale, row_scale)
    torch.cuda.synchronize()
    assert bool(torch.all((out.double() - ref.double()).abs()
                          <= k7_bound(g, q, scale, row_scale)))
    empty = torch.diff(g.indptr) == 0
    assert torch.all(out[empty] == 0)
    again = spmm_int8_csr(g, q, scale, row_scale, slab)
    assert torch.equal(again.view(torch.int32), out.view(torch.int32))


@pytest.mark.parametrize("row_scale", [False, True])
@pytest.mark.parametrize("d", [8, 264, 512])
@pytest.mark.parametrize("kind", ["power_law", "star"])
def test_k7_slabs_bit_identical(cuda_device, kind, d, row_scale):
    """A column's sum is the same terms in the same order at either slab,
    so 128- and 256-column passes give the same bits."""
    if kind == "star":
        g = DeviceCSR.from_csr(_split_graph(kind, 8), cuda_device,
                               seg_len=8)
    else:
        g = DeviceCSR.from_csr(_graph(kind, 300, seed=d), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(d + 1)
    q = torch.randint(-128, 128, (g.n_nodes, d), generator=gen,
                      device=cuda_device, dtype=torch.int8)
    n = g.n_nodes if row_scale else d
    scale = torch.rand(n, generator=gen, device=cuda_device) + 0.01
    a = spmm_int8_csr(g, q, scale, row_scale, 128)
    b = spmm_int8_csr(g, q, scale, row_scale, 256)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_k6_k7_count_launches_and_refuse(cuda_device):
    g = DeviceCSR.from_csr(_graph("uniform", 64, seed=4), cuda_device)
    x = _x("normal", 64, 32, seed=5).to(cuda_device)
    values, selector = cbsr_topk_forward(x, 4)
    before = (cbsr_expand_forward.launches, cbsr_expand_int8.launches,
              spmm_int8_csr.launches)
    cbsr_expand_forward(values, selector, 32)
    q, scale = cbsr_expand_int8(values, selector, 32)
    spmm_int8_csr(g, q, scale, True)
    cbsr_expand_plain(values, selector, 32)
    cbsr_expand_int8_plain(values, selector, 32)
    spmm_int8_plain(g, q, scale, True)
    assert (cbsr_expand_forward.launches, cbsr_expand_int8.launches,
            spmm_int8_csr.launches) == tuple(n + 1 for n in before)
    with pytest.raises(ValueError, match="contiguous"):
        cbsr_expand_forward(values.t().contiguous().t(), selector, 32)
    with pytest.raises(ValueError, match="D % 4"):
        spmm_int8_csr(g, q[:, :30].contiguous(), scale, True)
    with pytest.raises(ValueError, match="scale"):
        spmm_int8_csr(g, q, scale[:10], True)


@pytest.mark.parametrize("v,c", [(300, 5), (232965, 41)])
@pytest.mark.parametrize("multilabel", [False, True],
                         ids=["single_label", "multilabel"])
def test_eval_counts_on_the_card_equal_the_host_metrics(cuda_device,
                                                        multilabel, v, c):
    logits, labels, masks = eval_case(multilabel, v, c)
    want = [metrics.evaluate_logits(logits, labels, m, "micro_f1")
            for m in masks]
    assert counted_metrics(logits, labels, masks, cuda_device) == want


def test_every_kernel_builds_and_the_wide_kernel_spills_nothing(
        cuda_device):
    """nvcc builds every kernel source at once; topk_wide.cu's 8
    instantiations (two entries, four widths of a lane's keys) use no
    local memory for spills."""
    built = build_all()
    assert set(built) == set(KERNELS)
    wide = ptxas_summary(built["topk_wide"]["ptxas"])
    assert len(wide) == 8, wide
    assert all(r.get("spill_stores", 1) == r.get("spill_loads", 1) == 0
               for r in wide), wide


def test_k2_on_the_small_graph(cuda_device):
    """16,384 rows, a quarter of them empty: float32 at rtol 1e-5, atol
    1e-5 of the plain version, bfloat16 within a mean error of 1e-3."""
    g = DeviceCSR.from_csr(small_csr(), cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn(N_SMALL, 256, device=cuda_device, generator=gen)
    out = spmm_csr(g, x)
    torch.testing.assert_close(out, spmm_csr_plain(g, x), rtol=1e-5,
                               atol=1e-5)
    assert bool(torch.all(out[torch.diff(g.indptr) == 0] == 0))
    x16 = x.to(torch.bfloat16)
    assert float((spmm_csr(g, x16) - spmm_csr_plain(g, x16)).abs()
                 .mean()) < 1e-3


@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["star", "boundary"])
def test_k2_split_rows_within_two_orders_of_plain_and_torch_sparse(
        cuda_device, kind, dtype, d):
    """Rows split at the plan's S (a star row of 40 S + 3 edges; rows of
    S - 1, S, S + 1, 2 S + 1): each row within the two-order bound of the
    plain version's, and at float32 of torch.sparse's, which sums without
    the plan."""
    g = DeviceCSR.from_csr(split_csr(kind), cuda_device)
    assert g.plan.n_partials > 0
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.randn(N_SPLIT, d, device=cuda_device,
                    generator=gen).to(dtype)
    out = spmm_csr(g, x)
    assert sum_error_ratio(out, spmm_csr_plain(g, x), g,
                           x.float().abs()) <= 1.0
    assert bool(torch.all(out[torch.diff(g.indptr) == 0] == 0))
    if dtype == torch.float32:
        lib = torch.sparse.mm(torch_sparse(g), x)
        assert sum_error_ratio(out, lib, g, x.abs()) <= 1.0


@pytest.fixture(scope="module")
def cell_graph(card):
    """The mean-normalised 131,072-node cell graph on the card, and x of
    (131072, 256) float32."""
    g = DeviceCSR.from_csr(cell_csr().normalize("mean"), card)
    gen = torch.Generator(device=card).manual_seed(3)
    return g, torch.randn(g.n_nodes, 256, device=card, generator=gen)


def test_k2_at_the_cell(cell_graph):
    """At float32 within rtol 1e-5, atol 1e-5 of torch.sparse.mm (rows
    past edge 2**31 / D among them), at bfloat16 within 1e-4 of the plain
    version; at both, two calls give the same bits on the hub graph."""
    g, x = cell_graph
    out = spmm_csr(g, x)
    torch.testing.assert_close(out, torch.sparse.mm(torch_sparse(g), x),
                               rtol=1e-5, atol=1e-5)
    x16 = x.to(torch.bfloat16)
    out16 = spmm_csr(g, x16)
    assert float((out16 - spmm_csr_plain(g, x16)).abs().max()) < 1e-4
    for xx, first in ((x16, out16), (x, out)):
        assert torch.equal(spmm_csr(g, xx).view(torch.int32),
                           first.view(torch.int32))


@pytest.mark.parametrize("k", [16, 32, 64])
def test_k5_at_the_cell(cell_graph, k):
    """K5 on bfloat16 values equals K2 on the expanded operand; at k = 32,
    the main path's shape, also its plain version, and its pack pass
    equals the pack's plain version."""
    g, x = cell_graph
    values, selector = cbsr_topk_forward(x, k)
    vb, sel8 = values.to(torch.bfloat16), selector.to(torch.uint8)
    out = spgemm_cbsr_csr(g, vb, sel8, 256)
    assert torch.equal(out, spmm_csr(g, cbsr_expand(vb, selector, 256)))
    if k == 32:
        assert torch.equal(out, spgemm_cbsr_plain(g, vb, sel8, 256))
        assert torch.equal(pack_records(vb, sel8),
                           pack_records_plain(vb, sel8))


def test_k7_has_no_int_to_float_conversion(cuda_device):
    """K7 converts its int8 values with a byte permute and an add: no
    I2F or I2FP in the SASS of spmm_int8_segment_kernel's 4
    instantiations."""
    sass = sass_functions(load("spmm_int8")._name,
                          "spmm_int8_segment_kernel")
    assert len(sass) == 4
    assert {n: count_int_to_float(f) for n, f in sass.items()} == {
        n: 0 for n in sass}


@pytest.mark.parametrize("row_scale", [False, True])
def test_k7_at_the_cell(cell_graph, row_scale):
    """Both scale modes (the per-column table of x, the per-row table of
    its k = 32 CBSR rows) and slab widths at the cell, whose rows past
    edge 2**31 / D are among those compared: within rtol 1e-5, atol 1e-5
    of the plain version and each row's two-order bound; two calls, and
    the two slabs, give the same bits."""
    from maxk_tpu_torch.ops.spmm import quantize_columns
    g, x = cell_graph
    assert int((g.indptr[:-1] * 256 > 2**31).sum()) > 0
    if row_scale:
        q, scale = cbsr_expand_int8(*cbsr_topk_forward(x, 32), 256)
    else:
        q, scale = quantize_columns(x)
    ref = spmm_int8_plain(g, q, scale, row_scale)
    bound = k7_bound(g, q, scale, row_scale)
    outs = []
    for slab in (128, 256):
        out = spmm_int8_csr(g, q, scale, row_scale, slab)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        assert bool(torch.all((out.double() - ref.double()).abs() <= bound))
        assert bool(torch.all(out[torch.diff(g.indptr) == 0] == 0))
        assert torch.equal(spmm_int8_csr(g, q, scale, row_scale, slab)
                           .view(torch.int32), out.view(torch.int32))
        outs.append(out)
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))
