"""K1-K4, and the wide top-k kernel for D > 1024, on the card against
their plain PyTorch versions.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the ``cuda_device`` fixture, never at import). Run on a machine with an
H100 from the repo root:

  python -m pytest -m cuda --noconftest -p no:cacheprovider \
      tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need.) Tolerances: K1, K4 and both entries of the wide
kernel are bit-equal to their plain versions (same integer descent), and
K4 expanded is bit-equal to K1's y; K3 is exact (it moves bits); K2 at float32 agrees at rtol=1e-5,
atol=1e-5, since CUDA index_add_ sums in another order than the kernel's
CSR order. On the split-boundary graphs (a star row, rows of S-1, S, S+1
and 2S+1 edges) K2 is held to that plus the two-order bound of each
row's sum, 2 n_r 2**-24 sum_e |v_e x_e|, since the star row sums
hundreds of terms. K2 is bit-for-bit deterministic: two calls give the
same bits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maxk_tpu_torch.ops.cbsr import cbsr_expand
from maxk_tpu_torch.ops.cuda_gather import (cbsr_gather_forward,
                                            cbsr_gather_plain)
from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
from maxk_tpu_torch.ops.cuda_topk import (WIDE_SMEM_CAP, cbsr_topk_forward,
                                          cbsr_topk_forward_wide,
                                          cbsr_topk_plain, maxk_forward,
                                          maxk_forward_plain,
                                          maxk_forward_wide, wide_plan)
from maxk_tpu_torch.ops.graph import SEG_LEN, CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.spgemm import maxk_spgemm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32, "D"])
@pytest.mark.parametrize("d", [1025, 1100, 2048, 4096, WIDE_CAP_D,
                               WIDE_CAP_D + 1, 20000])
def test_wide_kernel_bit_equal_to_plain(cuda_device, d, k, kind):
    """Both entries of csrc/topk_wide.cu, through the public ops (which
    send D > 1024 to it) and called directly; the row in shared memory up
    to the plan's cap, streamed past it (a few rows)."""
    k = d if k == "D" else k
    in_smem = wide_plan(d).in_smem
    x = _x(kind, 256 if in_smem else 32, d,
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


def test_launch_counters_count_kernel_launches(cuda_device):
    g = DeviceCSR.from_csr(_graph("uniform", 64, seed=4), cuda_device)
    x = _x("normal", 64, 32, seed=5).to(cuda_device)
    wide = _x("normal", 8, 1100, seed=5).to(cuda_device)
    kernels = (maxk_forward, spmm_csr, cbsr_gather_forward,
               cbsr_topk_forward, maxk_forward_wide, cbsr_topk_forward_wide)
    before = [fn.launches for fn in kernels]
    maxk_forward(x, 4)
    spmm_csr(g, x)
    _, sel = cbsr_topk_forward(x, 4)
    cbsr_gather_forward(x, sel)
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
