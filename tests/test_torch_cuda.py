"""K1 and K2 on the card against their plain PyTorch versions.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the ``cuda_device`` fixture, never at import). Run on a machine with an
H100 from the repo root:

  python -m pytest -m cuda --noconftest -p no:cacheprovider \
      tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not need.) Tolerances: K1 is bit-equal to its plain version
(same integer descent); K2 at float32 agrees at rtol=1e-5, atol=1e-5,
since CUDA index_add_ sums in another order than the kernel's CSR order.
"""

import numpy as np
import pytest
import torch

from maxk_tpu_torch.ops.cuda_spmm import spmm_csr, spmm_csr_plain
from maxk_tpu_torch.ops.cuda_topk import maxk_forward, maxk_forward_plain
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _x(kind, v, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(-3, 4, size=(v, d))
    else:
        x = rng.normal(size=(v, d))
        x[::5] = np.where(rng.uniform(size=(len(x[::5]), d)) < 0.5, 0.0,
                          -0.0)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("k", [1, 8, 32, "D"])
@pytest.mark.parametrize("d", [128, 200, 256, 1024])
def test_k1_bit_equal_to_plain(cuda_device, d, k, kind):
    k = d if k == "D" else k
    x = _x(kind, 512, d, seed=d + (0 if k == d else k)).to(cuda_device)
    y, mask = maxk_forward(x, k)
    y_ref, m_ref = maxk_forward_plain(x, k)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32))
    assert torch.equal(mask, m_ref)


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


def test_launch_counters_count_kernel_launches(cuda_device):
    g = DeviceCSR.from_csr(_graph("uniform", 64, seed=4), cuda_device)
    x = _x("normal", 64, 32, seed=5).to(cuda_device)
    k1, k2 = maxk_forward.launches, spmm_csr.launches
    maxk_forward(x, 4)
    spmm_csr(g, x)
    maxk_forward_plain(x, 4)
    spmm_csr_plain(g, x)
    assert (maxk_forward.launches, spmm_csr.launches) == (k1 + 1, k2 + 1)


def test_kernels_reject_what_they_cannot_take(cuda_device):
    x = _x("normal", 64, 32, seed=6).to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        maxk_forward(x.t(), 4)
    with pytest.raises(ValueError, match="1024"):
        maxk_forward(torch.zeros(4, 1056, device=cuda_device), 4)
    g = DeviceCSR.from_csr(_graph("uniform", 32, seed=7), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_csr(g, x[:32, :].t().contiguous().t())
