"""The port's CBSR ops (``ops/cbsr.py``) vs ``maxk_tpu.ops.cbsr``.

``cbsr_topk`` runs K4's plain version here. It is bit-equal (values and
selectors) to the JAX package's ``cbsr_topk`` (``lax.top_k`` on the CPU,
first-index ties) and to the TPU kernel in interpret mode
(``cbsr_topk_pallas(..., interpret=True)``), which uses the same key.
Against ``lax.top_k`` one case differs: a row whose cut falls on
mixed-sign zeros, where the key orders -0.0 below +0.0 and ``lax.top_k``
holds them equal. There only the expanded outputs can agree.
``cbsr_expand`` and ``cbsr_gather`` (K3's plain version) are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from maxk_tpu.ops import cbsr as jax_cbsr
from maxk_tpu.ops.pallas_gather import cbsr_gather_pallas
from maxk_tpu.ops.pallas_topk import cbsr_topk_pallas
from maxk_tpu_torch.ops.cbsr import (cbsr_expand, cbsr_gather, cbsr_nbytes,
                                     cbsr_topk)
from maxk_tpu_torch.ops.cuda_gather import cbsr_gather_forward
from maxk_tpu_torch.ops.cuda_topk import cbsr_topk_forward
from maxk_tpu_torch.ops.maxk import maxk


def _inputs(kind: str, v: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(v, d))
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "zeros":
        # Rows of mixed-sign zeros with a few nonzeros, so the cut of
        # most k falls on +-0.
        x = np.where(rng.uniform(size=(v, d)) < 0.3, x,
                     np.where(rng.uniform(size=(v, d)) < 0.5, 0.0, -0.0))
    return x.astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("k", [1, 8, 19, 32, 33, 64, "D"])
@pytest.mark.parametrize("d", [64, 256])
def test_cbsr_topk_bit_equal_to_jax(d, k, kind):
    k = d if k == "D" else k
    x = _inputs(kind, 60, d, seed=d + k)
    v_ref, s_ref = jax_cbsr.cbsr_topk(jnp.asarray(x), k)
    v, s = cbsr_topk(torch.from_numpy(x), k)
    assert v.dtype == torch.float32 and s.dtype == torch.int32
    assert tuple(v.shape) == tuple(s.shape) == (60, k)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(v_ref))
    assert np.all(np.diff(s.numpy(), axis=1) > 0)


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("k", [8, 32, 33, 64])
def test_cbsr_topk_bit_equal_to_pallas_interpret(k, kind):
    x = _inputs(kind, 96, 256, seed=k)
    v_ref, s_ref = cbsr_topk_pallas(jnp.asarray(x), k, interpret=True)
    v, s = cbsr_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(v_ref))


@pytest.mark.parametrize("k", [24, 32, 64, 100])
def test_cbsr_topk_mixed_zeros_expand_equal(k):
    d = 128
    x = _inputs("zeros", 80, d, seed=k)
    v_ref, s_ref = jax_cbsr.cbsr_topk(jnp.asarray(x), k)
    v, s = cbsr_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(
        cbsr_expand(v, s, d).numpy(),
        np.asarray(jax_cbsr.cbsr_expand(v_ref, s_ref, d)))
    # The cut falls on +-0 in some rows.
    assert (-np.sort(-x, axis=1)[:, k - 1] == 0.0).any()


@pytest.mark.parametrize("k,d", [(4, 32), (32, 256), (64, 256), (13, 200)])
def test_cbsr_expand_matches_jax(k, d):
    x = _inputs("normal", 70, d, seed=k * d)
    v_ref, s_ref = jax_cbsr.cbsr_topk(jnp.asarray(x), k)
    out = cbsr_expand(torch.from_numpy(np.array(v_ref)),
                      torch.from_numpy(np.array(s_ref)), d)
    assert out.dtype == torch.float32 and tuple(out.shape) == (70, d)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_cbsr.cbsr_expand(v_ref, s_ref, d)))


@pytest.mark.parametrize("k,d", [(8, 64), (32, 256), (64, 256)])
def test_cbsr_expand_of_topk_is_maxk(k, d):
    x = torch.from_numpy(_inputs("ties", 50, d, seed=d - k))
    out = cbsr_expand(*cbsr_topk(x, k), d)
    assert torch.equal(out.view(torch.int32), maxk(x, k).view(torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,d", [(8, 64), (32, 256), (33, 256), (5, 200)])
def test_cbsr_gather_matches_jax(k, d, dtype):
    rng = np.random.default_rng(k + d)
    dense = rng.normal(size=(90, d)).astype(np.float32)
    _, s_ref = jax_cbsr.cbsr_topk(jnp.asarray(rng.normal(
        size=(90, d)).astype(np.float32)), k)
    dense_j = jnp.asarray(dense).astype(dtype)
    ref = jax_cbsr.cbsr_gather(dense_j, s_ref)
    dense_t = torch.from_numpy(dense).to(getattr(torch, dtype))
    out = cbsr_gather(dense_t, torch.from_numpy(np.array(s_ref)))
    assert out.dtype == dense_t.dtype and tuple(out.shape) == (90, k)
    assert str(ref.dtype) == dtype
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("k", [8, 32, 64])
def test_cbsr_gather_matches_pallas_interpret(k):
    rng = np.random.default_rng(k)
    dense = rng.normal(size=(120, 256)).astype(np.float32)
    _, s = cbsr_topk(torch.from_numpy(rng.normal(
        size=(120, 256)).astype(np.float32)), k)
    ref = cbsr_gather_pallas(jnp.asarray(dense), jnp.asarray(s.numpy()),
                             interpret=True)
    out = cbsr_gather(torch.from_numpy(dense), s)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_cbsr_gather_inverts_expand():
    x = torch.from_numpy(_inputs("normal", 30, 32, seed=3))
    v, s = cbsr_topk(x, 8)
    assert torch.equal(cbsr_gather(cbsr_expand(v, s, 32), s), v)


@pytest.mark.parametrize("n,k,d,dtype", [(100, 32, 256, "float32"),
                                         (7, 8, 300, "bfloat16"),
                                         (3, 4, 70000, "float32")])
def test_cbsr_nbytes_matches_jax(n, k, d, dtype):
    assert cbsr_nbytes(n, k, d, getattr(torch, dtype)) == \
        jax_cbsr.cbsr_nbytes(n, k, d, jnp.dtype(dtype))


@pytest.mark.parametrize("x,k", [
    (torch.zeros(4, 8), 0),
    (torch.zeros(4, 8), 9),
    (torch.zeros(4, 8, dtype=torch.float64), 2),
    (torch.zeros(8), 2),
])
def test_cbsr_topk_rejects_bad_input(x, k):
    with pytest.raises(ValueError):
        cbsr_topk_forward(x, k)


@pytest.mark.parametrize("dense,sel", [
    (torch.zeros(4, 8, dtype=torch.float64), torch.zeros(4, 2,
                                                          dtype=torch.int32)),
    (torch.zeros(4, 8), torch.zeros(4, 2, dtype=torch.int64)),
    (torch.zeros(4, 8), torch.zeros(3, 2, dtype=torch.int32)),
    (torch.zeros(8), torch.zeros(4, 2, dtype=torch.int32)),
])
def test_cbsr_gather_rejects_bad_input(dense, sel):
    with pytest.raises(ValueError):
        cbsr_gather_forward(dense, sel)


def test_cpu_tensors_never_count_launches():
    x = torch.from_numpy(_inputs("normal", 16, 32, seed=1))
    k4, k3 = cbsr_topk_forward.launches, cbsr_gather_forward.launches
    v, s = cbsr_topk(x, 4)
    cbsr_gather(x, s)
    assert (cbsr_topk_forward.launches, cbsr_gather_forward.launches) == \
        (k4, k3)
