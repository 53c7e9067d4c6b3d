"""The port's top-k ops at D > 1024 vs maxk_tpu.

On the card rows wider than 1024 columns run ``csrc/topk_wide.cu``, which
the ``cuda`` tests hold bit-equal to the plain versions; here, on CPU
tensors, the public ops (``maxk``, ``maxk_mask``, ``maxk_forward``,
``cbsr_topk``) run those plain versions. Against the JAX package's
``lax.top_k`` path (``maxk_tpu.ops.maxk``, ``maxk_tpu.ops.cbsr``) masks,
values and selectors are bit-equal except on rows whose cut falls on
mixed-sign zeros, where the key orders -0.0 below +0.0 and ``lax.top_k``
holds them equal: there the dense outputs are compared as values. At
D = 2048 they are also bit-equal to the TPU kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.ops import cbsr as jax_cbsr
from maxk_tpu.ops.maxk import maxk as jax_maxk, maxk_mask as jax_maxk_mask
from maxk_tpu.ops.pallas_topk import cbsr_topk_pallas, maxk_pallas
from maxk_tpu_torch.ops.cbsr import cbsr_expand, cbsr_topk
from maxk_tpu_torch.ops.cuda_topk import maxk_forward
from maxk_tpu_torch.ops.maxk import maxk, maxk_mask

KINDS = ["normal", "ties", "zeros"]


def _inputs(kind: str, v: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(v, d)).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 4, size=(v, d)).astype(np.float32)
    # Mixed-sign zeros with a few nonzeros, so the cut of most k falls on
    # +-0.
    x = np.where(rng.uniform(size=(v, d)) < 0.5, 0.0, -0.0)
    hot = rng.uniform(size=(v, d)) < 0.3
    return np.where(hot, rng.normal(size=(v, d)), x).astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _nonzero_cut(x: np.ndarray, k: int) -> np.ndarray:
    """Rows whose k-th largest value is not zero."""
    return -np.sort(-x, axis=1)[:, k - 1] != 0.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32, 64, "D"])
@pytest.mark.parametrize("d", [1100, 2048])
def test_maxk_matches_lax_top_k(d, k, kind):
    k = d if k == "D" else k
    x = _inputs(kind, 24, d, seed=d + k)
    y_ref = np.asarray(jax_maxk(jnp.asarray(x), k))
    m_ref = np.asarray(jax_maxk_mask(jnp.asarray(x), k))
    xt = torch.from_numpy(x)
    y, mask = maxk_forward(xt, k)
    # As values: lax.top_k's path multiplies by the mask, so its dropped
    # negatives are -0.0 where the kernels write +0.0.
    np.testing.assert_array_equal(y.numpy(), y_ref)
    np.testing.assert_array_equal(maxk(xt, k).numpy(), y_ref)
    rows = _nonzero_cut(x, k)
    assert rows.any()
    np.testing.assert_array_equal(mask.numpy()[rows],
                                  m_ref[rows].astype(np.uint8))
    np.testing.assert_array_equal(maxk_mask(xt, k).numpy()[rows],
                                  m_ref[rows])
    assert np.all(mask.numpy().sum(axis=1) == k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32, 64, "D"])
@pytest.mark.parametrize("d", [1100, 2048])
def test_cbsr_topk_matches_lax_top_k(d, k, kind):
    k = d if k == "D" else k
    x = _inputs(kind, 24, d, seed=2 * d + k)
    v_ref, s_ref = jax_cbsr.cbsr_topk(jnp.asarray(x), k)
    v, s = cbsr_topk(torch.from_numpy(x), k)
    assert v.dtype == torch.float32 and s.dtype == torch.int32
    assert tuple(v.shape) == tuple(s.shape) == (24, k)
    assert np.all(np.diff(s.numpy(), axis=1) > 0)
    rows = _nonzero_cut(x, k)
    assert rows.any()
    np.testing.assert_array_equal(s.numpy()[rows], np.asarray(s_ref)[rows])
    np.testing.assert_array_equal(_bits(v.numpy()[rows]),
                                  _bits(np.asarray(v_ref)[rows]))
    np.testing.assert_array_equal(
        cbsr_expand(v, s, d).numpy(),
        np.asarray(jax_cbsr.cbsr_expand(v_ref, s_ref, d)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32, 64, "D"])
def test_maxk_bit_equal_to_pallas_interpret(k, kind):
    d = 2048
    k = d if k == "D" else k
    x = _inputs(kind, 16, d, seed=3 * k)
    y_ref, m_ref = maxk_pallas(jnp.asarray(x), k, interpret=True)
    y, mask = maxk_forward(torch.from_numpy(x), k)
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(y_ref))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(m_ref, np.float32).astype(np.uint8))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32])
def test_cbsr_topk_bit_equal_to_pallas_interpret(k, kind):
    """k up to 32: the TPU kernel's compaction loops unroll k times. It
    compacts each value by a sum over its row, which writes a kept -0.0
    as +0.0; the port's values are compared after that rounding."""
    d = 2048
    x = _inputs(kind, 16, d, seed=5 * k)
    v_ref, s_ref = cbsr_topk_pallas(jnp.asarray(x), k, interpret=True)
    v, s = cbsr_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(_bits(v.numpy() + np.float32(0.0)),
                                  _bits(v_ref))
