"""K1's plain version and the MaxK autograd op vs maxk_tpu.

The plain version (``maxk_forward_plain``, what CPU tensors run) must be
bit-equal to the TPU kernel run in interpret mode
(``maxk_pallas(..., interpret=True)``): same threshold descent, same
first-column tie order. Against ``lax.top_k`` (``maxk_tpu.ops.maxk``)
its mask is bit-equal except on rows whose cut falls on mixed-sign
zeros, where only the dense outputs can agree (pallas_topk.py module
note).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.ops.maxk import maxk as jax_maxk, maxk_mask as jax_maxk_mask
from maxk_tpu.ops.pallas_topk import maxk_pallas
from maxk_tpu_torch.ops.cuda_topk import maxk_forward, maxk_forward_plain
from maxk_tpu_torch.ops.maxk import maxk, maxk_mask


def _inputs(kind: str, v: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(v, d)).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 4, size=(v, d)).astype(np.float32)
    # Rows of mixed-sign zeros with a few nonzeros, so the cut of most k
    # falls on +-0.
    x = np.where(rng.uniform(size=(v, d)) < 0.5, 0.0, -0.0)
    hot = rng.uniform(size=(v, d)) < 0.3
    x = np.where(hot, rng.normal(size=(v, d)), x)
    return x.astype(np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("k", [1, 8, 16, 32, 64, "D"])
@pytest.mark.parametrize("d", [128, 256])
def test_plain_bit_equal_to_pallas_interpret(d, k, kind):
    k = d if k == "D" else k
    x = _inputs(kind, 96, d, seed=d + (k if isinstance(k, int) else 0))
    y_ref, m_ref = maxk_pallas(jnp.asarray(x), k, interpret=True)
    y, mask = maxk_forward_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(y_ref))
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(m_ref, np.float32).astype(np.uint8))
    assert mask.dtype == torch.uint8
    assert np.all(mask.numpy().sum(axis=1) == k)


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("k", [1, 8, 32, 200])
def test_plain_matches_lax_top_k_at_odd_width(k, kind):
    x = _inputs(kind, 80, 200, seed=k)
    y_ref = np.asarray(jax_maxk(jnp.asarray(x), k))
    m_ref = np.asarray(jax_maxk_mask(jnp.asarray(x), k))
    y, mask = maxk_forward(torch.from_numpy(x), k)
    # Dense outputs agree on every row. As values only: this path
    # multiplies by the mask, so its dropped negatives are -0.0 where
    # the Pallas kernel (and the port) write +0.0.
    np.testing.assert_array_equal(y.numpy(), y_ref)
    # Rows whose k-th largest value is not zero: bit-equal masks.
    kth = -np.sort(-x, axis=1)[:, k - 1]
    rows = kth != 0.0
    assert rows.any()
    np.testing.assert_array_equal(mask.numpy()[rows],
                                  m_ref[rows].astype(np.uint8))


@pytest.mark.parametrize("d,k", [(128, 8), (128, 32), (200, 8), (200, 64)])
def test_maxk_gradient_matches_jax(d, k):
    rng = np.random.default_rng(d * k)
    x = rng.normal(size=(64, d)).astype(np.float32)
    g = rng.normal(size=(64, d)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a: jax_maxk(a, k), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = maxk(xt, k)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_ref))


def test_maxk_mask_in_input_dtype():
    x = torch.from_numpy(_inputs("normal", 10, 64, seed=1))
    m = maxk_mask(x, 5)
    assert m.dtype == torch.float32
    assert torch.equal(m.sum(dim=1), torch.full((10,), 5.0))


@pytest.mark.parametrize("x,k", [
    (torch.zeros(4, 8), 0),
    (torch.zeros(4, 8), 9),
    (torch.zeros(4, 8, dtype=torch.float64), 2),
    (torch.zeros(8), 2),
])
def test_maxk_forward_rejects_bad_input(x, k):
    with pytest.raises(ValueError):
        maxk_forward(x, k)
