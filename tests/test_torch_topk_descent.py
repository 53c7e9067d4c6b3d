"""K1's early-exit threshold descent against the full one and maxk_tpu.

K1 (``maxk_forward_plain`` on the CPU, ``csrc/maxk_topk.cu`` on the card)
leaves its MSB-first descent at the first step where count(key >= t) is
exactly k; K4's plain version still runs all 32 steps. Both must keep the
same entries: bit-equal masks and y, here on inputs chosen to meet every
exit (k-th equal to (k+1)-th, k = 1, k = D, +-inf, denormals, mixed
+-0.0, and the -NaN 0xFFFFFFFF whose key is 0, like an invalid slot).
The plain version is also bit-equal to the TPU kernel in interpret mode,
and the number of steps each row runs is the closed form
32 - floor(log2(key_k ^ key_k+1)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.ops.pallas_topk import maxk_pallas
from maxk_tpu_torch.ops.cuda_topk import (_keep_at, _threshold_early,
                                          _threshold_full, maxk_forward_plain,
                                          sortable_key)

KINDS = ["normal", "ties", "inf", "denormal", "zeros", "neg_nan"]
NEG_NAN = np.uint32(0xFFFFFFFF).view(np.float32)


def _inputs(kind: str, v: int, d: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(v, d)).astype(np.float32)
    if kind == "ties":            # most rows' k-th and (k+1)-th are equal
        x = rng.integers(-3, 4, size=(v, d)).astype(np.float32)
    elif kind == "inf":
        r = rng.uniform(size=(v, d))
        x[r < 0.1], x[r > 0.9] = np.inf, -np.inf
    elif kind == "denormal":      # random signs, some of them +-0.0
        bits = rng.integers(0, 1 << 23, size=(v, d), dtype=np.uint32)
        sign = rng.integers(0, 2, size=(v, d), dtype=np.uint32) << 31
        x = (bits | sign).view(np.float32)
    elif kind == "zeros":         # the cut of most k falls on +-0.0
        x = np.where(rng.uniform(size=(v, d)) < 0.5, 0.0, -0.0)
        hot = rng.uniform(size=(v, d)) < 0.3
        x = np.where(hot, rng.normal(size=(v, d)), x).astype(np.float32)
    elif kind == "neg_nan":       # key 0; every 7th row all of it
        x[rng.uniform(size=(v, d)) < 0.3] = NEG_NAN
        x[::7] = NEG_NAN
    return x


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _full_descent(x: torch.Tensor, k: int):
    """(y, mask) of the 32-step descent, K4's."""
    key = sortable_key(x)
    keep = _keep_at(key, _threshold_full(key, k), k)
    return torch.where(keep, x, 0.0), keep.to(torch.uint8)


def test_inputs_hold_what_they_are_named_for():
    assert (_bits(_inputs("neg_nan", 8, 64, 0)) == 0xFFFFFFFF).any()
    den = np.abs(_inputs("denormal", 8, 64, 0))
    assert ((den > 0) & (den < np.finfo(np.float32).tiny)).mean() > 0.9
    assert np.isinf(_inputs("inf", 8, 64, 0)).mean() > 0.1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 8, 32, "D"])
@pytest.mark.parametrize("d", [128, 200])
def test_early_descent_keeps_what_the_full_descent_keeps(d, k, kind):
    k = d if k == "D" else k
    x = torch.from_numpy(_inputs(kind, 64, d, seed=d + k))
    y, mask = maxk_forward_plain(x, k)
    y_full, m_full = _full_descent(x, k)
    assert torch.equal(mask, m_full)
    assert torch.equal(y.view(torch.int32), y_full.view(torch.int32))
    assert torch.all(mask.sum(dim=1) == k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32, "D"])
def test_early_descent_bit_equal_to_pallas_interpret(k, kind):
    """On every kind, +-inf and NaN rows included: the reference's
    x * mask is folded into a select, so a dropped inf or NaN comes out
    +0.0 there as in the port."""
    d = 128
    k = d if k == "D" else k
    x = _inputs(kind, 96, d, seed=3 * k)
    y_ref, m_ref = maxk_pallas(jnp.asarray(x), k, interpret=True)
    y, mask = maxk_forward_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(m_ref, np.float32).astype(np.uint8))
    np.testing.assert_array_equal(_bits(y.numpy()), _bits(y_ref))


def _closed_form_steps(x: np.ndarray, k: int) -> np.ndarray:
    """32 - floor(log2(key_k ^ key_k+1)) per row; 32 on a tie, 0 at k = D."""
    b = x.view(np.uint32)
    key = np.where(b >= 0x80000000, ~b, b | 0x80000000).astype(np.int64)
    if k == x.shape[1]:
        return np.zeros(len(x), np.int64)
    desc = -np.sort(-key, axis=1)
    xor = desc[:, k - 1] ^ desc[:, k]
    return np.array([32 - (int(e).bit_length() - 1) if e else 32
                     for e in xor])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 8, 32, "D"])
@pytest.mark.parametrize("d", [128, 200])
def test_early_descent_steps_match_closed_form(d, k, kind):
    k = d if k == "D" else k
    x = _inputs(kind, 64, d, seed=d * k)
    _, steps = _threshold_early(sortable_key(torch.from_numpy(x)), k)
    np.testing.assert_array_equal(steps.numpy(), _closed_form_steps(x, k))
    if kind == "normal" and k < d:
        assert steps.max() < 32          # every row leaves early
