"""The kernels' early-exit threshold descent against the full one and
maxk_tpu.

K1 and K4 (``maxk_forward_plain`` and ``cbsr_topk_plain`` on the CPU,
``csrc/maxk_topk.cu``, ``csrc/cbsr_topk.cu`` and ``csrc/topk_wide.cu`` on
the card) leave their MSB-first descent at the first step where
count(key >= t) is exactly k. Each must keep what the full 32-step
descent keeps: bit-equal masks and y for K1, bit-equal values and
selectors for K4, here on inputs chosen to meet every exit (k-th equal to
(k+1)-th, k = 1, k = D, +-inf, denormals, mixed +-0.0, and the -NaN
0xFFFFFFFF whose key is 0, like an invalid slot). Each plain version is
also bit-equal to its TPU kernel in interpret mode, and the number of
steps each row runs is the closed form 32 - floor(log2(key_k ^ key_k+1)).
Every case is run for both ops (the ``op`` parameter).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxk_tpu.ops.pallas_topk import cbsr_topk_pallas, maxk_pallas
from maxk_tpu_torch.ops import cuda_topk
from maxk_tpu_torch.ops.cuda_topk import (_keep_at, _threshold_full,
                                          cbsr_topk_plain, maxk_forward_plain,
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


def _full_descent(op: str, x: torch.Tensor, k: int):
    """`op`'s output from the 32-step descent: (y, mask) for K1 ('maxk'),
    (values, selector) for K4 ('cbsr')."""
    key = sortable_key(x)
    keep = _keep_at(key, _threshold_full(key, k), k)
    if op == "maxk":
        return torch.where(keep, x, 0.0), keep.to(torch.uint8)
    return (x[keep].view(-1, k),
            keep.nonzero()[:, 1].to(torch.int32).view(-1, k))


PLAIN = {"maxk": maxk_forward_plain, "cbsr": cbsr_topk_plain}
PALLAS = {"maxk": maxk_pallas, "cbsr": cbsr_topk_pallas}


def _as_bits(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def test_inputs_hold_what_they_are_named_for():
    assert (_bits(_inputs("neg_nan", 8, 64, 0)) == 0xFFFFFFFF).any()
    den = np.abs(_inputs("denormal", 8, 64, 0))
    assert ((den > 0) & (den < np.finfo(np.float32).tiny)).mean() > 0.9
    assert np.isinf(_inputs("inf", 8, 64, 0)).mean() > 0.1


@pytest.mark.parametrize("op", ["maxk", "cbsr"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 8, 32, "D"])
@pytest.mark.parametrize("d", [128, 200])
def test_early_descent_keeps_what_the_full_descent_keeps(d, k, kind, op):
    k = d if k == "D" else k
    x = torch.from_numpy(_inputs(kind, 64, d, seed=d + k))
    out = PLAIN[op](x, k)
    full = _full_descent(op, x, k)
    for a, b in zip(out, full):
        assert a.dtype == b.dtype and torch.equal(_as_bits(a), _as_bits(b))
    if op == "maxk":
        assert torch.all(out[1].sum(dim=1) == k)
    else:
        assert torch.all(torch.diff(out[1], dim=1) > 0)


@pytest.mark.parametrize("op", ["maxk", "cbsr"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 32, "D"])
def test_early_descent_bit_equal_to_pallas_interpret(k, kind, op):
    """On every kind, +-inf and NaN rows included: the reference's
    x * mask is folded into a select, so a dropped inf or NaN comes out
    +0.0 there as in the port. The TPU's K4 compacts each kept value by a
    sum over its row, which on the CPU writes a kept -0.0 or denormal as
    +0.0; the port writes the kept entries as they are, so there its
    values are compared after that rounding, and its selectors as they
    are."""
    d = 128
    k = d if k == "D" else k
    if op == "cbsr" and k == d:
        k = 64              # its k-loops unroll: keep the trace small
    x = _inputs(kind, 96, d, seed=3 * k)
    ref = PALLAS[op](jnp.asarray(x), k, interpret=True)
    out = PLAIN[op](torch.from_numpy(x), k)
    values = out[0].numpy()
    if op == "maxk":
        np.testing.assert_array_equal(
            out[1].numpy(), np.asarray(ref[1], np.float32).astype(np.uint8))
    else:
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
        flushed = np.abs(values) < np.finfo(np.float32).tiny
        values = np.where(flushed, np.float32(0.0), values)
    np.testing.assert_array_equal(_bits(values), _bits(ref[0]))


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


@pytest.mark.parametrize("op", ["maxk", "cbsr"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 8, 32, "D"])
@pytest.mark.parametrize("d", [128, 200])
def test_early_descent_steps_match_closed_form(d, k, kind, op, monkeypatch):
    """The steps of the descent each op's plain version runs."""
    k = d if k == "D" else k
    x = _inputs(kind, 64, d, seed=d * k)
    ran = []
    early = cuda_topk._threshold_early

    def recorded(key, kk):
        ran.append(early(key, kk))
        return ran[-1]
    monkeypatch.setattr(cuda_topk, "_threshold_early", recorded)
    PLAIN[op](torch.from_numpy(x), k)
    assert len(ran) == 1
    steps = ran[0][1]
    np.testing.assert_array_equal(steps.numpy(), _closed_form_steps(x, k))
    if kind == "normal" and k < d:
        assert steps.max() < 32          # every row leaves early
