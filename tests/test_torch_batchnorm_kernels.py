"""GNN_res's BatchNorm passes (``ops/cuda_batchnorm.py``): the plain
versions against the formulas the training pass had in stock torch ops,
the evaluation's gradient, the counters, what ``_BatchNorm`` keeps for
its backward, and on the card each kernel against its plain version.

CPU tests. ``bn_sums_plain`` and ``bn_dx_plain`` repeat the stock ops
(the same reductions, ``addcmul`` in the same order), and the affine
pass folds w into rstd (one rounding moved): rtol 1e-5, atol 1e-6.

The ``cuda``-marked tests skip without a CUDA device (decided inside the
``cuda_device`` fixture, never at import). On a machine with an H100,
from the repo root:

  python -m pytest -m cuda --noconftest -p no:cacheprovider \\
      tests/test_torch_batchnorm_kernels.py

Tolerances on the card. A column sum of the kernel adds each thread's
rows in float32 with Kahan's compensation (within 2 roundings of the
terms' magnitudes), then the block's row groups (``_groups``, one
rounding each) and the slabs in float64, and rounds the product
terms and the result once each; so it lies within (groups + 6) 2**-24
sum |terms| of the exact sum (float64 of the exact terms), and of the
plain version, which sums in torch's order, within 1e-5 sum |terms|
(the CPU tests' rtol, on the magnitudes since a sum may cancel). The
affine pass is one fma where the plain version rounds the product
first, and the input gradient two fmas where ``addcmul`` may round each
product: within 2**-22 and 2**-21 of the sum of the magnitudes of the
terms. Past ``n_valid`` the gradient is one product on both sides:
equal. The whole op on the card against the CPU op (training, and the
evaluation differentiated): rtol 1e-5, atol 1e-5 (the statistics' sums
in another order shift the mean by a few ulps of sum |x| / n, moved
through rstd * w), and the parameters' gradients, which are column sums,
within 1e-5 sum |terms|. At the ogbn-products shape, GNN_res's (V, D)
activation as the ``gnnres-products.fit`` cell runs it, every sum is
also held to float64 sums of its terms taken in chunks of rows, within
1e-6 of sum |terms| a column: a float32 sum that drifts with the row
count shows only at that size.
"""

import types

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread a test worker)
from card_inputs import card  # noqa: F401
from maxk_tpu_torch import ops
from maxk_tpu_torch.data.datasets import make_synthetic_dataset
from maxk_tpu_torch.models.models import BatchNorm
from maxk_tpu_torch.ops.cuda_batchnorm import (bn_affine, bn_affine_plain,
                                               bn_dx, bn_dx_plain, bn_sums,
                                               bn_sums_plain)
from maxk_tpu_torch.train.loop import Trainer

EPS = 1e-5
KERNELS = ("bn_sums", "bn_affine", "bn_dx")


# -- the stock torch ops the training pass and the evaluation were -----------

def _stock_forward(x, w, b, n_valid=None):
    """(y, mean, rstd, xhat, var_moves, n): the training forward as stock
    torch ops."""
    xv = x[:n_valid]
    s1 = xv.sum(dim=0)
    s2 = torch.linalg.vector_norm(xv, dim=0).square()
    n = float(xv.shape[0])
    mean, mean2 = s1 / n, s2 / n
    raw_var = mean2 - mean * mean
    rstd = torch.rsqrt(torch.clamp(raw_var, min=0.0) + EPS)
    xhat = torch.sub(x, mean).mul_(rstd)
    return torch.addcmul(b, xhat, w), mean, rstd, xhat, raw_var >= 0.0, n


def _stock_backward(dy, xhat, rstd, w, var_moves, n, n_valid=None):
    """(dx, dw, db): the backward as stock torch ops."""
    db = dy.sum(dim=0)
    dw = (dy * xhat).sum(dim=0)
    scale = rstd * w
    dx = torch.addcmul(-scale * (db / n), dy, scale)
    dx.addcmul_(xhat, torch.where(var_moves, -scale * (dw / n), 0.0))
    if n_valid is not None and n_valid < dy.shape[0]:
        dx[n_valid:] = dy[n_valid:] * scale
    return dx, dw, db


def _clamped_column(x: torch.Tensor, sums=bn_sums_plain) -> torch.Tensor:
    """x with column 3 set to the first constant whose E[x^2] - E[x]^2,
    from `sums`, rounds below 0, so that the clamp binds there."""
    n = x.shape[0]
    for c in np.linspace(0.1, 9.9, 99, dtype=np.float32):
        x[:, 3] = float(c)
        s1, s2 = sums(x)
        if float(s2[3] / n - (s1[3] / n) ** 2) < 0:
            return x
    raise AssertionError("no constant column rounds to a negative variance")


def _case(case: str, v: int = 300, d: int = 64, seed: int = 7,
          device="cpu"):
    """(x, dy, w, b, n_valid) on the CPU, moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(v, d, generator=gen) * 2.0 + 0.5
    if case == "clamped":
        x = _clamped_column(x)
    dy = torch.randn(v, d, generator=gen)
    w = torch.rand(d, generator=gen) + 0.5
    b = torch.randn(d, generator=gen)
    n_valid = (v * 7) // 8 if case == "padded" else None
    return (*(t.to(device) for t in (x, dy, w, b)), n_valid)


CASES = ["random", "padded", "clamped"]


@pytest.mark.parametrize("case", CASES)
def test_plain_sums_are_the_stock_reductions(case):
    x, dy, w, b, n_valid = _case(case)
    _, mean, rstd, xhat, _, _ = _stock_forward(x, w, b, n_valid)
    xv = x[:n_valid]
    s1, s2 = bn_sums(x, n_valid)
    torch.testing.assert_close(s1, xv.sum(dim=0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        s2, torch.linalg.vector_norm(xv, dim=0).square(), rtol=1e-5,
        atol=1e-6)
    s_dy, s_dyx = bn_sums(dy, norm=(x, mean, rstd))
    torch.testing.assert_close(s_dy, dy.sum(dim=0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s_dyx, (dy * xhat).sum(dim=0), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_plain_affine_is_the_stock_forward_and_evaluation(case):
    x, _, w, b, n_valid = _case(case)
    y, mean, rstd, _, _, _ = _stock_forward(x, w, b, n_valid)
    torch.testing.assert_close(bn_affine(x, mean, rstd * w, b), y,
                               rtol=1e-5, atol=1e-6)
    # The evaluation: the running statistics' formula, op for op.
    gen = torch.Generator().manual_seed(1)
    r_mean = torch.randn(x.shape[1], generator=gen)
    r_var = torch.rand(x.shape[1], generator=gen) + 0.5
    scale = torch.rsqrt(r_var + EPS) * w
    assert torch.equal(bn_affine(x, r_mean, scale, b),
                       (x - r_mean) * scale + b)


@pytest.mark.parametrize("case", CASES)
def test_plain_dx_is_the_stock_backward(case):
    x, dy, w, b, n_valid = _case(case)
    _, mean, rstd, xhat, var_moves, n = _stock_forward(x, w, b, n_valid)
    if case == "clamped":
        assert not bool(var_moves[3]) and bool(var_moves[:3].all())
    want, dw, db = _stock_backward(dy, xhat, rstd, w, var_moves, n, n_valid)
    scale = rstd * w
    c_dy = -scale * (db / n)
    c_dyx = torch.where(var_moves, -scale * (dw / n), 0.0)
    got = bn_dx(dy, x, mean, rstd, scale, c_dy, c_dyx, n_valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if case == "padded":
        assert torch.equal(got[n_valid:], dy[n_valid:] * scale)


@pytest.mark.parametrize("case", CASES)
def test_the_op_is_the_stock_ops(case):
    """The whole training pass on the CPU against the stock ops."""
    x, dy, w, b, n_valid = _case(case)
    want_y, _, rstd, xhat, var_moves, n = _stock_forward(x, w, b, n_valid)
    want_dx, want_dw, want_db = _stock_backward(dy, xhat, rstd, w,
                                                var_moves, n, n_valid)
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    xa = x.clone().requires_grad_(True)
    y = bn(xa, True, n_valid)
    y.backward(dy)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-6)
    for got, want in ((xa.grad, want_dx), (bn.weight.grad, want_dw),
                      (bn.bias.grad, want_db)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_op_keeps_x_for_its_backward():
    """One (V, D) tensor is saved, and it is the input itself."""
    x, _, w, b, _ = _case("random")
    bn = BatchNorm(x.shape[1])
    xa = x.clone().requires_grad_(True)
    y = bn(xa, True)
    big = [t for t in y.grad_fn.saved_tensors if t.dim() == 2]
    assert len(big) == 1 and big[0].shape == x.shape
    assert big[0].data_ptr() == xa.data_ptr()
    assert all(t.numel() == x.shape[1] for t in y.grad_fn.saved_tensors
               if t.dim() != 2)


@pytest.mark.parametrize("fn,args", [
    (bn_sums, lambda x, v: (x.double(),)),
    (bn_sums, lambda x, v: (x, None, (x, v, v.double()))),
    (bn_affine, lambda x, v: (x, v, v, v[:-1])),
    (bn_affine, lambda x, v: (x[0], v, v, v)),
    (bn_dx, lambda x, v: (x, x[:-1], v, v, v, v, v)),
])
def test_refuses_other_dtypes_and_shapes(fn, args):
    x, v = torch.randn(8, 4), torch.randn(4)
    with pytest.raises(ValueError):
        fn(*args(x, v))


def test_counters_and_a_cpu_train_step_launches_none():
    counted = ops.kernel_counters()
    assert set(KERNELS) <= set(counted)
    before = {k: counted[k].launches for k in KERNELS}
    cfg = types.SimpleNamespace(
        model="gnn_res", hidden_dim=16, hidden_layers=3, maxk=4,
        dropout=0.5, norm=True, nonlinear="maxk", w_lr=0.01,
        w_weight_decay=0.0, enable_lookahead=False, seed=5,
        compute_dtype="float32", device="cpu")
    ds = make_synthetic_dataset(n_nodes=200, avg_degree=6.0, n_classes=4,
                                in_size=12, seed=1)
    tr = Trainer(cfg, ds)
    tr.train_step()
    tr.evaluate_masks()
    assert {k: counted[k].launches for k in KERNELS} == before


def _eval_grads(x, w, b, r_mean, r_var, n_valid=None, stock=False):
    """(y, dx, dw, db) of the evaluation on x's device, y.backward(dy) with
    dy = cos(y); `stock` differentiates the formula in stock ops."""
    bn = BatchNorm(x.shape[1]).to(x.device)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(r_mean)
        bn.running_var.copy_(r_var)
    xa = x.clone().requires_grad_(True)
    if stock:
        scale = torch.rsqrt(bn.running_var + EPS) * bn.weight
        y = (xa - bn.running_mean) * scale + bn.bias
    else:
        y = bn(xa, False, n_valid)
    y.backward(torch.cos(y.detach()))
    return y.detach(), xa.grad, bn.weight.grad, bn.bias.grad


def _running(d: int, device="cpu"):
    gen = torch.Generator().manual_seed(2)
    return (torch.randn(d, generator=gen).to(device),
            (torch.rand(d, generator=gen) + 0.5).to(device))


@pytest.mark.parametrize("case", CASES)
def test_the_evaluation_differentiates_as_the_stock_ops(case):
    """The evaluation with grad enabled: the same values and gradients as
    autograd through the stock formula (n_valid plays no part in it)."""
    x, _, w, b, n_valid = _case(case)
    r_mean, r_var = _running(x.shape[1])
    got = _eval_grads(x, w, b, r_mean, r_var, n_valid)
    want = _eval_grads(x, w, b, r_mean, r_var, stock=True)
    assert torch.equal(got[0], want[0])
    for g, s in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, s, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("needs", ["x", "params"])
def test_the_evaluation_differentiates_only_what_asks(needs):
    """Only x, or only the parameters, ask for a gradient: each receives
    the stock formula's, and the other none."""
    x, _, w, b, _ = _case("random")
    r_mean, r_var = _running(x.shape[1])
    want = _eval_grads(x, w, b, r_mean, r_var, stock=True)
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.copy_(r_mean)
        bn.running_var.copy_(r_var)
    xa = x.clone().requires_grad_(needs == "x")
    bn.requires_grad_(needs == "params")
    y = bn(xa, False)
    y.backward(torch.cos(y.detach()))
    if needs == "x":
        torch.testing.assert_close(xa.grad, want[1], rtol=1e-5, atol=1e-6)
        assert bn.weight.grad is None and bn.bias.grad is None
    else:
        assert xa.grad is None
        torch.testing.assert_close(bn.weight.grad, want[2], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(bn.bias.grad, want[3], rtol=1e-5,
                                   atol=1e-6)


def test_the_evaluation_under_no_grad_keeps_no_graph():
    x, _, w, b, _ = _case("random")
    bn = BatchNorm(x.shape[1])
    with torch.no_grad():
        y = bn(x.clone().requires_grad_(True), False)
    assert y.grad_fn is None and not y.requires_grad


# -- on the card ------------------------------------------------------------



@pytest.fixture
def cuda_device(card):
    return card


def _groups(d: int, vec: bool) -> int:
    """The row groups of a block of csrc/batchnorm.cu (kThreads = 256
    threads, min(units, 256) column units a block, a unit 4 columns where
    vec): the partial sums a block adds in shared memory."""
    units = d // 4 if vec else d
    return 256 // min(units, 256)


def _sum_bound(terms: torch.Tensor, vec: bool) -> torch.Tensor:
    """(groups + 6) 2**-24 sum |terms| a column: the kernel's error bound
    against the exact sum of `terms`."""
    groups = _groups(terms.shape[1], vec)
    return (groups + 6) * 2.0 ** -24 * terms.double().abs().sum(dim=0)


def _within(got, want, bound):
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def _unaligned(v: int, d: int, device) -> torch.Tensor:
    """An empty contiguous (v, d) float32 tensor whose base is 4 bytes off
    16: the kernels take their scalar loads."""
    return torch.empty(v * d + 1, device=device)[1:].view(v, d)


SHAPES = [(100_003, 256, True), (4_097, 100, False), (4_097, 100, True),
          (1_000, 257, False), (2_049, 1100, True), (5_003, 4, True)]


def _card_case(v, d, aligned, case, device):
    x, dy, w, b, n_valid = _case("random", v, d, seed=v + d)
    if not aligned:
        x = _unaligned(v, d, device).copy_(x)
        dy = _unaligned(v, d, device).copy_(dy)
    if case == "padded":
        n_valid = (v * 7) // 8
    x, dy, w, b = (t.to(device) for t in (x, dy, w, b))
    if case == "clamped":
        x = _clamped_column(x, bn_sums)
    return x, dy, w, b, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("v,d,aligned", SHAPES)
def test_sums_on_the_card(cuda_device, v, d, aligned, case):
    x, dy, w, b, n_valid = _card_case(v, d, aligned, case, cuda_device)
    before = bn_sums.launches
    s1, s2 = bn_sums(x, n_valid)
    xv = x[:n_valid]
    rows, vec = xv.shape[0], aligned and d % 4 == 0
    for got, plain, terms in ((s1, xv.sum(0), xv),
                              (s2, torch.linalg.vector_norm(xv, dim=0)
                               .square(), xv.double() ** 2)):
        _within(got, terms.double().sum(0), _sum_bound(terms, vec))
        _within(got, plain, 1e-5 * terms.double().abs().sum(0))
    n = float(rows)
    mean = s1 / n
    rstd = torch.rsqrt(torch.clamp(s2 / n - mean * mean, min=0.0) + EPS)
    s_dy, s_dyx = bn_sums(dy, norm=(x, mean, rstd))
    xhat = torch.sub(x, mean).mul_(rstd)
    p_dy, p_dyx = bn_sums_plain(dy, norm=(x, mean, rstd))
    for got, plain, terms in ((s_dy, p_dy, dy),
                              (s_dyx, p_dyx, dy.double() * xhat.double())):
        _within(got, terms.double().sum(0), _sum_bound(terms, vec))
        _within(got, plain, 1e-5 * terms.double().abs().sum(0))
    assert bn_sums.launches == before + 2
    # Launched again on the same inputs: the same bits.
    again = bn_sums(x, n_valid), bn_sums(dy, norm=(x, mean, rstd))
    assert all(torch.equal(a, b) for a, b in
               zip((s1, s2, s_dy, s_dyx), (*again[0], *again[1])))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("v,d,aligned", SHAPES)
def test_affine_and_dx_on_the_card(cuda_device, v, d, aligned, case):
    x, dy, w, b, n_valid = _card_case(v, d, aligned, case, cuda_device)
    s1, s2 = bn_sums(x, n_valid)
    n = float(x[:n_valid].shape[0])
    mean = s1 / n
    raw_var = s2 / n - mean * mean
    var_moves = raw_var >= 0.0
    if case == "clamped":
        assert not bool(var_moves[3])
    rstd = torch.rsqrt(torch.clamp(raw_var, min=0.0) + EPS)
    scale = rstd * w
    before = bn_affine.launches, bn_dx.launches

    y = bn_affine(x, mean, scale, b)
    want = bn_affine_plain(x, mean, scale, b)
    _within(y, want, 2.0 ** -22 * (((x - mean) * scale).abs() + b.abs()))
    assert torch.equal(y, bn_affine(x, mean, scale, b))

    s_dy, s_dyx = bn_sums(dy, norm=(x, mean, rstd))
    c_dy = -scale * (s_dy / n)
    c_dyx = torch.where(var_moves, -scale * (s_dyx / n), 0.0)
    dx = bn_dx(dy, x, mean, rstd, scale, c_dy, c_dyx, n_valid)
    want = bn_dx_plain(dy, x, mean, rstd, scale, c_dy, c_dyx, n_valid)
    xhat = torch.sub(x, mean).mul_(rstd)
    _within(dx, want, 2.0 ** -21 * ((dy * scale).abs() + c_dy.abs()
                                    + (xhat * c_dyx).abs()))
    if n_valid is not None:
        assert torch.equal(dx[n_valid:], dy[n_valid:] * scale)
    assert torch.equal(dx, bn_dx(dy, x, mean, rstd, scale, c_dy, c_dyx,
                                 n_valid))
    assert (bn_affine.launches, bn_dx.launches) == (before[0] + 2,
                                                    before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "padded"])
def test_the_op_on_the_card_is_the_cpu_op(cuda_device, case):
    x, dy, w, b, n_valid = _case(case, v=20_011, d=256, seed=3)
    out = {}
    for device in ("cpu", cuda_device):
        bn = BatchNorm(256).to(device)
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        xa = x.to(device, copy=True).requires_grad_(True)
        y = bn(xa, True, n_valid)
        y.backward(dy.to(device))
        with torch.no_grad():
            y_eval = bn(xa, False)
        out[str(device)] = [t.detach().cpu() for t in (
            y, xa.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var, y_eval)]
    cpu, card = out["cpu"], out[str(cuda_device)]
    for i in (0, 1, 6):
        torch.testing.assert_close(card[i], cpu[i], rtol=1e-5, atol=1e-5)
    xhat = _stock_forward(x, w, b, n_valid)[3]
    for i, terms in ((2, dy * xhat), (3, dy)):
        _within(card[i], cpu[i], 1e-5 * terms.double().abs().sum(dim=0))
    for i in (4, 5):
        torch.testing.assert_close(card[i], cpu[i], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "padded"])
def test_the_evaluation_differentiates_on_the_card(cuda_device, case):
    """The evaluation with grad enabled on the card: the CPU's values and
    gradients (dw and db are column sums: within 1e-5 of sum |terms|)."""
    x, _, w, b, n_valid = _case(case, v=20_011, d=256, seed=4)
    r_mean, r_var = _running(256)
    cpu = _eval_grads(x, w, b, r_mean, r_var, n_valid)
    card = [t.cpu() for t in _eval_grads(
        *(t.to(cuda_device) for t in (x, w, b, r_mean, r_var)), n_valid)]
    for i in (0, 1):
        torch.testing.assert_close(card[i], cpu[i], rtol=1e-5, atol=1e-5)
    dy = torch.cos(cpu[0]).double()
    xs = (x - r_mean).double() * torch.rsqrt(r_var + EPS).double()
    for i, terms in ((2, dy * xs), (3, dy)):
        _within(card[i], cpu[i], 1e-5 * terms.double().abs().sum(dim=0))


@pytest.mark.cuda
def test_gnnres_launches_on_the_card(cuda_device):
    counted = ops.kernel_counters()

    def counts():
        return {k: counted[k].launches for k in KERNELS}

    cfg = types.SimpleNamespace(
        model="gnn_res", hidden_dim=64, hidden_layers=3, maxk=8,
        dropout=0.5, norm=True, nonlinear="maxk", w_lr=0.01,
        w_weight_decay=0.0, enable_lookahead=False, seed=5,
        compute_dtype="float32", device="cuda")
    ds = make_synthetic_dataset(n_nodes=2000, avg_degree=6.0, n_classes=4,
                                in_size=12, seed=1)
    tr = Trainer(cfg, ds)
    before = counts()
    tr.train_step()
    torch.cuda.synchronize()
    mid = counts()
    assert {k: mid[k] - before[k] for k in KERNELS} == \
        {"bn_sums": 6, "bn_affine": 3, "bn_dx": 3}
    tr.evaluate_masks()
    torch.cuda.synchronize()
    assert {k: counts()[k] - mid[k] for k in KERNELS} == \
        {"bn_sums": 0, "bn_affine": 3, "bn_dx": 0}


# GNN_res's (V, D) activation at the ogbn-products shape, every row valid.
PRODUCTS_SHAPE = (2_449_029, 256)
# A sum's error against the float64 sum, over sum |terms| a column:
# (groups + 6) 2**-24 is 6.0e-7 at D = 256 (4 row groups); a slab lost or
# added moves a sum by ~1/396 of it.
PRODUCTS_SUM_RTOL = 1e-6


@pytest.mark.cuda
def test_passes_at_the_products_shape(cuda_device):
    """randn x * 2 + 0.5 and randn dy at PRODUCTS_SHAPE: both forms of
    bn_sums within PRODUCTS_SUM_RTOL of sum |terms| of float64 sums of the
    same terms (chunks of 2**18 rows); bn_affine within 2**-22 and bn_dx
    within 2**-21 of their terms' magnitudes of their plain versions."""
    v, d = PRODUCTS_SHAPE
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(v, d, device=cuda_device, generator=gen) * 2.0 + 0.5
    dy = torch.randn(v, d, device=cuda_device, generator=gen)
    w = torch.rand(d, device=cuda_device, generator=gen) + 0.5
    b = torch.randn(d, device=cuda_device, generator=gen)
    chunk = 1 << 18

    def share_of_sum_abs(got, terms_of):
        """max over columns of |got - sum| / sum |terms|, both in float64
        over chunks of rows."""
        want = torch.zeros(d, dtype=torch.float64, device=cuda_device)
        mag = torch.zeros_like(want)
        for r in range(0, v, chunk):
            t = terms_of(slice(r, r + chunk))
            want += t.sum(dim=0)
            mag += t.abs().sum(dim=0)
        return float(((got.double() - want).abs() / mag).max())

    s1, s2 = bn_sums(x)
    mean = s1 / v
    rstd = torch.rsqrt(torch.clamp(s2 / v - mean * mean, min=0.0) + EPS)
    q1, q2 = bn_sums(dy, norm=(x, mean, rstd))
    m64, r64 = mean.double(), rstd.double()
    for got, terms_of in (
            (s1, lambda i: x[i].double()),
            (s2, lambda i: x[i].double() ** 2),
            (q1, lambda i: dy[i].double()),
            (q2, lambda i: dy[i].double() * ((x[i].double() - m64) * r64))):
        assert share_of_sum_abs(got, terms_of) <= PRODUCTS_SUM_RTOL

    scale = rstd * w
    err = (bn_affine(x, mean, scale, b)
           - bn_affine_plain(x, mean, scale, b)).abs_()
    bound = ((x - mean) * scale).abs_().add_(b.abs()).mul_(2.0 ** -22)
    assert float(err.div_(bound.clamp_min_(1e-30)).max()) <= 1.0
    del err, bound

    c_dy = -scale * (q1 / v)
    c_dyx = -scale * (q2 / v)
    err = (bn_dx(dy, x, mean, rstd, scale, c_dy, c_dyx)
           - bn_dx_plain(dy, x, mean, rstd, scale, c_dy, c_dyx)).abs_()
    mag = (dy * scale).abs_().add_(c_dy.abs())
    mag.add_(torch.sub(x, mean).mul_(rstd).mul_(c_dyx).abs_())
    assert float(err.div_(mag.mul_(2.0 ** -21).clamp_min_(1e-30)).max()) \
        <= 1.0
