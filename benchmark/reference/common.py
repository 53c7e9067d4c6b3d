"""Plain float32 PyTorch pieces of the reference models.

Nothing here imports the program: the adjacency, its normalisations and
transposes, the self-loops and the top-k are worked out again from the
edge list the benchmark made. TF32 is off. The configurations state bf16
gathers with float32 edge values and float32 sums for every aggregation
(forward and backward), and float32 for everything else; so does this
reference. ``dense`` = "tf32" is the control: every Dense product with its
operands rounded to TF32 (10 mantissa bits, round to nearest, ties away),
forward and backward, as a TF32 tensor-core product reads them.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.nn.functional as F

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Adjacency:
    """A normalised adjacency and its transpose, as sparse CSR matrices."""

    a: torch.Tensor
    a_t: torch.Tensor


def _csr(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
         n: int) -> torch.Tensor:
    order = torch.argsort(rows * n + cols)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(torch.bincount(rows, minlength=n), 0, out=crow[1:])
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols[order], vals[order],
                                       (n, n))


def adjacency(indptr: torch.Tensor, indices: torch.Tensor, n: int,
              self_loops: bool, norm: str) -> Adjacency:
    """The aggregation matrix of a graph given as its directed edges (CSR
    arrays, no self-loops): loops added if asked, then ``norm`` "mean"
    (each edge over its row's degree) or "sym" (over the square root of
    its row's out-degree times its column's in-degree)."""
    dev = indptr.device
    rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                   torch.diff(indptr))
    cols = indices.to(torch.int64)
    if self_loops:
        loop = torch.arange(n, device=dev)
        rows, cols = torch.cat([rows, loop]), torch.cat([cols, loop])
    ones = torch.ones(rows.shape[0], dtype=torch.float32, device=dev)
    d_out = torch.bincount(rows, minlength=n).clamp_(min=1).float()
    if norm == "mean":
        vals = ones / d_out[rows]
    elif norm == "sym":
        d_in = torch.bincount(cols, minlength=n).clamp_(min=1).float()
        vals = ones / (torch.sqrt(d_out[rows]) * torch.sqrt(d_in[cols]))
    else:
        raise ValueError(f"unknown normalisation {norm!r}")
    return Adjacency(_csr(rows, cols, vals, n), _csr(cols, rows, vals, n))


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, held in float32."""
    return x.to(torch.bfloat16).float()


class _Aggregate(torch.autograd.Function):
    """A @ bf16(x) forward, A^T @ bf16(dy) backward, float32 sums."""

    @staticmethod
    def forward(ctx, x, adj):
        ctx.adj = adj
        return adj.a @ bf16(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.adj.a_t @ bf16(dy), None


def aggregate(adj: Adjacency, x: torch.Tensor) -> torch.Tensor:
    return _Aggregate.apply(x, adj)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32: 10 mantissa bits, to nearest, ties away
    from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xr, wr = tf32(x), tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t()

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dyr = tf32(dy)
        return dyr @ wr, dyr.t() @ xr


def linear(x: torch.Tensor, w: torch.Tensor, b, dense: str) -> torch.Tensor:
    if dense == "float32":
        return F.linear(x, w, b)
    if dense != "tf32":
        raise ValueError(f"unknown dense precision {dense!r}")
    y = _TF32Linear.apply(x, w)
    return y if b is None else y + b


class _Masked(torch.autograd.Function):
    """x times a 0/1 mask, forward and backward; only the mask, as bool,
    is kept for the backward."""

    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(mask)
        return x * mask.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        mask, = ctx.saved_tensors
        return dy * mask.to(dy.dtype), None


def masked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return _Masked.apply(x, mask)


def maxk(x: torch.Tensor, k: int) -> torch.Tensor:
    """x times the 0/1 mask of each row's k largest entries (ties kept
    from the first column on); the gradient passes where the mask is 1."""
    with torch.no_grad():
        thr = torch.topk(x, k, dim=1).values[:, -1:]
        above = x > thr
        tie = x == thr
        room = k - above.sum(dim=1, keepdim=True)
        mask = above | (tie & (torch.cumsum(tie, dim=1, dtype=torch.int32)
                               <= room))
    return masked(x, mask)


def keep_mask(x: torch.Tensor, p: float, gen: torch.Generator):
    """Dropout's kept units: where a uniform draw of the generator is >=
    p, one ``torch.rand`` of x's shape."""
    return torch.rand(x.shape, generator=gen, device=x.device) >= p


def dropout(x: torch.Tensor, p: float, gen: torch.Generator) -> torch.Tensor:
    """Keep ``keep_mask``'s units, scaled by 1 / (1 - p)."""
    keep = keep_mask(x, p, gen)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), device=x.device))


def layer_norm(x, w, b) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[1],), w, b, eps=1e-6)


def xavier_bound(shape) -> float:
    fan_out, fan_in = shape
    return (6.0 / (fan_in + fan_out)) ** 0.5


def make_params(specs: dict, gen: torch.Generator) -> dict:
    """Initial parameters from ``specs`` (name -> (shape, init)), from one
    uniform draw u in [-1, 1) for all of them together: "xavier" matrices
    u times each matrix's bound, "bias" vectors 0.1 u, "scale" vectors
    1 + 0.5 u. Biases and scales are drawn, not zeros and ones, so that
    an evaluation on these weights reads every parameter."""
    dev = gen.device
    sizes = [torch.Size(s).numel() for s, _ in specs.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=dev) * 2.0 - 1.0
    out, at = {}, 0
    for (name, (shape, init)), n in zip(specs.items(), sizes):
        u = flat[at:at + n].view(shape)
        at += n
        if init == "xavier":
            out[name] = u * xavier_bound(shape)
        elif init == "bias":
            out[name] = u * 0.1
        elif init == "scale":
            out[name] = 1.0 + 0.5 * u
        else:
            raise ValueError(f"unknown init {init!r}")
    return out


def adam_step(params: dict, grads: dict, m: dict, v: dict, t: int,
              lr: float, weight_decay: float) -> None:
    """One Adam step (L2 decay added to the gradient), in place."""
    b1, b2 = ADAM_BETAS
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            if weight_decay:
                g = g + weight_decay * p
            m[name].mul_(b1).add_(g, alpha=1 - b1)
            v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m[name] / (1 - b1 ** t)
            v_hat = v[name] / (1 - b2 ** t)
            p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))


def dense_linear_flops(n_rows: int, n_in: int, n_out: int,
                       input_grad: bool = True) -> tuple[int, int]:
    """(forward, backward) FLOPs of a Dense layer on n_rows rows: the
    backward is the weight gradient and, unless it is the first layer,
    the input gradient."""
    fwd = 2 * n_rows * n_in * n_out
    return fwd, fwd * (2 if input_grad else 1)
