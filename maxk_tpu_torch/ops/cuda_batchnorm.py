"""GNN_res's BatchNorm passes over a (V, D) float32 activation, as CUDA
kernels and their plain PyTorch versions.

``bn_sums(a, n_valid)`` returns the two column sums ``(sum(a), sum(a *
a))`` over the first ``n_valid`` rows (None: all), and ``bn_sums(a,
norm=(x, mean, rstd))`` returns ``(sum(a), sum(a * xhat))`` over every
row with ``xhat = (x - mean) * rstd``: the training forward's statistics
and the backward's two sums, each in one read of its inputs.
``bn_affine(x, shift, scale, bias)`` returns ``(x - shift) * scale +
bias`` a column, in one pass. ``bn_dx(dy, x, mean, rstd, scale, c_dy,
c_dyx, n_valid)`` returns ``dy * scale + c_dy + xhat * c_dyx`` on the
rows below ``n_valid`` and ``dy * scale`` past them, in one pass. The
vectors are (D,) float32. ``models/models.py::_BatchNorm`` composes them
(the training pass) and ``BatchNorm.forward`` the evaluation.

The passes replace no TPU kernel (the JAX package leaves BatchNorm to
XLA). On CUDA tensors each launches a hand-written kernel of
``csrc/batchnorm.cu``, whose launchers choose the layout (slabs of rows a
block, 16-byte loads where D % 4 == 0 and the bases are aligned; see the
source for the bound and design); ``bn_sums`` adds its slabs' partials in
a second, small launch in a fixed order, so a run repeats bit for bit. On
CPU tensors each runs its plain version, which keeps the formulas the
training pass had in stock torch ops. There is no fallback between the
two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch


def bn_sums_plain(a: torch.Tensor, n_valid: Optional[int] = None,
                  norm=None):
    """(sum(a), sum(a^2)) over a[:n_valid], the square's sum as the
    squared column norm; with norm = (x, mean, rstd), (sum(a), sum(a *
    xhat)) over every row."""
    if norm is None:
        av = a[:n_valid]
        return av.sum(dim=0), torch.linalg.vector_norm(av, dim=0).square()
    x, mean, rstd = norm
    return a.sum(dim=0), (a * torch.sub(x, mean).mul_(rstd)).sum(dim=0)


def bn_affine_plain(x: torch.Tensor, shift: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return (x - shift) * scale + bias


def bn_dx_plain(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                rstd: torch.Tensor, scale: torch.Tensor, c_dy: torch.Tensor,
                c_dyx: torch.Tensor,
                n_valid: Optional[int] = None) -> torch.Tensor:
    xhat = torch.sub(x, mean).mul_(rstd)
    dx = torch.addcmul(c_dy, dy, scale).addcmul_(xhat, c_dyx)
    if n_valid is not None and n_valid < dy.shape[0]:
        dx[n_valid:] = dy[n_valid:] * scale
    return dx


@functools.cache
def _kernel(name: str):
    from maxk_tpu_torch.native.build import load
    fn = getattr(load("batchnorm"), name)
    n_ptrs, n_rows = {"bn_sums": (6, 1), "bn_affine": (5, 1),
                      "bn_dx": (8, 2)}[name]
    fn.argtypes = [*[ctypes.c_void_p] * n_ptrs, *[ctypes.c_int64] * n_rows,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_slabs(device: int) -> int:
    """The most slabs csrc/batchnorm.cu splits a launch's rows into on
    `device`: the rows of bn_sums' scratch."""
    from maxk_tpu_torch.native.build import load
    fn = load("batchnorm").bn_max_slabs
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    n = fn(device)
    if n <= 0:
        raise RuntimeError(f"bn_max_slabs: cannot ask device {device}")
    return n


def _check(name: str, tensors: dict, vectors: dict) -> None:
    """(V, D) float32 tensors of one shape and (D,) float32 vectors, all
    on one device."""
    first = next(iter(tensors.values()))
    if first.dim() != 2:
        raise ValueError(f"{name}: need a 2-D tensor, got "
                         f"{tuple(first.shape)}")
    for label, t in tensors.items():
        if t.dtype != torch.float32 or t.shape != first.shape:
            raise ValueError(f"{name}: need {label} float32 of shape "
                             f"{tuple(first.shape)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    d = first.shape[1]
    for label, t in vectors.items():
        if t.dtype != torch.float32 or t.shape != (d,):
            raise ValueError(f"{name}: need {label} float32 of shape "
                             f"({d},), got {tuple(t.shape)} {t.dtype}")
    for label, t in {**tensors, **vectors}.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {label} on {t.device}, not "
                             f"{first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def _launch(name: str, rows: int, tensors: dict, vectors: dict,
            outs: tuple, *ints: int) -> None:
    """Launch `name` of csrc/batchnorm.cu over `rows` rows: the pointers
    of the tensors, the vectors (None: a null pointer) and `outs`, then
    `ints`, rows and D. Raises on a non-contiguous tensor and on a refused
    launch."""
    for label, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {label} must be contiguous")
    first = next(iter(tensors.values()))
    # Held until the launch: a copy freed earlier could be reused.
    args = [*tensors.values(),
            *[None if t is None else t.contiguous()
              for t in vectors.values()], *outs]
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*[None if t is None else t.data_ptr()
                              for t in args], *ints, rows,
                            first.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _rows(v: int, n_valid: Optional[int]) -> int:
    """len(x[:n_valid]) for x of v rows."""
    return len(range(v)[:n_valid])


def bn_sums(a: torch.Tensor, n_valid: Optional[int] = None, norm=None):
    """The two column sums of ``bn_sums_plain``, two (D,) tensors; on
    CUDA tensors ``bn_sums_kernel`` into a scratch of partial sums, then
    ``bn_sums_finish_kernel``."""
    x, mean, rstd = (None, None, None) if norm is None else norm
    tensors = {"a": a} if x is None else {"a": a, "x": x}
    vectors = {} if x is None else {"mean": mean, "rstd": rstd}
    _check("bn_sums", tensors, vectors)
    if a.device.type == "cpu":
        return bn_sums_plain(a, n_valid, norm)
    v, d = a.shape
    rows = v if x is not None else _rows(v, n_valid)
    if rows == 0 or d == 0:
        out = torch.zeros((2, d), dtype=torch.float32, device=a.device)
        return out[0], out[1]
    out = torch.empty((2, d), dtype=torch.float32, device=a.device)
    # A partial row a slab.
    partials = torch.empty((_max_slabs(a.device.index), 2, d),
                           dtype=torch.float32, device=a.device)
    # The forward form passes null pointers for x, mean and rstd.
    _launch("bn_sums", rows, tensors,
            vectors or dict.fromkeys(("x", "mean", "rstd")), (partials, out))
    bn_sums.launches += 1
    return out[0], out[1]


def bn_affine(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """(x - shift) * scale + bias; on CUDA tensors ``bn_affine_kernel``
    (one rounding fewer: fma(x - shift, scale, bias))."""
    vectors = {"shift": shift, "scale": scale, "bias": bias}
    _check("bn_affine", {"x": x}, vectors)
    if x.device.type == "cpu":
        return bn_affine_plain(x, shift, scale, bias)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel():
        _launch("bn_affine", x.shape[0], {"x": x}, vectors, (y,))
        bn_affine.launches += 1
    return y


def bn_dx(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
          rstd: torch.Tensor, scale: torch.Tensor, c_dy: torch.Tensor,
          c_dyx: torch.Tensor, n_valid: Optional[int] = None) -> torch.Tensor:
    """BatchNorm's input gradient (``bn_dx_plain``); on CUDA tensors
    ``bn_dx_kernel`` (fma(xhat, c_dyx, fma(dy, scale, c_dy)))."""
    tensors = {"dy": dy, "x": x}
    vectors = {"mean": mean, "rstd": rstd, "scale": scale, "c_dy": c_dy,
               "c_dyx": c_dyx}
    _check("bn_dx", tensors, vectors)
    if dy.device.type == "cpu":
        return bn_dx_plain(dy, x, mean, rstd, scale, c_dy, c_dyx, n_valid)
    dx = torch.empty_like(dy, memory_format=torch.contiguous_format)
    if dy.numel():
        _launch("bn_dx", dy.shape[0], tensors, vectors, (dx,),
                _rows(dy.shape[0], n_valid))
        bn_dx.launches += 1
    return dx


bn_sums.launches = 0
bn_affine.launches = 0
bn_dx.launches = 0
