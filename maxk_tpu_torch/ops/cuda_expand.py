"""K6: cbsr_expand, as a CUDA kernel and its plain PyTorch version.

``cbsr_expand_forward(values, selector, dim, out_dtype)`` returns the
dense ``(V, dim)`` matrix of CBSR rows: ``out[i, selector[i, l]] =
values[i, l]`` and zeros elsewhere, in ``out_dtype`` (float32 or
bfloat16; values' dtype by default), for float32 or bfloat16 values and
int32 or uint8 selectors. ``cbsr_expand_int8(values, selector, dim)``
returns the int8 row-scale table of the same matrix, ``(q, scale)``: q
(V, dim) int8 and scale (V,) float32, bit-equal to the JAX package's
``_rowscale_int8_table`` (``maxk_tpu/ops/spgemm.py``) without its lane
packing. Both replace the TPU kernel
``tools/probe_expand.py::expand_kernel`` (the JAX package's expansion,
``maxk_tpu/ops/cbsr.py::cbsr_expand``).

A selector outside ``[0, dim)`` is dropped, as the JAX package's
compare-select chain never meets it; the row scale still counts its
value. Selectors must be distinct within a row (top-k's are).

On CUDA tensors both launch ``csrc/cbsr_expand.cu`` (one warp a row,
each output byte written once; see the source for its bound and design).
On CPU tensors they run the plain versions, ``cbsr_expand_plain``
(``scatter_`` into zeros) and ``cbsr_expand_int8_plain``. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from maxk_tpu_torch.ops.cuda_spgemm_cbsr import fma_f32

_VALUE_DTYPES = (torch.float32, torch.bfloat16)
_SELECTOR_DTYPES = (torch.int32, torch.uint8)
# The row scale's float32 constants: XLA computes max / 127 + 1e-30 as
# fma(max, float32(1 / 127), 1e-30).
_INV_127 = 1.0 / 127.0
_ROW_EPS = 1e-30


def cbsr_expand_plain(values: torch.Tensor, selector: torch.Tensor,
                      dim: int,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """scatter_ of the values (cast to out_dtype) into zeros; a selector
    outside [0, dim) lands in a column past the end, which is cut off."""
    out_dtype = values.dtype if out_dtype is None else out_dtype
    sel = selector.long()
    bad = (sel < 0) | (sel >= dim)
    width = dim
    if bool(bad.any()):
        sel, width = torch.where(bad, dim, sel), dim + 1
    out = torch.zeros((values.shape[0], width), dtype=out_dtype,
                      device=values.device).scatter_(
        1, sel, values.to(out_dtype))
    return out if width == dim else out[:, :dim].contiguous()


def row_scales(values: torch.Tensor) -> torch.Tensor:
    """The int8 row scale, max_l |values[i, l]| / 127 + 1e-30, as XLA
    computes it (one float32 fma)."""
    amax = values.float().abs().amax(1)
    return fma_f32(amax, torch.full_like(amax, _INV_127),
                   torch.full_like(amax, _ROW_EPS))


def cbsr_expand_int8_plain(values: torch.Tensor, selector: torch.Tensor,
                           dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(q, scale): the float32 expansion divided by its row's scale,
    rounded half to even and clamped to [-127, 127], as the JAX package's
    ``_rowscale_int8_table`` does."""
    scale = row_scales(values)
    dense = cbsr_expand_plain(values.float(), selector, dim, torch.float32)
    q = torch.clamp(torch.round(dense / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


@functools.cache
def _kernel(name: str):
    from maxk_tpu_torch.native.build import load
    fn = getattr(load("cbsr_expand"), name)
    if name == "cbsr_expand":
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(values: torch.Tensor, selector: torch.Tensor, dim: int) -> None:
    if values.dim() != 2 or values.dtype not in _VALUE_DTYPES:
        raise ValueError(f"cbsr_expand: need 2-D float32 or bfloat16 "
                         f"values, got {tuple(values.shape)} {values.dtype}")
    if selector.dtype not in _SELECTOR_DTYPES \
            or selector.shape != values.shape:
        raise ValueError(f"cbsr_expand: need int32 or uint8 selectors of "
                         f"the values' shape {tuple(values.shape)}, got "
                         f"{tuple(selector.shape)} {selector.dtype}")
    if selector.device != values.device:
        raise ValueError(f"cbsr_expand: values on {values.device}, "
                         f"selectors on {selector.device}")
    if dim < 0:
        raise ValueError(f"cbsr_expand: dim {dim} < 0")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cbsr_expand: unsupported device {values.device}")


def _launch(name: str, values, selector, dim: int, outs: tuple,
            stream_out: torch.Tensor) -> None:
    for label, t in (("values", values), ("selector", selector)):
        if not t.is_contiguous():
            raise ValueError(f"cbsr_expand kernel: {label} must be "
                             f"contiguous")
    v, k = values.shape
    row_bytes = dim * stream_out.element_size()
    vec = int(row_bytes % 16 == 0 and stream_out.data_ptr() % 16 == 0)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(
            values.data_ptr(), int(values.dtype == torch.bfloat16),
            selector.data_ptr(), int(selector.dtype == torch.uint8),
            *outs, v, k, dim, vec, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def cbsr_expand_forward(values: torch.Tensor, selector: torch.Tensor,
                        dim: int,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """(V, dim) in out_dtype (values' dtype by default); the kernel on
    CUDA tensors."""
    _check(values, selector, dim)
    out_dtype = values.dtype if out_dtype is None else out_dtype
    if out_dtype not in _VALUE_DTYPES:
        raise ValueError(f"cbsr_expand: out_dtype {out_dtype} is not "
                         f"float32 or bfloat16")
    if values.device.type == "cpu":
        return cbsr_expand_plain(values, selector, dim, out_dtype)
    v, k = values.shape
    if k == 0 or dim == 0 or v == 0:
        return torch.zeros((v, dim), dtype=out_dtype, device=values.device)
    out = torch.empty((v, dim), dtype=out_dtype, device=values.device)
    _launch("cbsr_expand", values, selector, dim,
            (out.data_ptr(), int(out_dtype == torch.bfloat16)), out)
    cbsr_expand_forward.launches += 1
    return out


def cbsr_expand_int8(values: torch.Tensor, selector: torch.Tensor,
                     dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(q (V, dim) int8, scale (V,) float32), the int8 row-scale table;
    the kernel's int8 mode on CUDA tensors. k >= 1."""
    _check(values, selector, dim)
    if values.shape[1] == 0:
        raise ValueError("cbsr_expand_int8: k = 0 has no row scale")
    if values.device.type == "cpu":
        return cbsr_expand_int8_plain(values, selector, dim)
    v = values.shape[0]
    q = torch.empty((v, dim), dtype=torch.int8, device=values.device)
    scale = torch.empty((v,), dtype=torch.float32, device=values.device)
    if v == 0:
        return q, scale
    if dim == 0:
        return q, row_scales(values)
    _launch("cbsr_expand_int8", values, selector, dim,
            (q.data_ptr(), scale.data_ptr()), q)
    cbsr_expand_int8.launches += 1
    return q, scale


cbsr_expand_forward.launches = 0
cbsr_expand_int8.launches = 0
