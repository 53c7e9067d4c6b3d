"""K3: CBSR gather, as a CUDA kernel and its plain PyTorch version.

``cbsr_gather_forward(dense, selector)`` returns
``out[i, l] = dense[i, selector[i, l]]``: a (V, D) float32 or bfloat16
``dense`` sampled at a (V, k) int32 ``selector``, as (V, k) in
``dense``'s dtype. It replaces the TPU kernel
``maxk_tpu/ops/pallas_gather.py::_gather_kernel`` (the JAX package's
``ops/cbsr.py::cbsr_gather``, which keeps the input dtype).

On CUDA tensors it launches ``csrc/cbsr_gather.cu`` (one thread per
output element; see the source for its bound and design). On CPU tensors
it runs ``cbsr_gather_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def cbsr_gather_plain(dense: torch.Tensor,
                      selector: torch.Tensor) -> torch.Tensor:
    """torch.gather along the channel axis."""
    return torch.gather(dense, 1, selector.long())


@functools.cache
def _kernel(dtype: torch.dtype):
    from maxk_tpu_torch.native.build import load
    lib = load("cbsr_gather")
    fn = lib.cbsr_gather_bf16 if dtype == torch.bfloat16 \
        else lib.cbsr_gather_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(dense: torch.Tensor, selector: torch.Tensor) -> None:
    if dense.dim() != 2 or dense.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"cbsr_gather: need a 2-D float32 or bfloat16 "
                         f"dense, got {tuple(dense.shape)} {dense.dtype}")
    if selector.dim() != 2 or selector.dtype != torch.int32:
        raise ValueError(f"cbsr_gather: need a 2-D int32 selector, got "
                         f"{tuple(selector.shape)} {selector.dtype}")
    if selector.shape[0] != dense.shape[0]:
        raise ValueError(f"cbsr_gather: selector has {selector.shape[0]} "
                         f"rows, dense has {dense.shape[0]}")
    if selector.device != dense.device:
        raise ValueError(f"cbsr_gather: dense on {dense.device}, selector "
                         f"on {selector.device}")


def cbsr_gather_forward(dense: torch.Tensor,
                        selector: torch.Tensor) -> torch.Tensor:
    """(V, k) samples of dense in its dtype; the kernel on CUDA tensors.
    Selectors must lie in [0, D): the kernel does not check them."""
    _check(dense, selector)
    if dense.device.type == "cpu":
        return cbsr_gather_plain(dense, selector)
    if dense.device.type != "cuda":
        raise ValueError(f"cbsr_gather: unsupported device {dense.device}")
    for name, t in (("dense", dense), ("selector", selector)):
        if not t.is_contiguous():
            raise ValueError(f"cbsr_gather kernel: {name} must be "
                             f"contiguous")
    v, d = dense.shape
    k = selector.shape[1]
    out = torch.empty((v, k), dtype=dense.dtype, device=dense.device)
    if v == 0 or k == 0:
        return out
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(dense.dtype)(dense.data_ptr(), selector.data_ptr(),
                                   out.data_ptr(), v, d, k, stream)
    if err != 0:
        raise RuntimeError(f"cbsr_gather kernel launch failed: CUDA error "
                           f"{err}")
    cbsr_gather_forward.launches += 1
    return out


cbsr_gather_forward.launches = 0
