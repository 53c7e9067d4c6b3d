"""K2: CSR SpMM, as a CUDA kernel and its plain PyTorch version.

``spmm_csr(g, x)`` returns the float32 ``(V, D)`` product ``A @ x`` of a
``DeviceCSR`` and a float32 or bfloat16 ``x``, accumulated in float32
with the edge values in float32. It replaces the TPU kernel
``maxk_tpu/ops/pallas_spmm.py::_tile_reduce_kernel``.

On CUDA tensors it launches ``csrc/spmm_csr.cu`` (one warp per row on
the CSR, no atomics; see the source for its bound and design). On CPU
tensors it runs ``spmm_csr_plain``. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from maxk_tpu_torch.ops.graph import DeviceCSR

# The plain version gathers at most this many (edge, feature) products at
# once, so it never holds E x D floats.
_PLAIN_CHUNK_ELEMS = 1 << 26


def spmm_csr_plain(g: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """index_add_ of vals[:, None] * x[cols], chunked over edges."""
    d = x.shape[1]
    out = torch.zeros((g.n_nodes, d), dtype=torch.float32, device=x.device)
    rows = torch.repeat_interleave(
        torch.arange(g.n_nodes, device=x.device), torch.diff(g.indptr))
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, d))
    for lo in range(0, g.n_edges, step):
        cols = g.indices[lo:lo + step].long()
        contrib = g.values[lo:lo + step, None] * x[cols].float()
        out.index_add_(0, rows[lo:lo + step], contrib)
    return out


@functools.cache
def _kernel(dtype: torch.dtype):
    from maxk_tpu_torch.native.build import load
    lib = load("spmm_csr")
    fn = lib.spmm_csr_bf16 if dtype == torch.bfloat16 else lib.spmm_csr_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(g: DeviceCSR, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spmm: need a 2-D float32 or bfloat16 x, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[0] != g.n_nodes:
        raise ValueError(f"spmm: x has {x.shape[0]} rows, graph has "
                         f"{g.n_nodes} nodes")
    if (g.indptr.dtype != torch.int64 or g.indices.dtype != torch.int32
            or g.values.dtype != torch.float32):
        raise ValueError("spmm: need int64 indptr, int32 indices, float32 "
                         "values")
    if not (g.indptr.device == g.indices.device == g.values.device
            == x.device):
        raise ValueError(f"spmm: graph on {g.device}, x on {x.device}")


def spmm_csr(g: DeviceCSR, x: torch.Tensor) -> torch.Tensor:
    """float32 A @ x; the kernel on CUDA tensors."""
    _check(g, x)
    if x.device.type == "cpu":
        return spmm_csr_plain(g, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm: unsupported device {x.device}")
    for name, t in (("x", x), ("indptr", g.indptr),
                    ("indices", g.indices), ("values", g.values)):
        if not t.is_contiguous():
            raise ValueError(f"spmm kernel: {name} must be contiguous")
    v, d = x.shape
    out = torch.empty((v, d), dtype=torch.float32, device=x.device)
    if v == 0 or d == 0:
        return out
    # 16-byte vector loads need whole vectors per row and an aligned base.
    width = 8 if x.dtype == torch.bfloat16 else 4
    vec = width if d % width == 0 and x.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(x.dtype)(
            g.indptr.data_ptr(), g.indices.data_ptr(), g.values.data_ptr(),
            x.data_ptr(), out.data_ptr(), v, d, vec, stream)
    if err != 0:
        raise RuntimeError(f"spmm_csr kernel launch failed: CUDA error "
                           f"{err}")
    spmm_csr.launches += 1
    return out


spmm_csr.launches = 0
