"""Direct kernel interface — the port of
``maxk_tpu/bench/direct_interface.py``, API parity with the reference's
integration layer (reference direct_kernel_interface.py:24-382,
`DirectMaxKKernels` over the `maxk_cuda_kernels` extension).

Method-for-method mapping:

  load_warp4_metadata        <- cuda_kernel_bindings.cpp:287-317 (K2's
                                segment plan is built from the graph at
                                load; .warp4 files are read for wire compat
                                and validated against the graph)
  generate_maxk_sparse_data  <- direct_kernel_interface.py:58-85 (CBSR from
                                TopK, K4; exact fp32, no uint8 round trip)
  run_forward_kernel         <- direct_kernel_interface.py:87-153
  run_backward_kernel        <- direct_kernel_interface.py:155-213
  validate_against_cusparse  <- direct_kernel_interface.py:215-298 (shared
                                TopK input; torch.sparse CSR at f32, on
                                CUDA cuSPARSE itself; max-err tolerance
                                1e-3)
  benchmark_all_k_values     <- direct_kernel_interface.py:300-382

Also exposes the reference's binding-level helpers under their original
names: prepare_cbsr_format (spmm_bindings.cpp:163-184) and
topk_nonlinearity (spmm_bindings.cpp:189-204).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from maxk_tpu_torch.bench.timing import TimingResult, time_fn
from maxk_tpu_torch.ops.cbsr import cbsr_expand, cbsr_topk
from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR, resolve_device
from maxk_tpu_torch.ops.maxk import maxk

# Reference-named aliases (spmm_kernels extension surface).
prepare_cbsr_format = cbsr_topk
topk_nonlinearity = maxk


class DirectMaxKKernels:
    """Stateful convenience wrapper: one graph, many kernel invocations,
    on `device` (CUDA unless the caller asks otherwise)."""

    def __init__(self, csr: CSRGraph, graph_name: str = "graph",
                 values: Optional[np.ndarray] = None, device=None):
        if values is not None:
            csr = csr.with_values(values)
        self.csr = csr
        self.graph_name = graph_name
        self.device = resolve_device(device)
        self.g = DeviceCSR.from_csr(csr, self.device)
        self.g_t = DeviceCSR.from_csr(csr.transpose(), self.device)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device, dtype=dtype)

    # -- metadata ----------------------------------------------------------

    def load_warp4_metadata(self, meta_dir: str | Path) -> np.ndarray:
        """Read + validate this graph's .warp4 file (wire compat only; the
        kernel's schedule is the segment plan built in __init__)."""
        from maxk_tpu_torch.data.warp4 import (META_DIRNAME, load_warp4,
                                               validate_warp4)
        p = Path(meta_dir)
        if p.is_dir() and not p.name.startswith("w12"):
            p = p / META_DIRNAME
        w = load_warp4(p / f"{self.graph_name}.warp4" if p.is_dir() else p)
        validate_warp4(w, self.csr)
        return w

    # -- data --------------------------------------------------------------

    def generate_maxk_sparse_data(self, x: np.ndarray, k: int):
        """Dense (V, D) -> CBSR (values, selector), exact fp32 TopK."""
        v, s = cbsr_topk(self._tensor(x, torch.float32), k)
        return v.cpu().numpy(), s.cpu().numpy()

    # -- kernels -----------------------------------------------------------

    def run_forward_kernel(self, values, selector, dim: int,
                           timing: bool = True
                           ) -> tuple[np.ndarray, Optional[TimingResult]]:
        from maxk_tpu_torch.ops.spgemm import spgemm_forward_cbsr
        v, s = self._tensor(values), self._tensor(selector)
        out = spgemm_forward_cbsr(self.g, v, s, dim)
        t = time_fn(lambda: spgemm_forward_cbsr(self.g, v, s, dim)) \
            if timing else None
        return out.cpu().numpy(), t

    def run_backward_kernel(self, grad_output, selector,
                            timing: bool = True
                            ) -> tuple[np.ndarray, Optional[TimingResult]]:
        from maxk_tpu_torch.ops.spgemm import sspmm_sampled
        dy, s = self._tensor(grad_output), self._tensor(selector)
        out = sspmm_sampled(self.g_t, dy, s)
        t = time_fn(lambda: sspmm_sampled(self.g_t, dy, s)) \
            if timing else None
        # numpy has no bfloat16: the bf16 samples come back as float32.
        return out.float().cpu().numpy(), t

    # -- validation / benchmarking ------------------------------------------

    def validate_against_cusparse(self, x: np.ndarray, k: int,
                                  tolerance: float = 1e-3) -> dict:
        """Shared-TopK validation against the library SpMM on the densified
        CBSR input (reference semantics, direct_kernel_interface.py:
        215-298): torch.sparse CSR times dense at f32, which on CUDA is
        cuSPARSE's SpMM."""
        from maxk_tpu_torch.ops.spgemm import spgemm_forward_cbsr
        xt = self._tensor(x, torch.float32)
        v, s = cbsr_topk(xt, k)
        dim = x.shape[1]
        out = spgemm_forward_cbsr(self.g, v, s, dim,
                                  compute_dtype=torch.float32)
        g = self.g
        # int64 indices on both arrays: cuSPARSE faults on mixed index
        # types, which torch does not check. The invariant check stays
        # off: it would also demand sorted, distinct columns per row.
        a = torch.sparse_csr_tensor(g.indptr, g.indices.long(), g.values,
                                    size=(g.n_nodes, g.n_nodes),
                                    check_invariants=False)
        ref = torch.sparse.mm(a, cbsr_expand(v, s, dim))
        out_np = out.cpu().numpy().astype(np.float64)
        ref_np = ref.cpu().numpy().astype(np.float64)
        err = np.abs(out_np - ref_np)
        scale = max(1.0, float(np.abs(ref_np).mean()))
        max_err = float(err.max() / scale)
        return dict(passed=bool(max_err < tolerance), max_err=max_err,
                    mean_err=float(err.mean() / scale), k=k,
                    tolerance=tolerance)

    def benchmark_all_k_values(self, x: np.ndarray,
                               k_values: Sequence[int] = (16, 32, 64),
                               ) -> dict:
        """Per-k TopK/forward/backward timing sweep
        (reference direct_kernel_interface.py:300-382)."""
        dim = x.shape[1]
        xt = self._tensor(x, torch.float32)
        dy = np.random.default_rng(7).uniform(
            size=(self.csr.n_nodes, dim)).astype(np.float32)
        results = {}
        for k in k_values:
            tk = time_fn(lambda: cbsr_topk(xt, k))
            v, s = cbsr_topk(xt, k)
            _, tf = self.run_forward_kernel(v, s, dim)
            _, tb = self.run_backward_kernel(dy, s)
            results[k] = dict(topk_ms=tk.mean_ms, forward_ms=tf.mean_ms,
                              backward_ms=tb.mean_ms)
        return results
