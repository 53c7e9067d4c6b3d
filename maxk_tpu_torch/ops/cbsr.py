"""CBSR, the compressed format of MaxK activations.

A (V, D) matrix with k nonzeros per row is stored as:
  values:   (V, k) float32, the kept entries
  selector: (V, k) int32, their columns, ascending per row

as in the JAX package (``maxk_tpu/ops/cbsr.py``): exact float32 values,
no uint8 round trip, and int32 selectors, so no cap on D. The stored
selectors stay int32; ``scatter_`` and ``gather`` get an int64 copy.

- ``cbsr_topk``: each row's exact top-k as CBSR, first-column ties, at
  any D (``ops/cuda_topk.py``: on the card K4 up to 1024 columns, the
  wide kernel ``csrc/topk_wide.cu`` above).
- ``cbsr_expand``: CBSR back to a dense (V, dim) matrix.
- ``cbsr_gather``: a dense (V, D) matrix sampled at the selectors (K3,
  ``ops/cuda_gather.py``), in the input's dtype.
- ``cbsr_nbytes``: CBSR and dense sizes, for traffic accounting.
"""

from __future__ import annotations

import torch

from maxk_tpu_torch.ops.cuda_gather import cbsr_gather_forward
from maxk_tpu_torch.ops.cuda_topk import cbsr_topk_forward

cbsr_topk = cbsr_topk_forward
cbsr_gather = cbsr_gather_forward


def cbsr_expand(values: torch.Tensor, selector: torch.Tensor,
                dim: int) -> torch.Tensor:
    """dense[i, selector[i, l]] = values[i, l], zeros elsewhere; (V, dim)
    in values' dtype. Selectors must be distinct within a row."""
    return torch.zeros((values.shape[0], dim), dtype=values.dtype,
                       device=values.device).scatter_(
        1, selector.long(), values)


def cbsr_nbytes(n_nodes: int, k: int, dim: int,
                value_dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """(cbsr_bytes, dense_bytes) for traffic accounting. The selector is
    counted at the narrowest integer width that can index dim."""
    val_b = value_dtype.itemsize
    sel_b = 1 if dim <= 256 else (2 if dim <= 65536 else 4)
    return n_nodes * k * (val_b + sel_b), n_nodes * dim * val_b
