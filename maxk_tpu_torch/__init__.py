"""maxk_tpu_torch — the maxk_tpu system on PyTorch and CUDA.

Full-graph GNN training with the MaxK nonlinearity on one NVIDIA Hopper
GPU: numpy CSR graphs and seeded datasets, a device CSR, the MaxK
nonlinearity, the CSR SpMM and the CBSR top-k and gather as hand-written
CUDA kernels (``csrc/``, built with nvcc at first use), the fused MaxK
SpGEMM on its mask and CBSR routes, SAGE models and the training loop.
Every op also runs on CPU tensors through its kernel's plain PyTorch
version. ``parallel/`` trains row-partitioned over the ranks of a
``torch.distributed`` group, with the halo exchange and the CBSR wire.
The JAX package ``maxk_tpu`` is the reference; this package imports none
of it.
"""

__version__ = "0.1.0"

from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.maxk import maxk
from maxk_tpu_torch.ops.spmm import spmm, spmm_t
from maxk_tpu_torch.ops.cbsr import (cbsr_expand, cbsr_gather, cbsr_nbytes,
                                     cbsr_topk)
from maxk_tpu_torch.ops.spgemm import (maxk_spgemm, spgemm_forward_cbsr,
                                       sspmm_sampled)
from maxk_tpu_torch.models.models import SAGE
from maxk_tpu_torch.train.loop import Trainer

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "maxk",
    "spmm",
    "spmm_t",
    "maxk_spgemm",
    "cbsr_topk",
    "cbsr_expand",
    "cbsr_gather",
    "cbsr_nbytes",
    "spgemm_forward_cbsr",
    "sspmm_sampled",
    "SAGE",
    "Trainer",
    "__version__",
]
