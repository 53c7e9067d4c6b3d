"""maxk_tpu_torch — the maxk_tpu system on PyTorch and CUDA.

Full-graph GNN training with the MaxK nonlinearity on one NVIDIA Hopper
GPU: numpy CSR graphs and seeded datasets, a device CSR, the MaxK
nonlinearity and the CSR SpMM as hand-written CUDA kernels
(``csrc/``, built with nvcc at first use), the fused MaxK SpGEMM, SAGE
models and the training loop. Every op also runs on CPU tensors through
its kernel's plain PyTorch version. The JAX package ``maxk_tpu`` is the
reference; this package imports none of it.
"""

__version__ = "0.1.0"

from maxk_tpu_torch.ops.graph import CSRGraph, DeviceCSR
from maxk_tpu_torch.ops.maxk import maxk
from maxk_tpu_torch.ops.spmm import spmm, spmm_t
from maxk_tpu_torch.ops.spgemm import maxk_spgemm
from maxk_tpu_torch.models.models import SAGE
from maxk_tpu_torch.train.loop import Trainer

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "maxk",
    "spmm",
    "spmm_t",
    "maxk_spgemm",
    "SAGE",
    "Trainer",
    "__version__",
]
