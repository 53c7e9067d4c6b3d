"""Graph ops: containers, MaxK, SpMM, CBSR, fused MaxK SpGEMM."""


def kernel_counters() -> dict:
    """Every kernel wrapper, by kernel id. Each adds one to its
    ``launches`` where it launches its kernel, and nowhere else."""
    from maxk_tpu_torch.ops.cuda_batchnorm import bn_affine, bn_dx, bn_sums
    from maxk_tpu_torch.ops.cuda_expand import (cbsr_expand_forward,
                                                cbsr_expand_int8)
    from maxk_tpu_torch.ops.cuda_gather import cbsr_gather_forward
    from maxk_tpu_torch.ops.cuda_spgemm_cbsr import spgemm_cbsr_csr
    from maxk_tpu_torch.ops.cuda_spmm import spmm_csr
    from maxk_tpu_torch.ops.cuda_spmm_int8 import spmm_int8_csr
    from maxk_tpu_torch.ops.cuda_topk import (cbsr_topk_forward,
                                              cbsr_topk_forward_wide,
                                              maxk_forward, maxk_forward_wide)
    return {"k1": maxk_forward, "k2": spmm_csr, "k3": cbsr_gather_forward,
            "k4": cbsr_topk_forward, "k5": spgemm_cbsr_csr,
            "k1_wide": maxk_forward_wide, "k4_wide": cbsr_topk_forward_wide,
            "k6": cbsr_expand_forward, "k6_int8": cbsr_expand_int8,
            "k7": spmm_int8_csr, "bn_sums": bn_sums, "bn_affine": bn_affine,
            "bn_dx": bn_dx}
