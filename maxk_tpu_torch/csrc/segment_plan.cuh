// The segment plan and its finish pass, shared by K2 (spmm_csr.cu), K5
// (spgemm_cbsr.cu) and K7 (spmm_int8.cu).
//
// Both kernels cut every row's edges into segments of at most seg_len
// consecutive edges (ops/graph.py SegmentPlan) and sum each segment on
// one warp. A row of one segment writes out directly. A split row's
// segments write float32 partials rows; the finish pass below sums each
// split row's partials in segment order, from 0.0f, and writes zeros to
// the zero-degree rows (its rows with an empty range of partials). No
// atomics: every sum has a fixed order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace segplan {

constexpr int kFinishThreads = 64;
constexpr int kFinishInFlight = 16;   // partial rows a thread loads ahead

// The segment plan, as ops/graph.py SegmentPlan lays it out.
struct Plan {
  const int32_t* seg_row;     // (n_seg,) row of each segment
  const int64_t* seg_start;   // (n_seg,) its first edge
  const int32_t* seg_slot;    // (n_seg,) its partials row, -1: write out
  int64_t n_seg;
  int seg_len;
  const int32_t* fin_row;     // (n_fin,) split rows, then zero-degree rows
  const int64_t* fin_ptr;     // (n_fin + 1,) their ranges of partials rows
  int64_t n_fin;
};

// The body of a finish kernel, run by one block per row of the finish
// list: out[row] = sum of its partials rows, in segment order, from 0.0f;
// an empty range writes zeros. Each source wraps it in a __global__ of its
// own name (spmm_finish_kernel, spgemm_cbsr_finish_kernel,
// spmm_int8_finish_kernel), so a profile puts the pass under the kernel
// that launched it. With SCALE (K7's per-column int8 scale) each sum is
// multiplied by col_scale[column] before it is stored; without it the
// pass is K2's and K5's, unchanged.
template <int VEC, bool SCALE = false>
__device__ __forceinline__ void finish_rows(
    const float* __restrict__ partials, float* __restrict__ out,
    const Plan plan, int d, const float* __restrict__ col_scale = nullptr) {
  const int64_t i = blockIdx.x;
  const int64_t row = plan.fin_row[i];
  const int64_t p0 = plan.fin_ptr[i];
  const int64_t p1 = plan.fin_ptr[i + 1];
  for (int f = threadIdx.x * VEC; f < d; f += kFinishThreads * VEC) {
    float acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0.0f;
    for (int64_t p = p0; p < p1; p += kFinishInFlight) {
      float part[kFinishInFlight][VEC];
#pragma unroll
      for (int j = 0; j < kFinishInFlight; ++j) {
        if (p + j < p1) {
          const float* src = partials + (p + j) * d + f;
          if constexpr (VEC == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            part[j][0] = v.x; part[j][1] = v.y;
            part[j][2] = v.z; part[j][3] = v.w;
          } else {
            part[j][0] = *src;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kFinishInFlight; ++j)
        if (p + j < p1)
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[q] += part[j][q];
    }
    if constexpr (SCALE) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] *= col_scale[f + q];
    }
    float* o = out + row * d + f;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
    } else {
      *o = acc[0];
    }
  }
}

// A finish kernel: finish_rows<VEC> under the caller's name.
typedef void (*FinishKernel)(const float* __restrict__,
                             float* __restrict__, const Plan, int);

// Launch the finish pass (vec4 or vec1, the caller's finish_rows<4> and
// <1>) if the plan has rows for it; returns cudaGetLastError(). out and
// partials come from torch.empty (aligned), so whole float4 rows need
// only d % 4 == 0.
inline cudaError_t launch_finish(FinishKernel vec4, FinishKernel vec1,
                                 float* partials, float* out,
                                 const Plan& plan, int d,
                                 cudaStream_t stream) {
  if (plan.n_fin > 0) {
    const FinishKernel finish = d % 4 == 0 ? vec4 : vec1;
    finish<<<(unsigned)plan.n_fin, kFinishThreads, 0, stream>>>(partials,
                                                               out, plan, d);
  }
  return cudaGetLastError();
}

// The plan from the C interface's pointers.
inline Plan make_plan(const void* seg_row, const void* seg_start,
                      const void* seg_slot, int64_t n_seg, int seg_len,
                      const void* fin_row, const void* fin_ptr,
                      int64_t n_fin) {
  return Plan{static_cast<const int32_t*>(seg_row),
              static_cast<const int64_t*>(seg_start),
              static_cast<const int32_t*>(seg_slot), n_seg, seg_len,
              static_cast<const int32_t*>(fin_row),
              static_cast<const int64_t*>(fin_ptr), n_fin};
}

}  // namespace segplan
