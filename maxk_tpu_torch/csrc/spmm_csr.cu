// K2: CSR SpMM on Hopper (sm_90a), out = A @ x with float32 accumulation.
//
// Replaces the TPU kernel maxk_tpu/ops/pallas_spmm.py::_tile_reduce_kernel
// (wrappers tile_reduce_pallas / spmm_pallas; the JAX package runs the
// same function as the XLA scan ops/spmm.py::_spmm_tiled_impl):
//   out[r, :] = sum_{e in row r} vals[e] * x[cols[e], :]
// with A given as CSR (int64 indptr, int32 indices, float32 values), x
// float32 or bfloat16, out float32.
//
// What bounds it on the H100: at D=256 the arithmetic (2*E*D flops on
// the FMA units, 67 TFLOP/s) and the compulsory bytes (x, the CSR arrays
// and out, once each, at 3.35 TB/s) take about the same time. The real
// traffic is larger: each edge re-reads a row of x (E*D*elem bytes from
// L2), and only the part of x that stays in the 50 MB L2 is read at L2
// speed.
//
// Design: no edge tiles. The work items are row segments of at most
// seg_len consecutive edges (the warp4 split, ops/graph.py SegmentPlan),
// so a hub row of 10^5 edges is spread over hundreds of warps instead of
// serialised on one. One warp per segment:
// - It loads 32 (col, val) pairs at a time, coalesced, and broadcasts
//   them with __shfl_sync.
// - A warp covers a slab of kSlab = 128 columns: each lane owns VEC = 4
//   consecutive columns (one 16-byte load at float32, 8 bytes at
//   bfloat16), or, with VEC = 1 (scalar loads, for unaligned x or a D
//   that is not a multiple of 4), 4 chunks of one column. A slab wider
//   than D is masked, a D wider than the slab is covered by more slabs
//   (grid.y).
// - Slabs run as passes: blocks are dispatched x-fastest, so every
//   segment's first slab runs before any second slab. At V = 131072 a
//   128-column pass gathers from a slice of x (32 MiB in bfloat16) that
//   the 50 MB L2 holds; whole 256-column rows were 15 % slower at
//   bfloat16 and 24 % at float32 (PERF.md).
// - Each lane issues kGathers = 4 loads (the gathers of 4 edges at
//   VEC = 4, of 1 edge at VEC = 1) before their FMAs, through the
//   read-only path (__ldg), so that several loads are in flight and the
//   hot hub rows of x hit L1. 2 and 8 were slower at the train shape
//   (PERF.md).
// - float32 accumulators stay in registers; each lane sums its columns
//   over the segment's edges in CSR order.
// A row of one segment writes out directly. A split row's segments write
// float32 partials to a workspace; a second kernel sums each split row's
// partials in segment order, and writes zeros to the zero-degree rows.
// No atomics: every sum has a fixed order, so the result is bit-for-bit
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSlab = 128;            // columns of x a pass covers
constexpr int kGathers = 4;           // loads a lane issues before FMAs
constexpr int kFinishThreads = 64;
constexpr int kFinishInFlight = 16;   // partial rows a thread loads ahead

template <typename T, int VEC>
struct Gather;

template <>
struct Gather<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ static void fma(float w, const Raw& r,
                                             float* acc) {
    acc[0] = fmaf(w, r.x, acc[0]);
    acc[1] = fmaf(w, r.y, acc[1]);
    acc[2] = fmaf(w, r.z, acc[2]);
    acc[3] = fmaf(w, r.w, acc[3]);
  }
};

template <>
struct Gather<float, 1> {
  using Raw = float;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static void fma(float w, const Raw& r,
                                             float* acc) {
    acc[0] = fmaf(w, r, acc[0]);
  }
};

template <>
struct Gather<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static void fma(float w, const Raw& r,
                                             float* acc) {
    const uint32_t u[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // A bf16's float32 bit pattern is its 16 bits in the top half.
      acc[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), acc[2 * i]);
      acc[2 * i + 1] =
          fmaf(w, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
    }
  }
};

template <>
struct Gather<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static void fma(float w, const Raw& r,
                                             float* acc) {
    acc[0] = fmaf(w, __uint_as_float((uint32_t)r << 16), acc[0]);
  }
};

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_segment_kernel(const int64_t* __restrict__ indptr,
                    const int32_t* __restrict__ indices,
                    const float* __restrict__ vals, const T* __restrict__ x,
                    float* __restrict__ out, float* __restrict__ partials,
                    const Plan plan, int d) {
  using G = Gather<T, VEC>;
  constexpr int kChunks = kSlab / (32 * VEC);
  // Edges whose gathers are issued together; it divides 32.
  constexpr int kGroup = kGathers / kChunks;
  const int lane = threadIdx.x & 31;
  const int64_t s =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= plan.n_seg) return;   // whole warps exit together
  const int slab = blockIdx.y * kSlab;

  const int64_t row = plan.seg_row[s];
  const int64_t start = plan.seg_start[s];
  const int64_t left = indptr[row + 1] - start;
  const int n = left < plan.seg_len ? (int)left : plan.seg_len;

  float acc[kChunks][VEC];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[c][q] = 0.0f;

  for (int base = 0; base < n; base += 32) {
    const int m = n - base < 32 ? n - base : 32;
    const bool in = lane < m;
    const int32_t col_l = in ? indices[start + base + lane] : 0;
    const float val_l = in ? vals[start + base + lane] : 0.0f;
    for (int i = 0; i < m; i += kGroup) {
      int32_t col[kGroup];
      float val[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        col[g] = __shfl_sync(0xffffffffu, col_l, i + g);
        val[g] = __shfl_sync(0xffffffffu, val_l, i + g);
      }
      // All of the group's gathers first, then their FMAs in edge order.
      typename G::Raw raw[kGroup][kChunks];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const T* xr = x + (int64_t)col[g] * d;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int f = slab + c * 32 * VEC + lane * VEC;
          if (i + g < m && f < d) raw[g][c] = G::load(xr + f);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (i + g < m) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int f = slab + c * 32 * VEC + lane * VEC;
            if (f < d) G::fma(val[g], raw[g][c], acc[c]);
          }
        }
      }
    }
  }

  const int32_t slot = plan.seg_slot[s];
  float* dst = slot < 0 ? out + row * d : partials + (int64_t)slot * d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int f = slab + c * 32 * VEC + lane * VEC;
    if (f < d) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < VEC; q += 4)
          *reinterpret_cast<float4*>(dst + f + q) = make_float4(
              acc[c][q], acc[c][q + 1], acc[c][q + 2], acc[c][q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) dst[f + q] = acc[c][q];
      }
    }
  }
}

// One block per row of the finish list: out[row] = sum of its partials
// rows, in segment order, from 0.0f; an empty range writes zeros.
template <int VEC>
__global__ void __launch_bounds__(kFinishThreads)
spmm_finish_kernel(const float* __restrict__ partials,
                   float* __restrict__ out, const Plan plan, int d) {
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
    float* o = out + row * d + f;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
    } else {
      *o = acc[0];
    }
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* indptr, const void* indices,
                   const void* vals, const void* x, void* out,
                   void* partials, const Plan& plan, int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<float*>(partials);
  auto op = static_cast<float*>(out);
  if (plan.n_seg > 0) {
    const dim3 grid(
        (unsigned)((plan.n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock),
        (unsigned)((d + kSlab - 1) / kSlab));
    spmm_segment_kernel<T, VEC><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(vals), static_cast<const T*>(x), op, pp,
        plan, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (plan.n_fin > 0) {
    // out and partials come from torch.empty (aligned), so whole float4
    // rows need only d % 4 == 0.
    if (d % 4 == 0)
      spmm_finish_kernel<4><<<(unsigned)plan.n_fin, kFinishThreads, 0, s>>>(
          pp, op, plan, d);
    else
      spmm_finish_kernel<1><<<(unsigned)plan.n_fin, kFinishThreads, 0, s>>>(
          pp, op, plan, d);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* indptr, const void* indices, const void* vals,
             const void* x, void* out, void* partials, const void* seg_row,
             const void* seg_start, const void* seg_slot, int64_t n_seg,
             int seg_len, const void* fin_row, const void* fin_ptr,
             int64_t n_fin, int d, int vec, void* stream) {
  const Plan plan{static_cast<const int32_t*>(seg_row),
                  static_cast<const int64_t*>(seg_start),
                  static_cast<const int32_t*>(seg_slot), n_seg, seg_len,
                  static_cast<const int32_t*>(fin_row),
                  static_cast<const int64_t*>(fin_ptr), n_fin};
  if (vec == 4)
    return launch<T, 4>(indptr, indices, vals, x, out, partials, plan, d,
                        stream);
  if (vec == 1)
    return launch<T, 1>(indptr, indices, vals, x, out, partials, plan, d,
                        stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Each returns the launches' cudaError_t (0 on success). The caller checks
// shapes, types and contiguity, allocates out (n_rows, d) and partials
// (n_partials, d) as float32, and passes vec = 4 (16-byte loads at
// float32, 8-byte at bfloat16) if d is a multiple of 4 and x is aligned
// to 4 elements, else vec = 1 (scalar loads).
extern "C" int spmm_csr_f32(const void* indptr, const void* indices,
                            const void* vals, const void* x, void* out,
                            void* partials, const void* seg_row,
                            const void* seg_start, const void* seg_slot,
                            int64_t n_seg, int seg_len, const void* fin_row,
                            const void* fin_ptr, int64_t n_fin, int d,
                            int vec, void* stream) {
  return dispatch<float>(indptr, indices, vals, x, out, partials, seg_row,
                         seg_start, seg_slot, n_seg, seg_len, fin_row,
                         fin_ptr, n_fin, d, vec, stream);
}

extern "C" int spmm_csr_bf16(const void* indptr, const void* indices,
                             const void* vals, const void* x, void* out,
                             void* partials, const void* seg_row,
                             const void* seg_start, const void* seg_slot,
                             int64_t n_seg, int seg_len, const void* fin_row,
                             const void* fin_ptr, int64_t n_fin, int d,
                             int vec, void* stream) {
  return dispatch<__nv_bfloat16>(indptr, indices, vals, x, out, partials,
                                 seg_row, seg_start, seg_slot, n_seg,
                                 seg_len, fin_row, fin_ptr, n_fin, d, vec,
                                 stream);
}
