// K5: the CBSR-operand forward SpGEMM on Hopper (sm_90a),
//   out[r, :] = sum_{e in row r} vals[e] * expand(values[cols[e]],
//                                                 selector[cols[e]])
// with float32 accumulation: A @ cbsr_expand(values, selector, d), read
// from the compressed rows. A is CSR (int64 indptr, int32 indices, float32
// values); values is (n_cols, k) float32 or bfloat16, selector (n_cols, k)
// uint8 (d <= 256); out is (n_rows, d) float32.
//
// It has no Pallas counterpart: it replaces the XLA scan
// maxk_tpu/ops/spgemm.py::_spgemm_cbsr_impl (reached through
// _spgemm_cbsr_gather under CBSR_GATHER_MODE), which expands each gathered
// CBSR row in the tile. Its design is the reference's forward kernel
// (spmm_maxk.cu): a per-edge scatter into a shared-memory row.
//
// What bounds it on the H100: an edge reads k values and k selectors
// (3k bytes at bfloat16: 96 B at k = 32, where K2 on the expanded operand
// reads a 512-byte row), and the table (n_cols * 3k bytes) stays in the
// 50 MB L2. The compulsory bytes (the CSR arrays, the table and out, once
// each) bound it at HBM speed; the shared-memory scatter costs one load
// and one store per kept entry and edge, in as many wavefronts as the
// lanes' columns collide on banks (about 3 at k = 32 of 256 columns).
// It runs far from both (PERF.md): a warp walks its segment's edges one
// group at a time, in order, and waits for each group's gathers and then
// its scatter, so the time goes to latency; removing the scatter alone or
// the gathers alone left most of it.
//
// Design: K2's work split (segment_plan.cuh) with K2's dense gather
// replaced by the scatter. One warp per segment of at most seg_len edges,
// two warps a block:
// - The warp keeps a d-wide float32 row in shared memory (<= 1 KB), zeroed
//   first.
// - It stages 32 (col, val) pairs at a time in shared memory, loaded
//   coalesced; each edge reads its pair back as one broadcast.
// - Lane l takes the kept entries j = l, l + 32, ... (< k) of an edge's
//   source row: C = ceil(k / 32) values and selectors, read as scalars,
//   so a row pitch of any k (7 bf16 values are 14 bytes) needs no
//   alignment.
// - The loads of a group of edges (kEntriesAhead / C of them) are issued
//   first, through the read-only path; then the edges are applied one
//   after another, in CSR order: row[sel] = fmaf(w, v, row[sel]), and
//   __syncwarp() before the next edge. Selectors are distinct within a
//   row, so the lanes of one edge never write one column twice, and every
//   column's sum is taken in edge order. That is K2's sum on the expanded
//   operand, fmaf for fmaf, bit for bit: K2's extra terms are
//   fmaf(w, 0, acc), which change nothing but the sign of a zero sum.
// - A row of one segment writes out directly; a split row writes its
//   partials row, summed in segment order by the finish pass K2 uses
//   (segment_plan.cuh), launched here as spgemm_cbsr_finish_kernel.
// The group size and the block size were chosen on the card at the SAGE
// cell (PERF.md): more loads in flight a warp, or the next group's loads
// issued before this group's scatter, cost more in occupancy (registers)
// than they hid; staging the pairs beat two shuffles an edge.
// No atomics (the reference flushes its shared row with atomicAdd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_plan.cuh"

namespace {

using segplan::Plan;

constexpr int kWarpsPerBlock = 2;
constexpr int kMaxD = 256;            // uint8 selectors
constexpr int kEntriesAhead = 4;      // loads a lane has in flight

template <typename T>
struct Value;

template <>
struct Value<float> {
  using Raw = float;
  __device__ __forceinline__ static Raw load(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static float get(Raw r) { return r; }
};

template <>
struct Value<__nv_bfloat16> {
  using Raw = unsigned short;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  // A bf16's float32 bit pattern is its 16 bits in the top half.
  __device__ __forceinline__ static float get(Raw r) {
    return __uint_as_float((uint32_t)r << 16);
  }
};

// The kept entries of kGroup edges of a staged chunk, in registers.
template <typename T, int C, int G>
struct Batch {
  float w[G];
  typename Value<T>::Raw v[G][C];
  uint32_t sel[G][C];
};

// Issue the loads of edges i .. i + G - 1 of the chunk (those below m):
// lane l takes the entries l, l + 32, ... (< k) of each edge's row.
template <typename T, int C, int G>
__device__ __forceinline__ void load_batch(Batch<T, C, G>& b,
                                           const int2* edge, int i, int m,
                                           const T* __restrict__ values,
                                           const uint8_t* __restrict__ selector,
                                           int k, int lane) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int2 e = edge[i + g];
    b.w[g] = __int_as_float(e.y);
    const size_t at = (size_t)(uint32_t)e.x * (uint32_t)k;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      if (i + g < m && j < k) {
        b.v[g][c] = Value<T>::load(values + at + j);
        b.sel[g][c] = __ldg(selector + at + j);
      }
    }
  }
}

// Apply the batch's edges to the row one after another, in CSR order.
template <typename T, int C, int G>
__device__ __forceinline__ void apply_batch(const Batch<T, C, G>& b,
                                            float* row, int i, int m, int k,
                                            int lane) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (i + g < m && lane + 32 * c < k) {
        float* p = row + b.sel[g][c];
        *p = fmaf(b.w[g], Value<T>::get(b.v[g][c]), *p);
      }
    }
    __syncwarp();
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spgemm_cbsr_kernel(const int64_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const float* __restrict__ vals,
                   const T* __restrict__ values,
                   const uint8_t* __restrict__ selector,
                   float* __restrict__ out, float* __restrict__ partials,
                   const Plan plan, int k, int d) {
  // Edges whose loads are issued together; it divides 32.
  constexpr int kGroup = kEntriesAhead / C >= 2 ? kEntriesAhead / C : 2;
  __shared__ float rows[kWarpsPerBlock][kMaxD];
  __shared__ int2 edges[kWarpsPerBlock][32];   // (col, val bits)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (s >= plan.n_seg) return;   // whole warps exit together
  float* row = rows[warp];
  int2* edge = edges[warp];
  for (int f = lane; f < d; f += 32) row[f] = 0.0f;

  const int64_t r = plan.seg_row[s];
  const int64_t start = plan.seg_start[s];
  const int64_t left = indptr[r + 1] - start;
  const int n = left < plan.seg_len ? (int)left : plan.seg_len;

  for (int base = 0; base < n; base += 32) {
    const int m = n - base < 32 ? n - base : 32;
    if (lane < m)
      edge[lane] = make_int2(indices[start + base + lane],
                             __float_as_int(vals[start + base + lane]));
    __syncwarp();
    for (int i = 0; i < m; i += kGroup) {
      Batch<T, C, kGroup> batch;
      load_batch(batch, edge, i, m, values, selector, k, lane);
      apply_batch(batch, row, i, m, k, lane);
    }
  }

  const int32_t slot = plan.seg_slot[s];
  float* dst = slot < 0 ? out + r * d : partials + (int64_t)slot * d;
  for (int f = lane; f < d; f += 32) dst[f] = row[f];
}

// The finish pass (segment_plan.cuh) under this kernel's name.
template <int VEC>
__global__ void __launch_bounds__(segplan::kFinishThreads)
spgemm_cbsr_finish_kernel(const float* __restrict__ partials,
                          float* __restrict__ out, const Plan plan, int d) {
  segplan::finish_rows<VEC>(partials, out, plan, d);
}

template <typename T, int C>
cudaError_t launch(const void* indptr, const void* indices, const void* vals,
                   const void* values, const void* selector, void* out,
                   void* partials, const Plan& plan, int k, int d,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<float*>(partials);
  auto op = static_cast<float*>(out);
  if (plan.n_seg > 0) {
    const unsigned grid =
        (unsigned)((plan.n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock);
    spgemm_cbsr_kernel<T, C><<<grid, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int64_t*>(indptr),
        static_cast<const int32_t*>(indices),
        static_cast<const float*>(vals), static_cast<const T*>(values),
        static_cast<const uint8_t*>(selector), op, pp, plan, k, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return segplan::launch_finish(spgemm_cbsr_finish_kernel<4>,
                                spgemm_cbsr_finish_kernel<1>, pp, op,
                                plan, d, s);
}

template <typename T>
int dispatch(const void* indptr, const void* indices, const void* vals,
             const void* values, const void* selector, void* out,
             void* partials, const void* seg_row, const void* seg_start,
             const void* seg_slot, int64_t n_seg, int seg_len,
             const void* fin_row, const void* fin_ptr, int64_t n_fin, int k,
             int d, void* stream) {
  if (k < 1 || k > 4 * 32 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  const Plan plan = segplan::make_plan(seg_row, seg_start, seg_slot, n_seg,
                                       seg_len, fin_row, fin_ptr, n_fin);
  switch ((k + 31) / 32) {
    case 1:
      return launch<T, 1>(indptr, indices, vals, values, selector, out,
                          partials, plan, k, d, stream);
    case 2:
      return launch<T, 2>(indptr, indices, vals, values, selector, out,
                          partials, plan, k, d, stream);
    case 3:
      return launch<T, 3>(indptr, indices, vals, values, selector, out,
                          partials, plan, k, d, stream);
    default:
      return launch<T, 4>(indptr, indices, vals, values, selector, out,
                          partials, plan, k, d, stream);
  }
}

}  // namespace

// Each returns the launches' cudaError_t (0 on success). The caller checks
// shapes, types and contiguity, guarantees 1 <= k <= 128, d <= 256 and
// 0 <= selector < d, distinct within a row, and allocates out
// (n_rows, d) and partials (n_partials, d) as float32.
extern "C" int spgemm_cbsr_f32(const void* indptr, const void* indices,
                               const void* vals, const void* values,
                               const void* selector, void* out,
                               void* partials, const void* seg_row,
                               const void* seg_start, const void* seg_slot,
                               int64_t n_seg, int seg_len,
                               const void* fin_row, const void* fin_ptr,
                               int64_t n_fin, int k, int d, void* stream) {
  return dispatch<float>(indptr, indices, vals, values, selector, out,
                         partials, seg_row, seg_start, seg_slot, n_seg,
                         seg_len, fin_row, fin_ptr, n_fin, k, d, stream);
}

extern "C" int spgemm_cbsr_bf16(const void* indptr, const void* indices,
                                const void* vals, const void* values,
                                const void* selector, void* out,
                                void* partials, const void* seg_row,
                                const void* seg_start, const void* seg_slot,
                                int64_t n_seg, int seg_len,
                                const void* fin_row, const void* fin_ptr,
                                int64_t n_fin, int k, int d, void* stream) {
  return dispatch<__nv_bfloat16>(indptr, indices, vals, values, selector,
                                 out, partials, seg_row, seg_start, seg_slot,
                                 n_seg, seg_len, fin_row, fin_ptr, n_fin, k,
                                 d, stream);
}
