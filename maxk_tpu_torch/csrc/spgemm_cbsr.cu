// K5: the CBSR-operand forward SpGEMM on Hopper (sm_90a),
//   out[r, :] = sum_{e in row r} vals[e] * expand(values[cols[e]],
//                                                 selector[cols[e]])
// with float32 accumulation: A @ cbsr_expand(values, selector, d), read
// from the compressed rows. A is CSR (int32 indices, float32 values) cut
// into the segment plan (segment_plan.cuh); values is (n_cols, k) float32
// or bfloat16, selector (n_cols, k) uint8 (d <= 256); out is (n_rows, d)
// float32.
//
// It has no Pallas counterpart: it replaces the XLA scan
// maxk_tpu/ops/spgemm.py:144 _spgemm_cbsr_impl (reached through
// _spgemm_cbsr_gather under CBSR_GATHER_MODE), which expands each gathered
// CBSR row in the tile.
//
// What bounds it on the H100. The compulsory bytes (the CSR arrays, the
// table and out, once each: 253 MB at the SAGE cell, k = 32) take
// 0.075 ms at 3.35 TB/s. No formulation that keeps K2's per-column fmaf
// order comes near that: each kept entry of each edge is a read-modify-
// write of a shared-memory row at a column the data chooses, and every
// shared access and every global load's return share the SM's L1 data
// stage, one wavefront a clock. An access takes as many wavefronts as the
// most lanes on one bank (about 3.25 of 32 entries over 256 columns), so
// at k = 32 an edge costs ~6.5 wavefronts of scatter, and the whole edge
// ~8 (chip_smoke.py k5_wavefronts counts them from the data): ~0.4 ms on
// 132 SMs at 1.98 GHz. That wavefront floor is what the design works
// against (PERF.md).
//
// Design:
// - With bfloat16 values a pack pass (spgemm_cbsr_pack_kernel, in the
//   same call) writes one 4-byte record per kept entry, bf16 bits << 16 |
//   selector, so an edge reads one record row (128 bytes at k = 32)
//   instead of a values row and a selector row. __uint_as_float(rec &
//   0xffff0000) is the bf16 value in float32, so the products are those
//   of the two arrays. float32 values keep the two arrays: 8-byte records
//   were slower on the card.
// - Lanes matched to k: a warp runs P = 32 / L segments at once, L lanes
//   each (L = 8 at k <= 8, 16 at k <= 16, else 32; lane l takes the
//   entries l, l + L, ... < k: C = ceil(k / L) of them). The segments step
//   in lockstep: one scatter access carries one edge of each, so at
//   k = 16 a conflict-bound access serves two edges.
// - Each segment still applies its own edges one by one, in CSR order:
//   row[sel] = fmaf(w, v, row[sel]), and __syncwarp() before the next
//   step. Selectors are distinct within a table row, so one edge's lanes
//   never write one column twice, and every column's sum is taken in edge
//   order: K2's sum on the expanded operand, fmaf for fmaf, bit for bit
//   (K2's extra terms are fmaf(w, 0, acc), which change nothing but the
//   sign of a zero sum). No atomics.
// - The work list (SegmentPlan.work: segments longest first, each with
//   its first edge, its length and its destination) in items of P
//   segments, one item a warp, two warps a block. The P segments of an
//   item have nearly equal lengths, so few lanes idle, and the blocks
//   start longest first. A segment needs no plan look-up before its first
//   edges (no seg_row -> indptr -> edges chain). Persistent warps walking
//   the list, with the next item's first chunk in flight, were slower at
//   k = 32 on the card (PERF.md).
// - Each segment's next 32 (column, value) pairs are loaded into
//   registers while this chunk applies, and stored to the warp's staging
//   buffer after it (cp.async into a double buffer, and no prefetch, were
//   slower on the card). A step reads the staged pairs as 16-byte words:
//   one read of columns and one of values serve 4 edges of each segment
//   (the P segments' words fall on different banks).
// - The records go from global memory to registers (kStep edges' loads
//   issued together, then applied), not through shared memory: a staged
//   ring would add its fill and re-read to the L1 data stage.
// - A segment of a row of one segment writes out directly; a split row's
//   segment writes its partials row, summed in segment order by the
//   finish pass K2 uses (segment_plan.cuh), launched here as
//   spgemm_cbsr_finish_kernel.
// Dispatch (by k alone): L = 8, C = 1 at k <= 8; L = 16, C = 1 at k <= 16;
// L = 32 and C = 1, 2, 3, 4 up to k = 32, 64, 96, 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_plan.cuh"

namespace {

using segplan::Plan;

constexpr int kWarpsPerBlock = 2;
constexpr int kMaxD = 256;     // uint8 selectors
constexpr int kStep = 4;       // edges of a segment whose loads fly together
constexpr int kChunk = 32;     // edges of a segment staged at once
// Staged words a segment and array: a chunk, padded so that the P
// segments' 16-byte reads at one step fall on different banks.
constexpr int kPad = kChunk + 4;

// The table as the kernel reads it: Raw is what a lane loads for one kept
// entry, value() and sel() take it apart.
// bfloat16 values: the pack pass's records, bf16 bits << 16 | selector.
struct Bf16Records {
  using Raw = uint32_t;
  const uint32_t* __restrict__ rec;
  __device__ __forceinline__ Raw load(size_t at) const {
    return __ldg(rec + at);
  }
  __device__ __forceinline__ static float value(Raw r) {
    return __uint_as_float(r & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t sel(Raw r) { return r & 0xffu; }
};

// float32 values: the values and selectors as they are (8-byte records
// were slower on the card, PERF.md).
struct F32Arrays {
  struct Raw {
    float v;
    uint32_t s;
  };
  const float* __restrict__ values;
  const uint8_t* __restrict__ selector;
  __device__ __forceinline__ Raw load(size_t at) const {
    return Raw{__ldg(values + at), __ldg(selector + at)};
  }
  __device__ __forceinline__ static float value(Raw r) { return r.v; }
  __device__ __forceinline__ static uint32_t sel(Raw r) { return r.s; }
};

__global__ void spgemm_cbsr_pack_kernel(const uint16_t* __restrict__ values,
                                        const uint8_t* __restrict__ selector,
                                        uint32_t* __restrict__ rec,
                                        int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    rec[i] = (uint32_t)values[i] << 16 | selector[i];
}

// One segment of the work list: its first edge, its edges (0: none) and
// its destination (>= 0: an out row; < 0: partials row -1 - dst).
struct Seg {
  int64_t start;
  int n;
  int dst;
};

__device__ __forceinline__ Seg load_seg(const int4* __restrict__ work,
                                        int64_t s, int64_t n_seg) {
  if (s >= n_seg) return Seg{0, 0, 0};
  const int4 w = __ldg(work + s);
  return Seg{(int64_t)(uint32_t)w.x | (int64_t)w.y << 32, w.w, w.z};
}

// Edges base + sl + L * q (q < P) of the segment, those it has, into
// registers: their columns and value bits.
template <int L>
__device__ __forceinline__ void load_chunk(int (&col)[32 / L],
                                           int (&wt)[32 / L], const Seg& seg,
                                           int base,
                                           const int32_t* __restrict__ indices,
                                           const float* __restrict__ vals,
                                           int sl) {
#pragma unroll
  for (int q = 0; q < 32 / L; ++q) {
    const int i = base + sl + L * q;
    if (i < seg.n) {
      col[q] = __ldg(indices + seg.start + i);
      wt[q] = __float_as_int(__ldg(vals + seg.start + i));
    }
  }
}

template <typename Table, int L, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spgemm_cbsr_kernel(const int32_t* __restrict__ indices,
                   const float* __restrict__ vals, const Table table,
                   const int4* __restrict__ work, int64_t n_seg,
                   float* __restrict__ out, float* __restrict__ partials,
                   int k, int d) {
  using Raw = typename Table::Raw;
  constexpr int P = 32 / L;          // segments a warp runs at once
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / L;          // the lane's segment of the item
  const int sl = lane % L;           // the lane within it
  const int dpad = (d + 3) & ~3;
  // A warp's shared memory: P rows of dpad floats, then the staged chunk
  // of each segment: [columns, values][segment][kPad].
  int* mine = smem + warp * P * (dpad + 2 * kPad);
  float* row = reinterpret_cast<float*>(mine) + sub * dpad;
  int* cols = mine + P * dpad + sub * kPad;
  int* wts = mine + P * dpad + (P + sub) * kPad;

  const int64_t item = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (item >= (n_seg + P - 1) / P) return;   // whole warps exit together
  for (int f = sl; f < d; f += L) row[f] = 0.0f;

  const Seg seg = load_seg(work, item * P + sub, n_seg);
  int col[P], wt[P];                 // the next chunk, in flight
  load_chunk<L>(col, wt, seg, 0, indices, vals, sl);
  // Longest first: the item's first segment is its longest.
  const int steps = __shfl_sync(0xffffffffu, seg.n, 0);
  for (int base = 0; base < steps; base += kChunk) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      cols[sl + L * q] = col[q];
      wts[sl + L * q] = wt[q];
    }
    __syncwarp();
    // The segment's next chunk arrives while this one applies.
    if (base + kChunk < steps)
      load_chunk<L>(col, wt, seg, base + kChunk, indices, vals, sl);
    const int left = seg.n - base;     // this segment's edges from base
    const int m = steps - base < kChunk ? steps - base : kChunk;
    for (int i = 0; i < m; i += kStep) {
      const int4 c4 = *reinterpret_cast<const int4*>(cols + i);
      const int4 w4 = *reinterpret_cast<const int4*>(wts + i);
      const int cg[kStep] = {c4.x, c4.y, c4.z, c4.w};
      const int wg[kStep] = {w4.x, w4.y, w4.z, w4.w};
      Raw r[kStep][C];
#pragma unroll
      for (int g = 0; g < kStep; ++g) {
        const size_t at = (size_t)(uint32_t)cg[g] * (uint32_t)k + sl;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (i + g < left && sl + L * c < k) r[g][c] = table.load(at + L * c);
      }
#pragma unroll
      for (int g = 0; g < kStep; ++g) {
        const float w = __int_as_float(wg[g]);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (i + g < left && sl + L * c < k) {
            float* p = row + Table::sel(r[g][c]);
            *p = fmaf(w, Table::value(r[g][c]), *p);
          }
        }
        __syncwarp();
      }
    }
  }

  // The segment's row to its destination (the last item of the list may
  // have fewer than P segments).
  if (seg.n > 0) {
    float* dst = seg.dst >= 0 ? out + (int64_t)seg.dst * d
                              : partials + (int64_t)(-1 - seg.dst) * d;
    if (d % 4 == 0) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (int f = sl; f < d / 4; f += L) dst4[f] = row4[f];
    } else {
      for (int f = sl; f < d; f += L) dst[f] = row[f];
    }
  }
}

// The finish pass (segment_plan.cuh) under this kernel's name.
template <int VEC>
__global__ void __launch_bounds__(segplan::kFinishThreads)
spgemm_cbsr_finish_kernel(const float* __restrict__ partials,
                          float* __restrict__ out, const Plan plan, int d) {
  segplan::finish_rows<VEC>(partials, out, plan, d);
}

cudaError_t launch_pack(const void* values, const void* selector, int64_t n,
                        void* records, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  spgemm_cbsr_pack_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192),
                            kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(values),
      static_cast<const uint8_t*>(selector), static_cast<uint32_t*>(records),
      n);
  return cudaGetLastError();
}

template <typename Table, int L, int C>
cudaError_t launch(const void* indices, const void* vals, const Table& table,
                   const void* work, int64_t n_seg, void* out,
                   void* partials, const Plan& plan, int k, int d,
                   cudaStream_t stream) {
  auto op = static_cast<float*>(out);
  auto pp = static_cast<float*>(partials);
  if (n_seg > 0) {
    constexpr int P = 32 / L;
    const int dpad = (d + 3) & ~3;
    // At most 10.5 KB a block (P = 4, d = 256): no opt-in needed.
    const size_t smem =
        (size_t)kWarpsPerBlock * P * (dpad + 2 * kPad) * sizeof(int);
    const int64_t items = (n_seg + P - 1) / P;
    const unsigned blocks =
        (unsigned)((items + kWarpsPerBlock - 1) / kWarpsPerBlock);
    spgemm_cbsr_kernel<Table, L, C><<<blocks, kWarpsPerBlock * 32, smem,
                                      stream>>>(
        static_cast<const int32_t*>(indices), static_cast<const float*>(vals),
        table, static_cast<const int4*>(work), n_seg, op, pp, k, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return segplan::launch_finish(spgemm_cbsr_finish_kernel<4>,
                                spgemm_cbsr_finish_kernel<1>, pp, op, plan,
                                d, stream);
}

template <typename Table>
int dispatch(const void* indices, const void* vals, const Table& table,
             const void* work, int64_t n_seg, void* out, void* partials,
             const void* fin_row, const void* fin_ptr, int64_t n_fin, int k,
             int d, cudaStream_t s) {
  if (k < 1 || k > 4 * 32 || d < 1 || d > kMaxD) return cudaErrorInvalidValue;
  // The finish pass reads only the finish list from the plan.
  const Plan plan = segplan::make_plan(nullptr, nullptr, nullptr, n_seg, 0,
                                       fin_row, fin_ptr, n_fin);
  if (k <= 8)
    return launch<Table, 8, 1>(indices, vals, table, work, n_seg, out,
                               partials, plan, k, d, s);
  if (k <= 16)
    return launch<Table, 16, 1>(indices, vals, table, work, n_seg, out,
                                partials, plan, k, d, s);
  switch ((k + 31) / 32) {
    case 1:
      return launch<Table, 32, 1>(indices, vals, table, work, n_seg, out,
                                  partials, plan, k, d, s);
    case 2:
      return launch<Table, 32, 2>(indices, vals, table, work, n_seg, out,
                                  partials, plan, k, d, s);
    case 3:
      return launch<Table, 32, 3>(indices, vals, table, work, n_seg, out,
                                  partials, plan, k, d, s);
    default:
      return launch<Table, 32, 4>(indices, vals, table, work, n_seg, out,
                                  partials, plan, k, d, s);
  }
}

}  // namespace

// Each returns the launches' cudaError_t (0 on success). The caller checks
// shapes, types and contiguity, guarantees 1 <= k <= 128, d <= 256 and
// 0 <= selector < d, distinct within a row, and allocates out (n_rows, d)
// and partials (n_partials, d) as float32; with bfloat16 values also
// records (n_cols * k uint32), which the pack pass fills first. work is
// the plan's (n_seg, 2) int64 work list (ops/graph.py SegmentPlan.work).
extern "C" int spgemm_cbsr_bf16(const void* indices, const void* vals,
                                const void* values, const void* selector,
                                int64_t n_cols, void* records,
                                const void* work, int64_t n_seg, void* out,
                                void* partials, const void* fin_row,
                                const void* fin_ptr, int64_t n_fin, int k,
                                int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_pack(values, selector, n_cols * k, records, s);
  if (err != cudaSuccess) return err;
  return dispatch(indices, vals,
                  Bf16Records{static_cast<const uint32_t*>(records)}, work,
                  n_seg, out, partials, fin_row, fin_ptr, n_fin, k, d, s);
}

extern "C" int spgemm_cbsr_f32(const void* indices, const void* vals,
                               const void* values, const void* selector,
                               int64_t n_cols, void* records,
                               const void* work, int64_t n_seg, void* out,
                               void* partials, const void* fin_row,
                               const void* fin_ptr, int64_t n_fin, int k,
                               int d, void* stream) {
  (void)n_cols;
  (void)records;
  return dispatch(indices, vals,
                  F32Arrays{static_cast<const float*>(values),
                            static_cast<const uint8_t*>(selector)},
                  work, n_seg, out, partials, fin_row, fin_ptr, n_fin, k, d,
                  static_cast<cudaStream_t>(stream));
}

// The pack pass alone (n = n_cols * k entries), for its check against
// the plain version.
extern "C" int spgemm_cbsr_pack_bf16(const void* values, const void* selector,
                                     int64_t n, void* records, void* stream) {
  return launch_pack(values, selector, n, records,
                     static_cast<cudaStream_t>(stream));
}
