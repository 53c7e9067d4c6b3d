// K7: CSR SpMM over an int8 table on Hopper (sm_90a), float32 accumulation.
//
// Replaces no Pallas kernel: the JAX package computes the same function in
// the XLA scans of its two int8 modes, maxk_tpu/ops/spmm.py::_spmm_scan
// under compute_dtype "int8" (a per-column scale, _pack_x) and
// maxk_tpu/ops/spgemm.py::_rowscale_impl under "int8_rowscale" (a per-row
// scale, _rowscale_int8_table):
//   column scale: out[r, f] = scale[f] * sum_{e in row r} vals[e] * q[cols[e], f]
//   row scale:    out[r, f] = sum_{e in row r} (vals[e] * scale[cols[e]]) * q[cols[e], f]
// with A as CSR (int64 indptr, int32 indices, float32 values), q a
// row-major (n_cols, D) int8 table (D % 4 == 0), scale float32 (D,) or
// (n_cols,), out float32 (V, D).
//
// What bounds it on the H100: the instructions of each edge and value, not
// bytes. Read once, the compulsory bytes (q, the CSR arrays, out) and the
// f32 FMAs (2*E*D operations at 67 TFLOP/s) both take about 0.1 ms at the
// cell (V = 131,072, E = 13,107,200, D = 256), and the row gather, E*D
// bytes (one byte a column, half of K2's bf16 rows), comes mostly from L2.
// K7 runs at ~15 values a clock an SM at the cell and at the reddit shape,
// whose table does not fit the L2. K7 first converted each byte with the
// int-to-float instruction (I2F), which compute capability 9.0 issues at
// 16 a clock an SM; without it (below) the rate did not move: a byte
// permute, an add and the FMA a value, and each edge's shuffles, address
// and load, issue at about half the SM's rate (estimated from the SASS).
// A LOP3 and shift in place of the byte permute (more instructions) ran
// 5 % slower; 8 edges' gathers a lane in flight (more registers, fewer
// warps) 33 % slower (PERF.md).
//
// Design: K2's (spmm_csr.cu), with one byte a column.
// - The work items are K2's row segments of at most seg_len edges
//   (segment_plan.cuh), one warp a segment; a split row's segments write
//   float32 partials and the shared finish pass sums them in segment order.
//   No atomics: the result is bit-for-bit deterministic.
// - The warp loads 32 (col, val) pairs at a time, coalesced, and under the
//   row scale also scale[col] (one more 4-byte load an edge, where the JAX
//   package carries the scale as a lane of the table), and folds it into
//   the edge's weight: w = val * scale[col], one rounding. The pairs are
//   broadcast with __shfl_sync.
// - Each lane owns VEC consecutive columns: a warp covers a slab of 32*VEC
//   columns, 128 (VEC = 4, one 4-byte load an edge) or 256 (VEC = 8, one
//   8-byte load). Slabs wider than one run as passes over the table, as in
//   K2 (grid.y, dispatched x-fastest). Each column's sum is the same at
//   either slab, term for term, so the two give the same bits. The wrapper
//   chooses the slab (ops/cuda_spmm_int8.py, SLAB): a pass costs each edge
//   its CSR loads, shuffles, address and loop again, and a 4-byte load
//   brings half the bytes of an 8-byte one, so 128-column passes were 50 %
//   slower at the cell and 43 % at the reddit shape, where that slab of the
//   table fits the L2 and the whole table does not.
// - A lane issues the gathers of 32/VEC edges (32 bytes) before their FMAs,
//   through the read-only path (__ldg).
// - Each byte becomes float32 exactly without a conversion instruction: one
//   XOR a 4-byte word flips the bytes' sign bits (each byte then holds
//   q + 128), a byte permute sets one byte under the exponent of 2**23
//   (the float 2**23 + q + 128) and an add of -(2**23 + 128) leaves q, with
//   no rounding. So each term is the same fmaf(w, q, acc) as with the
//   conversion, and the sums keep their bits (k7_ab.py holds them to the
//   first build's).
// - Under the column scale each output column is multiplied by scale[f]
//   once, where the row is written: by the segment kernel for a row of one
//   segment, by the finish pass (SCALE) for a split row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_plan.cuh"

namespace {

using segplan::Plan;

constexpr int kWarpsPerBlock = 8;

// Byte i of u, which holds q + 128, as the float32 q: PRMT builds the float
// 2**23 + q + 128 (0x4B0000 and the byte), and the add is exact.
__device__ __forceinline__ float byte_value(uint32_t u, int i) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | i)) -
         8388736.0f;
}

template <int VEC>
struct GatherI8;

template <>
struct GatherI8<4> {
  using Raw = uint32_t;
  __device__ __forceinline__ static Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ static void fma(float w, Raw r, float* acc) {
    const uint32_t u = r ^ 0x80808080u;   // each byte q + 128
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i] = fmaf(w, byte_value(u, i), acc[i]);
  }
};

template <>
struct GatherI8<8> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw load(const int8_t* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ static void fma(float w, Raw r, float* acc) {
    GatherI8<4>::fma(w, r.x, acc);
    GatherI8<4>::fma(w, r.y, acc + 4);
  }
};

template <int VEC, bool ROW_SCALE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_int8_segment_kernel(const int64_t* __restrict__ indptr,
                         const int32_t* __restrict__ indices,
                         const float* __restrict__ vals,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ scale,
                         float* __restrict__ out,
                         float* __restrict__ partials, const Plan plan,
                         int d) {
  using G = GatherI8<VEC>;
  constexpr int kGroup = 32 / VEC;   // edges whose gathers go together
  const int lane = threadIdx.x & 31;
  const int64_t s =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= plan.n_seg) return;   // whole warps exit together
  // d is a multiple of VEC, so a lane's columns are all in or all out.
  const int f = blockIdx.y * (32 * VEC) + lane * VEC;
  const bool live = f < d;

  const int64_t row = plan.seg_row[s];
  const int64_t start = plan.seg_start[s];
  const int64_t left = indptr[row + 1] - start;
  const int n = left < plan.seg_len ? (int)left : plan.seg_len;

  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;

  for (int base = 0; base < n; base += 32) {
    const int m = n - base < 32 ? n - base : 32;
    const bool in = lane < m;
    const int32_t col_l = in ? indices[start + base + lane] : 0;
    float w_l = in ? vals[start + base + lane] : 0.0f;
    if (ROW_SCALE && in) w_l *= __ldg(scale + col_l);
    for (int i = 0; i < m; i += kGroup) {
      int32_t col[kGroup];
      float w[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        col[g] = __shfl_sync(0xffffffffu, col_l, (i + g) & 31);
        w[g] = __shfl_sync(0xffffffffu, w_l, (i + g) & 31);
      }
      typename G::Raw raw[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (i + g < m && live) raw[g] = G::load(q + (int64_t)col[g] * d + f);
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        if (i + g < m && live) G::fma(w[g], raw[g], acc);
    }
  }

  if (!live) return;
  const int32_t slot = plan.seg_slot[s];
  float* dst = slot < 0 ? out + row * d : partials + (int64_t)slot * d;
  if (!ROW_SCALE && slot < 0) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] *= __ldg(scale + f + c);
  }
#pragma unroll
  for (int c = 0; c < VEC; c += 4)
    *reinterpret_cast<float4*>(dst + f + c) =
        make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
}

// The finish pass (segment_plan.cuh) under this kernel's name: d % 4 == 0,
// so whole float4s; under the column scale each sum is scaled there.
template <bool SCALE>
__global__ void __launch_bounds__(segplan::kFinishThreads)
spmm_int8_finish_kernel(const float* __restrict__ partials,
                        float* __restrict__ out, const Plan plan, int d,
                        const float* __restrict__ col_scale) {
  segplan::finish_rows<4, SCALE>(partials, out, plan, d, col_scale);
}

template <int VEC, bool ROW_SCALE>
cudaError_t launch(const void* indptr, const void* indices, const void* vals,
                   const void* q, const void* scale, void* out,
                   void* partials, const Plan& plan, int d, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pp = static_cast<float*>(partials);
  auto op = static_cast<float*>(out);
  auto sc = static_cast<const float*>(scale);
  if (plan.n_seg > 0) {
    const dim3 grid(
        (unsigned)((plan.n_seg + kWarpsPerBlock - 1) / kWarpsPerBlock),
        (unsigned)((d + 32 * VEC - 1) / (32 * VEC)));
    spmm_int8_segment_kernel<VEC, ROW_SCALE>
        <<<grid, kWarpsPerBlock * 32, 0, s>>>(
            static_cast<const int64_t*>(indptr),
            static_cast<const int32_t*>(indices),
            static_cast<const float*>(vals), static_cast<const int8_t*>(q),
            sc, op, pp, plan, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (plan.n_fin > 0)
    spmm_int8_finish_kernel<!ROW_SCALE>
        <<<(unsigned)plan.n_fin, segplan::kFinishThreads, 0, s>>>(pp, op,
                                                                 plan, d, sc);
  return cudaGetLastError();
}

}  // namespace

// Returns the launches' cudaError_t (0 on success). The caller checks
// shapes, types, alignment and contiguity (d % 4 == 0, q 4-byte aligned,
// and for slab 256 d % 8 == 0 and q 8-byte aligned), allocates out
// (n_rows, d) and partials (n_partials, d) as float32, and passes
// row_scale = 1 for a (n_cols,) per-row scale, 0 for a (d,) per-column one,
// and slab = 128 or 256 columns a warp pass.
extern "C" int spmm_int8(const void* indptr, const void* indices,
                         const void* vals, const void* q, const void* scale,
                         void* out, void* partials, const void* seg_row,
                         const void* seg_start, const void* seg_slot,
                         int64_t n_seg, int seg_len, const void* fin_row,
                         const void* fin_ptr, int64_t n_fin, int d,
                         int row_scale, int slab, void* stream) {
  const Plan plan = segplan::make_plan(seg_row, seg_start, seg_slot, n_seg,
                                       seg_len, fin_row, fin_ptr, n_fin);
  if (d % 4 != 0) return cudaErrorInvalidValue;
  if (slab == 128)
    return row_scale
               ? launch<4, true>(indptr, indices, vals, q, scale, out,
                                 partials, plan, d, stream)
               : launch<4, false>(indptr, indices, vals, q, scale, out,
                                  partials, plan, d, stream);
  if (slab == 256 && d % 8 == 0)
    return row_scale
               ? launch<8, true>(indptr, indices, vals, q, scale, out,
                                 partials, plan, d, stream)
               : launch<8, false>(indptr, indices, vals, q, scale, out,
                                  partials, plan, d, stream);
  return cudaErrorInvalidValue;
}
