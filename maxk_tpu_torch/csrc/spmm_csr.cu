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
// traffic is larger: each edge re-reads a row of x, and only the part of
// x that stays in the 50 MB L2 is read at L2 speed.
//
// Design: no edge tiles. One warp per output row walks the row's CSR
// range. Each lane owns VEC consecutive columns per chunk (VEC*4 or
// VEC*2 bytes = one 16-byte load), and CHUNKS chunks of 32*VEC columns
// span the row slab; a slab wider than D is masked, a D wider than the
// slab is covered by more slabs (grid.y). The warp loads 32 (col, val)
// pairs at a time, coalesced, and broadcasts them with __shfl_sync, so
// every neighbour row of x is read as full 16-byte vectors. float32
// accumulators stay in registers and are written once. No atomics: a
// row's edges are summed in CSR order by one warp, so the result is
// deterministic. Zero-degree rows write zeros.
//
// Known cost: a hub row with many edges is serialised on one warp. The
// warp4 row split (the reference's <= 64 edges per warp) is the remedy
// and is queued in ROADMAP.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  }
};

template <>
struct Loader<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    o[0] = *p;
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A bf16's float32 bit pattern is its 16 bits in the top half.
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Loader<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    o[0] = __bfloat162float(*p);
  }
};

template <typename T, int VEC, int CHUNKS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int64_t* __restrict__ indptr,
                const int32_t* __restrict__ indices,
                const float* __restrict__ vals, const T* __restrict__ x,
                float* __restrict__ out, int64_t n_rows, int d) {
  constexpr int kSlab = 32 * VEC * CHUNKS;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // whole warps exit together
  const int slab = blockIdx.y * kSlab;

  float acc[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[c][i] = 0.0f;

  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  for (int64_t base = start; base < end; base += 32) {
    const int64_t e = base + lane;
    const bool in = e < end;
    const int32_t col_l = in ? indices[e] : 0;
    const float val_l = in ? vals[e] : 0.0f;
    const int n = end - base < 32 ? (int)(end - base) : 32;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int32_t col = __shfl_sync(0xffffffffu, col_l, i);
      const float val = __shfl_sync(0xffffffffu, val_l, i);
      const T* xr = x + (int64_t)col * d;
#pragma unroll
      for (int c = 0; c < CHUNKS; ++c) {
        const int f = slab + c * 32 * VEC + lane * VEC;
        if (f < d) {
          float xv[VEC];
          Loader<T, VEC>::load(xr + f, xv);
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[c][q] = fmaf(val, xv[q], acc[c][q]);
        }
      }
    }
  }

  float* orow = out + row * d;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int f = slab + c * 32 * VEC + lane * VEC;
    if (f < d) {
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < VEC; q += 4)
          *reinterpret_cast<float4*>(orow + f + q) = make_float4(
              acc[c][q], acc[c][q + 1], acc[c][q + 2], acc[c][q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) orow[f + q] = acc[c][q];
      }
    }
  }
}

template <typename T, int VEC, int CHUNKS>
cudaError_t launch(const int64_t* indptr, const int32_t* indices,
                   const float* vals, const T* x, float* out, int64_t n_rows,
                   int d, cudaStream_t stream) {
  constexpr int kSlab = 32 * VEC * CHUNKS;
  const dim3 grid((unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((d + kSlab - 1) / kSlab));
  spmm_csr_kernel<T, VEC, CHUNKS><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      indptr, indices, vals, x, out, n_rows, d);
  return cudaGetLastError();
}

// Smallest CHUNKS (1, 2, 4 or 8) whose slab covers d; wider d takes more
// slabs of 8 chunks.
template <typename T, int VEC>
cudaError_t dispatch(const int64_t* indptr, const int32_t* indices,
                     const float* vals, const T* x, float* out,
                     int64_t n_rows, int d, cudaStream_t s) {
  const int chunks = (d + 32 * VEC - 1) / (32 * VEC);
  if (chunks <= 1) return launch<T, VEC, 1>(indptr, indices, vals, x, out, n_rows, d, s);
  if (chunks <= 2) return launch<T, VEC, 2>(indptr, indices, vals, x, out, n_rows, d, s);
  if (chunks <= 4) return launch<T, VEC, 4>(indptr, indices, vals, x, out, n_rows, d, s);
  return launch<T, VEC, 8>(indptr, indices, vals, x, out, n_rows, d, s);
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). The caller checks
// shapes and contiguity, and passes vec=1 unless d is a multiple of the
// 16-byte vector (4 float32 / 8 bfloat16) and x is 16-byte aligned.
extern "C" int spmm_csr_f32(const void* indptr, const void* indices,
                            const void* vals, const void* x, void* out,
                            int64_t n_rows, int d, int vec, void* stream) {
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto vv = static_cast<const float*>(vals);
  auto xp = static_cast<const float*>(x);
  auto op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4) return dispatch<float, 4>(ip, ix, vv, xp, op, n_rows, d, s);
  return dispatch<float, 1>(ip, ix, vv, xp, op, n_rows, d, s);
}

extern "C" int spmm_csr_bf16(const void* indptr, const void* indices,
                             const void* vals, const void* x, void* out,
                             int64_t n_rows, int d, int vec, void* stream) {
  auto ip = static_cast<const int64_t*>(indptr);
  auto ix = static_cast<const int32_t*>(indices);
  auto vv = static_cast<const float*>(vals);
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    return dispatch<__nv_bfloat16, 8>(ip, ix, vv, xp, op, n_rows, d, s);
  return dispatch<__nv_bfloat16, 1>(ip, ix, vv, xp, op, n_rows, d, s);
}
