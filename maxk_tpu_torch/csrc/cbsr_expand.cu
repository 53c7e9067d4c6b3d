// K6: cbsr_expand on Hopper (sm_90a): CBSR rows back to a dense matrix.
//
// Replaces the TPU kernel tools/probe_expand.py::expand_kernel (the JAX
// package computes the same function as the XLA compare-select chain
// maxk_tpu/ops/cbsr.py::cbsr_expand):
//   out[i, c] = values[i, l] where selector[i, l] == c, else 0
// for (V, k) values (float32 or bfloat16) and selectors (int32 or uint8)
// into a (V, D) float32 or bfloat16 out. A selector outside [0, D) is
// dropped (the JAX chain's compare never meets it); selectors must be
// distinct within a row (top-k's are).
//
// The int8 row-scale mode writes the table of the JAX package's
// "int8_rowscale" mode (maxk_tpu/ops/spgemm.py::_rowscale_int8_table,
// without its lane packing): scale (V,) float32 and q (V, D) int8 with
//   scale[i] = max_l |values[i, l]| / 127 + 1e-30
//   q[i, c]  = clamp(rint(out[i, c] / scale[i]), -127, 127)
// The scale is computed as XLA computes that expression, which rewrites a
// division by a constant into a product by its float32 reciprocal and fuses
// the add: fmaf(max, 1/127, 1e-30f). The quotient is an IEEE division
// (__fdiv_rn) and rint rounds half to even, as jnp.round does. So q and
// scale are bit-equal to the JAX package's on finite values.
//
// What bounds it on the H100: bytes. A row reads k values and k selectors
// and writes D output elements; at V = 131072, D = 256, k = 32, float32,
// that is 33.6 MB in and 134.2 MB out, 0.050 ms at 3.35 TB/s.
//
// Design: one warp a row, each output byte written once, zeros included
// (never a zero fill and then a scatter into device memory, which writes
// the row twice). Per pass of up to kTileBytes of the row:
// - the warp zeroes its tile in shared memory (16-byte stores);
// - each lane writes its pairs (l = lane, lane + 32, ...) whose selector
//   falls in the pass into the tile, converted to the output type;
// - the warp copies the tile to the row with 16-byte stores where the
//   row's bytes are a multiple of 16 and the output is 16-byte aligned
//   (the wrapper says so), and one element a lane otherwise.
// D <= kTileBytes / element size (1024 float32 columns) is one pass; a
// wider row takes more, each pass reading the row's pairs again (from L1).
// The int8 mode first takes the row's max |value| over all k pairs (a warp
// reduction that keeps NaN, as jnp.max does), then quantizes the pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTileBytes = 4096;   // a warp's row tile in shared memory

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O>
struct Convert;

template <>
struct Convert<float> {
  __device__ __forceinline__ static float of(float v) { return v; }
  __device__ __forceinline__ static float of(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

template <>
struct Convert<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 of(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static __nv_bfloat16 of(__nv_bfloat16 v) {
    return v;
  }
};

// max that keeps a NaN, as jnp.max does.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// The row scale of the int8 mode: fmaf(max |v|, 1/127, 1e-30f).
__device__ __forceinline__ float row_scale(float amax) {
  return fmaf(amax, 1.0f / 127.0f, 1e-30f);
}

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  const float t = rintf(__fdiv_rn(v, scale));
  return (int8_t)fminf(fmaxf(t, -127.0f), 127.0f);
}

// One warp a row (the design above). OUT is the output element type: float,
// __nv_bfloat16, or int8_t for the row-scale mode, which also writes scale.
template <typename VT, typename ST, typename OUT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cbsr_expand_kernel(const VT* __restrict__ values,
                   const ST* __restrict__ selector, OUT* __restrict__ out,
                   float* __restrict__ scale, int64_t v, int k, int d,
                   bool vec) {
  constexpr bool kInt8 = sizeof(OUT) == 1;
  constexpr int kTileCols = kTileBytes / (int)sizeof(OUT);
  __shared__ __align__(16) unsigned char tiles[kWarpsPerBlock][kTileBytes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= v) return;   // whole warps exit together
  const VT* vr = values + row * k;
  const ST* sr = selector + row * k;
  OUT* tile = reinterpret_cast<OUT*>(tiles[warp]);
  uint4* tile16 = reinterpret_cast<uint4*>(tiles[warp]);

  float inv = 0.0f;   // the int8 mode's scale
  if constexpr (kInt8) {
    float amax = 0.0f;
    for (int l = lane; l < k; l += 32)
      amax = max_nan(amax, fabsf(to_float(vr[l])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    inv = row_scale(amax);
    if (lane == 0) scale[row] = inv;
  }

  OUT* orow = out + row * d;
  for (int c0 = 0; c0 < d; c0 += kTileCols) {
    const int cols = d - c0 < kTileCols ? d - c0 : kTileCols;
    const int nbytes = cols * (int)sizeof(OUT);
    const int n16 = (nbytes + 15) / 16;
    for (int j = lane; j < n16; j += 32) tile16[j] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    for (int l = lane; l < k; l += 32) {
      const int64_t c = (int64_t)sr[l] - c0;
      if (c >= 0 && c < cols) {
        if constexpr (kInt8)
          tile[c] = quantize(to_float(vr[l]), inv);
        else
          tile[c] = Convert<OUT>::of(vr[l]);
      }
    }
    __syncwarp();
    if (vec) {
      uint4* dst = reinterpret_cast<uint4*>(orow + c0);
      for (int j = lane; j < n16; j += 32) dst[j] = tile16[j];
    } else {
      for (int j = lane; j < cols; j += 32) orow[c0 + j] = tile[j];
    }
    __syncwarp();   // the tile is read before the next pass zeroes it
  }
}

template <typename VT, typename ST, typename OUT>
int launch(const void* values, const void* selector, void* out, void* scale,
           int64_t v, int k, int d, bool vec, void* stream) {
  const unsigned blocks =
      (unsigned)((v + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cbsr_expand_kernel<VT, ST, OUT>
      <<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const VT*>(values), static_cast<const ST*>(selector),
          static_cast<OUT*>(out), static_cast<float*>(scale), v, k, d, vec);
  return cudaGetLastError();
}

template <typename VT, typename OUT>
int by_selector(const void* values, int sel_u8, const void* selector,
                void* out, void* scale, int64_t v, int k, int d, bool vec,
                void* stream) {
  return sel_u8 ? launch<VT, uint8_t, OUT>(values, selector, out, scale, v,
                                           k, d, vec, stream)
                : launch<VT, int32_t, OUT>(values, selector, out, scale, v,
                                           k, d, vec, stream);
}

template <typename OUT>
int by_value(const void* values, int val_bf16, const void* selector,
             int sel_u8, void* out, void* scale, int64_t v, int k, int d,
             bool vec, void* stream) {
  return val_bf16
             ? by_selector<__nv_bfloat16, OUT>(values, sel_u8, selector, out,
                                               scale, v, k, d, vec, stream)
             : by_selector<float, OUT>(values, sel_u8, selector, out, scale,
                                       v, k, d, vec, stream);
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). The caller checks
// shapes, types and contiguity, allocates the outputs, and passes
// val_bf16 (values bfloat16, else float32), sel_u8 (selectors uint8, else
// int32) and vec = 1 when d * the output's element size is a multiple of 16
// and the output is 16-byte aligned. v, k, d >= 1.
extern "C" int cbsr_expand(const void* values, int val_bf16,
                           const void* selector, int sel_u8, void* out,
                           int out_bf16, int64_t v, int k, int d, int vec,
                           void* stream) {
  return out_bf16 ? by_value<__nv_bfloat16>(values, val_bf16, selector,
                                            sel_u8, out, nullptr, v, k, d,
                                            vec != 0, stream)
                  : by_value<float>(values, val_bf16, selector, sel_u8, out,
                                    nullptr, v, k, d, vec != 0, stream);
}

// The int8 row-scale mode: q (v, d) int8 and scale (v,) float32.
extern "C" int cbsr_expand_int8(const void* values, int val_bf16,
                                const void* selector, int sel_u8, void* q,
                                void* scale, int64_t v, int k, int d,
                                int vec, void* stream) {
  return by_value<int8_t>(values, val_bf16, selector, sel_u8, q, scale, v,
                          k, d, vec != 0, stream);
}
