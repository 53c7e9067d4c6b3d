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
// that is 33.6 MB in and 134.2 MB out, 0.050 ms at 3.35 TB/s; the int8
// mode's 33.6 MB in and 34.1 MB out (q and the scales), 0.020 ms.
//
// Design of the float32 and bfloat16 outputs: one warp a row, each output
// byte written once, zeros included (never a zero fill and then a scatter
// into device memory, which writes the row twice). Per pass of up to
// kTileBytes of the row:
// - the warp zeroes its tile in shared memory (16-byte stores);
// - each lane writes its pairs (l = lane, lane + 32, ...) whose selector
//   falls in the pass into the tile, converted to the output type;
// - the warp copies the tile to the row with 16-byte stores where the
//   row's bytes are a multiple of 16 and the output is 16-byte aligned
//   (the wrapper says so), and one element a lane otherwise.
// D <= kTileBytes / element size (1024 float32 columns) is one pass; a
// wider row takes more, each pass reading the row's pairs again (from L1).
//
// Design of the int8 mode. A row of it is short (at D = 256, k = 32, 256
// bytes in and 256 out), and its steps depend on each other: the loads,
// the row's max, the quotients, the scatter, the stores. One warp a row
// that then exits (the first design) had 256 bytes of loads in flight a warp and half
// its lanes idle in the stores, and read at a fraction of the card's rate.
// So here:
// - L lanes take a row, L the least power of two with 4 L >= k (at most
//   32) whose R = 32 / L rows fit the warp's tile: lane j holds the row's
//   pairs 4j .. 4j + 3, loaded with one 16-byte load of values and one of
//   selectors where k % 4 == 0 (at k = 32 a group of 4 rows is 1 KB);
// - a warp walks kInt8GroupsPerWarp groups of R consecutive rows, and
//   loads the next group's pairs into registers before it quantizes and
//   stores the current one (4 groups a warp; 2, 8 and one wave of warps
//   walking the grid came within 10 % or were slower, PERF.md);
// - the row's max |value| is a reduction over its L lanes that keeps NaN,
//   as jnp.max does; the scale and the quotients are computed as the JAX
//   package computes them (above);
// - a group's q rows are one run of R * D bytes: the warp zeroes it in its
//   shared-memory tile, scatters the quotients, and copies it out with
//   16-byte stores from every lane (R = 1 past the tile: passes of
//   kInt8TileBytes, as above).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTileBytes = 4096;   // a warp's row tile in shared memory
// The int8 mode: a warp's tile in shared memory, and its groups of rows.
constexpr int kInt8TileBytes = 2048;
constexpr int kInt8GroupsPerWarp = 4;

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

// One warp a row (the design above). OUT is the output element type,
// float or __nv_bfloat16.
template <typename VT, typename ST, typename OUT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cbsr_expand_kernel(const VT* __restrict__ values,
                   const ST* __restrict__ selector, OUT* __restrict__ out,
                   int64_t v, int k, int d, bool vec) {
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

  OUT* orow = out + row * d;
  for (int c0 = 0; c0 < d; c0 += kTileCols) {
    const int cols = d - c0 < kTileCols ? d - c0 : kTileCols;
    const int nbytes = cols * (int)sizeof(OUT);
    const int n16 = (nbytes + 15) / 16;
    for (int j = lane; j < n16; j += 32) tile16[j] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    for (int l = lane; l < k; l += 32) {
      const int64_t c = (int64_t)sr[l] - c0;
      if (c >= 0 && c < cols) tile[c] = Convert<OUT>::of(vr[l]);
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

// Four consecutive pairs of a row, as float32 values and int selectors:
// one vector load each where `vec` (the wrapper's alignment, k % 4 == 0),
// else element loads; a pair at or past k is absent (value 0, selector -1).
template <typename T>
struct Quad;

template <>
struct Quad<float> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
};

template <>
struct Quad<__nv_bfloat16> {
  // A bfloat16 is the high half of its float32.
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = __uint_as_float(t.x << 16);
    o[1] = __uint_as_float(t.x & 0xFFFF0000u);
    o[2] = __uint_as_float(t.y << 16);
    o[3] = __uint_as_float(t.y & 0xFFFF0000u);
  }
};

template <>
struct Quad<int32_t> {
  __device__ __forceinline__ static void load(const int32_t* p, int* o) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
};

template <>
struct Quad<uint8_t> {
  __device__ __forceinline__ static void load(const uint8_t* p, int* o) {
    const uint32_t t = __ldg(reinterpret_cast<const unsigned int*>(p));
    o[0] = t & 0xFF; o[1] = (t >> 8) & 0xFF;
    o[2] = (t >> 16) & 0xFF; o[3] = t >> 24;
  }
};

// The pairs l = l0 .. l0 + 3 of a row (the row's first pair at p, s).
template <typename VT, typename ST>
__device__ __forceinline__ void load_pairs(const VT* p, const ST* s, int l0,
                                           int k, bool live, bool vec,
                                           float* val, int* sel) {
  if (live && vec && l0 < k) {   // k % 4 == 0: all four are in
    Quad<VT>::load(p + l0, val);
    Quad<ST>::load(s + l0, sel);
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool in = live && l0 + t < k;
    val[t] = in ? to_float(p[l0 + t]) : 0.0f;
    sel[t] = in ? (int)s[l0 + t] : -1;
  }
}

// The int8 mode (the design above): L = 1 << lane_shift lanes a row, groups
// of R = 32 / L rows, kInt8GroupsPerWarp groups a warp; lane j of a row
// holds its pairs 4j .. 4j + 3, and loads those of the next group while it
// works on this one. Pairs past 4L (k > 128) are read where they are used.
template <typename VT, typename ST>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cbsr_expand_int8_kernel(const VT* __restrict__ values,
                        const ST* __restrict__ selector,
                        int8_t* __restrict__ q, float* __restrict__ scale,
                        int64_t v, int k, int d, int lane_shift,
                        bool vec_pairs, bool vec_out) {
  __shared__ __align__(16) unsigned char tiles[kWarpsPerBlock]
                                              [kInt8TileBytes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lanes = 1 << lane_shift;
  const int rows = 32 >> lane_shift;
  const int sub = lane >> lane_shift;   // this lane's row in the group
  const int l0 = 4 * (lane & (lanes - 1));
  const int64_t n_groups = (v + rows - 1) / rows;
  const int64_t first =
      ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * kInt8GroupsPerWarp;
  if (first >= n_groups) return;   // whole warps exit together
  const int64_t last = first + kInt8GroupsPerWarp < n_groups
                           ? first + kInt8GroupsPerWarp
                           : n_groups;
  unsigned char* tile = tiles[warp];
  uint4* tile16 = reinterpret_cast<uint4*>(tiles[warp]);
  const int tile_cols = rows > 1 ? d : kInt8TileBytes;   // R d <= the tile
  const int rest = 4 * lanes;   // pairs held in registers a row

  float nv[4];
  int ns[4];
  {
    const int64_t row = first * rows + sub;
    load_pairs(values + row * k, selector + row * k, l0, k, row < v,
               vec_pairs, nv, ns);
  }
  for (int64_t group = first; group < last; ++group) {
    float cv[4];
    int cs[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      cv[t] = nv[t];
      cs[t] = ns[t];
    }
    if (group + 1 < last) {
      const int64_t row = (group + 1) * rows + sub;
      load_pairs(values + row * k, selector + row * k, l0, k, row < v,
                 vec_pairs, nv, ns);
    }

    const int64_t r0 = group * rows;
    const int64_t row = r0 + sub;
    const bool live = row < v;
    const VT* vr = values + row * k;
    const ST* sr = selector + row * k;
    float amax = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) amax = max_nan(amax, fabsf(cv[t]));
    if (live)
      for (int l = rest + (lane & (lanes - 1)); l < k; l += lanes)
        amax = max_nan(amax, fabsf(to_float(vr[l])));
    for (int off = lanes >> 1; off > 0; off >>= 1)
      amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = row_scale(amax);
    if (live && l0 == 0) scale[row] = s;

    const int n_rows = v - r0 < rows ? (int)(v - r0) : rows;
    for (int c0 = 0; c0 < d; c0 += tile_cols) {
      const int cols = d - c0 < tile_cols ? d - c0 : tile_cols;
      const int nbytes = n_rows * cols;
      const int n16 = (nbytes + 15) / 16;
      for (int b = lane; b < n16; b += 32) tile16[b] = make_uint4(0, 0, 0, 0);
      __syncwarp();
      unsigned char* trow = tile + sub * cols;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = cs[t] - c0;
        if (c >= 0 && c < cols) trow[c] = (unsigned char)quantize(cv[t], s);
      }
      if (live)
        for (int l = rest + (lane & (lanes - 1)); l < k; l += lanes) {
          const int64_t c = (int64_t)sr[l] - c0;
          if (c >= 0 && c < cols)
            trow[c] = (unsigned char)quantize(to_float(vr[l]), s);
        }
      __syncwarp();
      int8_t* dst = q + r0 * d + c0;   // R > 1: c0 = 0 and cols = d
      if (vec_out) {
        uint4* dst16 = reinterpret_cast<uint4*>(dst);
        for (int b = lane; b < n16; b += 32) dst16[b] = tile16[b];
      } else {
        for (int b = lane; b < nbytes; b += 32) dst[b] = (int8_t)tile[b];
      }
      __syncwarp();   // the tile is read before the next pass zeroes it
    }
  }
}

template <typename VT, typename ST, typename OUT>
int launch(const void* values, const void* selector, void* out, int64_t v,
           int k, int d, bool vec, void* stream) {
  const unsigned blocks =
      (unsigned)((v + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cbsr_expand_kernel<VT, ST, OUT>
      <<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const VT*>(values), static_cast<const ST*>(selector),
          static_cast<OUT*>(out), v, k, d, vec);
  return cudaGetLastError();
}

template <typename VT, typename ST>
int launch_int8(const void* values, const void* selector, void* q,
                void* scale, int64_t v, int k, int d, bool vec,
                void* stream) {
  // L: the least power of two with 4 L >= k whose R = 32 / L rows fit the
  // tile (R d <= kInt8TileBytes), at most 32.
  int lane_shift = 0;
  while (lane_shift < 5 && ((4 << lane_shift) < k ||
                            (int64_t)(32 >> lane_shift) * d > kInt8TileBytes))
    ++lane_shift;
  const bool vec_pairs =
      k % 4 == 0 && (uintptr_t)values % (4 * sizeof(VT)) == 0 &&
      (uintptr_t)selector % (4 * sizeof(ST)) == 0;
  const int64_t n_groups = (v + (32 >> lane_shift) - 1) >> (5 - lane_shift);
  const int64_t per_block = (int64_t)kWarpsPerBlock * kInt8GroupsPerWarp;
  const unsigned blocks = (unsigned)((n_groups + per_block - 1) / per_block);
  cbsr_expand_int8_kernel<VT, ST>
      <<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const VT*>(values), static_cast<const ST*>(selector),
          static_cast<int8_t*>(q), static_cast<float*>(scale), v, k, d,
          lane_shift, vec_pairs, vec);
  return cudaGetLastError();
}

template <typename VT, typename OUT>
int by_selector(const void* values, int sel_u8, const void* selector,
                void* out, int64_t v, int k, int d, bool vec, void* stream) {
  return sel_u8 ? launch<VT, uint8_t, OUT>(values, selector, out, v, k, d,
                                           vec, stream)
                : launch<VT, int32_t, OUT>(values, selector, out, v, k, d,
                                           vec, stream);
}

template <typename OUT>
int by_value(const void* values, int val_bf16, const void* selector,
             int sel_u8, void* out, int64_t v, int k, int d, bool vec,
             void* stream) {
  return val_bf16
             ? by_selector<__nv_bfloat16, OUT>(values, sel_u8, selector, out,
                                               v, k, d, vec, stream)
             : by_selector<float, OUT>(values, sel_u8, selector, out, v, k,
                                       d, vec, stream);
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
                                            sel_u8, out, v, k, d, vec != 0,
                                            stream)
                  : by_value<float>(values, val_bf16, selector, sel_u8, out,
                                    v, k, d, vec != 0, stream);
}

// The int8 row-scale mode: q (v, d) int8 and scale (v,) float32.
extern "C" int cbsr_expand_int8(const void* values, int val_bf16,
                                const void* selector, int sel_u8, void* q,
                                void* scale, int64_t v, int k, int d,
                                int vec, void* stream) {
  const bool vc = vec != 0;
  if (val_bf16)
    return sel_u8 ? launch_int8<__nv_bfloat16, uint8_t>(
                        values, selector, q, scale, v, k, d, vc, stream)
                  : launch_int8<__nv_bfloat16, int32_t>(
                        values, selector, q, scale, v, k, d, vc, stream);
  return sel_u8 ? launch_int8<float, uint8_t>(values, selector, q, scale, v,
                                              k, d, vc, stream)
                : launch_int8<float, int32_t>(values, selector, q, scale, v,
                                              k, d, vc, stream);
}
