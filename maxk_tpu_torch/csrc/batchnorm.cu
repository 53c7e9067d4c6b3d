// GNN_res's BatchNorm on Hopper (sm_90a): the passes over a (V, D)
// float32 activation, fused.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses its elementwise work into few passes. Unfused in stock torch ops it
// made 24 passes over the activation a layer an epoch (the training
// forward 5 reads and 3 writes, its backward 7 and 3, the evaluation 3 and
// 3). Here:
//   bn_sums   two column sums in one read: sum(a) and sum(a * a) over the
//             first `rows` rows (the training forward, a = x), or sum(a)
//             and sum(a * xhat) over every row with xhat = (x - mean) *
//             rstd recomputed in registers (the backward, a = dy);
//   bn_affine y = (x - shift) * scale + bias a column: one read, one write
//             (the training forward with the batch's statistics, the
//             evaluation with the running ones);
//   bn_dx     dx = fma(xhat, c_dyx, fma(dy, scale, c_dy)) on the rows
//             below n_valid and dy * scale past them: reads dy and x,
//             writes dx.
// Ten passes a layer an epoch: training forward 3, backward 5, evaluation
// 2. The D-wide vectors (statistics, scales, corrections) are computed by
// the wrapper between launches (ops/cuda_batchnorm.py).
//
// What bounds it on the H100: bytes. One pass over the products shape's
// (2,449,029, 256) float32 activation moves 2.508 GB, 0.749 ms at
// 3.35 TB/s; each element costs one to four operations.
//
// Design. A block of kThreads threads owns a slab of consecutive rows and a
// tile of column units, a unit being 4 columns read with one 16-byte load
// where D % 4 == 0 and every (V, D) base is 16-byte aligned (`vec`), else
// one column. The launchers below choose that plan (plan_of): at most one
// wave of kBlocksPerSm blocks on each of the device's SMs along the rows
// (396 slabs on the H100's 132), which bn_max_slabs reports so that the
// wrapper sizes bn_sums' scratch. Units per tile: min(units, kThreads);
// the kThreads / tile row groups of the block each walk every groups-th
// row of the slab, so a warp reads 32 consecutive units of a row, and each
// thread keeps its columns' vectors in registers for the whole slab. A
// thread starts the loads of kUnroll rows before it uses them, which keeps
// enough bytes in flight to stream at HBM's rate: at the products shape
// the passes read and write at 86-95 % of 3.35 TB/s (PERF.md).
//
// The sums: each thread accumulates its columns in float32 over its rows
// (some 1,500 at the products shape), compensated (Kahan) so that the
// error does not grow with that count; the block adds its row groups in
// shared memory in group order into one partial row of a (slabs, 2, D)
// scratch, and bn_sums_finish_kernel adds the slabs' partials a column in
// float64, in a fixed order. A sum so lies within (groups + 6) roundings
// of the terms' magnitudes of the exact one, closer than torch's own
// column sums. No atomics: a launch repeats bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// Blocks an SM, as __launch_bounds__ promises: at most 85 registers a
// thread, which the backward's sums need to hold 4 rows of dy and x with
// no spill (at 4 an SM, 64 registers, they spilled and ran 11 % slower;
// 2 and 4 with kUnroll 2 or 8 timed alike, PERF.md).
constexpr int kBlocksPerSm = 3;
// bn_sums_finish_kernel's block: 32 columns by 32 slab strides.
constexpr int kFinishCols = 32;
constexpr int kFinishRows = 32;

// What a launch walks, and how a block's threads split it.
struct Layout {
  int64_t rows;   // rows walked: [0, rows)
  int64_t slab;   // rows a block (blockIdx.x)
  int d;          // columns
  int units;      // column units: d / W
  int tile;       // units a block (blockIdx.y): min(units, kThreads)
  int groups;     // row groups a block: kThreads / tile
};

// A launch's layout, its grid and its unit width (4 where vec, else 1).
struct Plan {
  Layout l;
  dim3 grid;
  bool vec;
};

// Blocks along the rows at most: one wave on each SM of `device`; 0 if
// the device cannot be asked.
int max_slabs_of(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return kBlocksPerSm * sms;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The plan for `rows` rows (>= 1) of d columns on the current device: as
// many slabs as keep every row group kUnroll rows busy, at most
// max_slabs_of, none empty (the last may be short).
Plan plan_of(int64_t rows, int d, bool vec) {
  int device = 0;
  cudaGetDevice(&device);
  const int cap = max_slabs_of(device);
  Plan p;
  p.vec = vec;
  Layout& l = p.l;
  l.rows = rows;
  l.d = d;
  l.units = vec ? d / 4 : d;
  l.tile = l.units < kThreads ? l.units : kThreads;
  l.groups = kThreads / l.tile;
  const int64_t per_block = (int64_t)l.groups * kUnroll;
  int64_t slabs = (rows + per_block - 1) / per_block;
  if (slabs > cap) slabs = cap;
  if (slabs < 1) slabs = 1;
  l.slab = (rows + slabs - 1) / slabs;
  slabs = (rows + l.slab - 1) / l.slab;
  p.grid = dim3((unsigned)slabs, (l.units + l.tile - 1) / l.tile);
  return p;
}

// W consecutive floats of a row: one 16-byte load or store at W = 4.
template <int W>
struct Unit {
  float v[W];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (W == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      v[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *p = v[0];
    }
  }
};

// A thread's place: its row group, its first column, and whether it has
// a unit at all (the last tile may be short; groups * tile may fall short
// of kThreads).
struct Place {
  int group;
  int col;
  bool active;
  int64_t r0, r1;   // the block's slab, cut at rows
};

template <int W>
__device__ __forceinline__ Place place(const Layout& l) {
  Place p;
  p.group = threadIdx.x / l.tile;
  const int unit = blockIdx.y * l.tile + threadIdx.x % l.tile;
  p.col = unit * W;
  p.active = p.group < l.groups && unit < l.units;
  p.r0 = (int64_t)blockIdx.x * l.slab;
  p.r1 = p.r0 + l.slab < l.rows ? p.r0 + l.slab : l.rows;
  return p;
}

template <int W>
__device__ __forceinline__ void load_cols(const float* __restrict__ src,
                                          int col, float* dst) {
#pragma unroll
  for (int w = 0; w < W; ++w) dst[w] = __ldg(src + col + w);
}

// s + t by Kahan's compensated summation: the running sum is s - c, to
// within about two roundings of the terms' magnitudes however many terms
// a thread adds (plain float32 adds lose one rounding a term).
__device__ __forceinline__ void add_compensated(float& s, float& c,
                                                float t) {
  const float y = t - c;
  const float u = s + y;
  c = (u - s) - y;
  s = u;
}

// Two column sums over the block's slab into partials[blockIdx.x]: the
// forward form sum(a), sum(a * a); the backward form (x given) sum(a),
// sum(a * xhat).
template <int W, bool kBackward>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_sums_kernel(const float* __restrict__ a, const float* __restrict__ x,
               const float* __restrict__ mean,
               const float* __restrict__ rstd,
               float* __restrict__ partials, Layout l) {
  __shared__ float red[2][kThreads * W];
  const Place p = place<W>(l);
  float s1[W], s2[W], c1[W], c2[W];
#pragma unroll
  for (int w = 0; w < W; ++w) s1[w] = s2[w] = c1[w] = c2[w] = 0.0f;
  if (p.active) {
    float m[W], rs[W];
    if constexpr (kBackward) {
      load_cols<W>(mean, p.col, m);
      load_cols<W>(rstd, p.col, rs);
    }
    const int64_t step = (int64_t)kUnroll * l.groups;
    for (int64_t r = p.r0 + p.group; r < p.r1; r += step) {
      Unit<W> av[kUnroll], xv[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int64_t rj = r + (int64_t)j * l.groups;
        if (rj < p.r1) {
          av[j].load(a + rj * l.d + p.col);
          if constexpr (kBackward) xv[j].load(x + rj * l.d + p.col);
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (r + (int64_t)j * l.groups < p.r1) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const float v = av[j].v[w];
            add_compensated(s1[w], c1[w], v);
            if constexpr (kBackward) {
              const float xh = (xv[j].v[w] - m[w]) * rs[w];
              add_compensated(s2[w], c2[w], v * xh);
            } else {
              add_compensated(s2[w], c2[w], v * v);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    s1[w] -= c1[w];
    s2[w] -= c2[w];
    red[0][threadIdx.x * W + w] = s1[w];
    red[1][threadIdx.x * W + w] = s2[w];
  }
  __syncthreads();
  if (!p.active || p.group != 0) return;
  // Row group 0 adds the others in group order.
  for (int g = 1; g < l.groups; ++g) {
    const int t = g * l.tile + threadIdx.x;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      s1[w] += red[0][t * W + w];
      s2[w] += red[1][t * W + w];
    }
  }
  float* out = partials + (int64_t)blockIdx.x * 2 * l.d + p.col;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    out[w] = s1[w];
    out[l.d + w] = s2[w];
  }
}

// out[k] = sum over the slabs of partials[b, k], k < n = 2 D, in float64:
// thread (c, y) adds slabs y, y + kFinishRows, ... of column c, then row
// 0 adds the kFinishRows sums in order.
__global__ void __launch_bounds__(kFinishCols * kFinishRows)
bn_sums_finish_kernel(const float* __restrict__ partials,
                      float* __restrict__ out, int slabs, int n) {
  __shared__ double red[kFinishRows][kFinishCols];
  const int k = blockIdx.x * kFinishCols + threadIdx.x;
  double s = 0.0;
  if (k < n) {
#pragma unroll 4
    for (int b = threadIdx.y; b < slabs; b += kFinishRows)
      s += (double)__ldg(partials + (int64_t)b * n + k);
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || k >= n) return;
  for (int y = 1; y < kFinishRows; ++y) s += red[y][threadIdx.x];
  out[k] = (float)s;
}

// y = (x - shift) * scale + bias, a column's shift, scale and bias.
template <int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_affine_kernel(const float* __restrict__ x,
                 const float* __restrict__ shift,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ y,
                 Layout l) {
  const Place p = place<W>(l);
  if (!p.active) return;
  float sh[W], sc[W], bi[W];
  load_cols<W>(shift, p.col, sh);
  load_cols<W>(scale, p.col, sc);
  load_cols<W>(bias, p.col, bi);
  const int64_t step = (int64_t)kUnroll * l.groups;
  for (int64_t r = p.r0 + p.group; r < p.r1; r += step) {
    Unit<W> v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t rj = r + (int64_t)j * l.groups;
      if (rj < p.r1) v[j].load(x + rj * l.d + p.col);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t rj = r + (int64_t)j * l.groups;
      if (rj < p.r1) {
#pragma unroll
        for (int w = 0; w < W; ++w)
          v[j].v[w] = fmaf(v[j].v[w] - sh[w], sc[w], bi[w]);
        v[j].store(y + rj * l.d + p.col);
      }
    }
  }
}

// dx = fma(xhat, c_dyx, fma(dy, scale, c_dy)) with xhat = (x - mean) *
// rstd on the rows below n_valid, dy * scale past them (x is not read
// there).
template <int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
bn_dx_kernel(const float* __restrict__ dy, const float* __restrict__ x,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ scale,
             const float* __restrict__ c_dy,
             const float* __restrict__ c_dyx, float* __restrict__ dx,
             int64_t n_valid, Layout l) {
  const Place p = place<W>(l);
  if (!p.active) return;
  float m[W], rs[W], sc[W], c1[W], c2[W];
  load_cols<W>(mean, p.col, m);
  load_cols<W>(rstd, p.col, rs);
  load_cols<W>(scale, p.col, sc);
  load_cols<W>(c_dy, p.col, c1);
  load_cols<W>(c_dyx, p.col, c2);
  const int64_t step = (int64_t)kUnroll * l.groups;
  for (int64_t r = p.r0 + p.group; r < p.r1; r += step) {
    Unit<W> g[kUnroll], xv[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t rj = r + (int64_t)j * l.groups;
      if (rj < p.r1) {
        g[j].load(dy + rj * l.d + p.col);
        if (rj < n_valid) xv[j].load(x + rj * l.d + p.col);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t rj = r + (int64_t)j * l.groups;
      if (rj >= p.r1) continue;
      if (rj < n_valid) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float xh = (xv[j].v[w] - m[w]) * rs[w];
          g[j].v[w] = fmaf(xh, c2[w], fmaf(g[j].v[w], sc[w], c1[w]));
        }
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) g[j].v[w] *= sc[w];
      }
      g[j].store(dx + rj * l.d + p.col);
    }
  }
}

template <int W>
void launch_sums(const Plan& p, const float* a, const float* x,
                 const float* mean, const float* rstd, float* partials,
                 cudaStream_t stream) {
  if (x != nullptr)
    bn_sums_kernel<W, true><<<p.grid, kThreads, 0, stream>>>(
        a, x, mean, rstd, partials, p.l);
  else
    bn_sums_kernel<W, false><<<p.grid, kThreads, 0, stream>>>(
        a, x, mean, rstd, partials, p.l);
}

}  // namespace

// The most slabs a launch on `device` splits its rows into: bn_sums'
// scratch holds that many partial rows.
extern "C" int bn_max_slabs(int device) { return max_slabs_of(device); }

// The two column sums into out (2, d): over the first `rows` rows of a
// (forward form, x null) or over every row with xhat from x, mean and
// rstd (backward form). partials is (bn_max_slabs, 2, d) scratch.
extern "C" int bn_sums(const void* a, const void* x, const void* mean,
                       const void* rstd, void* partials, void* out,
                       int64_t rows, int d, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(rows, d, d % 4 == 0 && aligned16(a) && aligned16(x));
  const auto* af = static_cast<const float*>(a);
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(mean);
  const auto* rf = static_cast<const float*>(rstd);
  auto* pf = static_cast<float*>(partials);
  if (p.vec)
    launch_sums<4>(p, af, xf, mf, rf, pf, s);
  else
    launch_sums<1>(p, af, xf, mf, rf, pf, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = 2 * d;
  bn_sums_finish_kernel<<<(n + kFinishCols - 1) / kFinishCols,
                          dim3(kFinishCols, kFinishRows), 0, s>>>(
      pf, static_cast<float*>(out), (int)p.grid.x, n);
  return cudaGetLastError();
}

extern "C" int bn_affine(const void* x, const void* shift, const void* scale,
                         const void* bias, void* y, int64_t rows, int d,
                         void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(rows, d, d % 4 == 0 && aligned16(x) && aligned16(y));
  const auto* xf = static_cast<const float*>(x);
  const auto* sh = static_cast<const float*>(shift);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  if (p.vec)
    bn_affine_kernel<4><<<p.grid, kThreads, 0, s>>>(xf, sh, sc, bi, yf, p.l);
  else
    bn_affine_kernel<1><<<p.grid, kThreads, 0, s>>>(xf, sh, sc, bi, yf, p.l);
  return cudaGetLastError();
}

extern "C" int bn_dx(const void* dy, const void* x, const void* mean,
                     const void* rstd, const void* scale, const void* c_dy,
                     const void* c_dyx, void* dx, int64_t n_valid,
                     int64_t rows, int d, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(rows, d, d % 4 == 0 && aligned16(dy)
                                      && aligned16(x) && aligned16(dx));
  const auto* g = static_cast<const float*>(dy);
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(mean);
  const auto* rf = static_cast<const float*>(rstd);
  const auto* sc = static_cast<const float*>(scale);
  const auto* c1 = static_cast<const float*>(c_dy);
  const auto* c2 = static_cast<const float*>(c_dyx);
  auto* out = static_cast<float*>(dx);
  if (p.vec)
    bn_dx_kernel<4><<<p.grid, kThreads, 0, s>>>(g, xf, mf, rf, sc, c1, c2,
                                                out, n_valid, p.l);
  else
    bn_dx_kernel<1><<<p.grid, kThreads, 0, s>>>(g, xf, mf, rf, sc, c1, c2,
                                                out, n_valid, p.l);
  return cudaGetLastError();
}
