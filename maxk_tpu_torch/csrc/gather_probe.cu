// Gather-rate probe for the H100 roofline model (bench/roofline.py).
//
// A measurement tool, not a port of a TPU kernel and on no path of the
// port: it reads what K2 (spmm_csr.cu) gathers, the way K2 gathers it,
// and does nothing else, so that E*D*2 bytes over its time is the rate at
// which the card can pull bfloat16 rows of x by column index. They come
// mostly from L2: at V = 131072 a pass's 128 columns of x are 32 MiB,
// which the 50 MB L2 holds, and each row is read E/V ~ 100 times. Against
// K2 it leaves out the edge values, the FMAs, the output and the split
// rows' second pass.
//
// As K2 at bfloat16 with 4-element vectors: a warp walks kSegLen = 256
// consecutive edges of cols (K2's segment length); the grid's y dimension
// takes passes of 128 columns (8 bytes a lane); each lane issues
// kInFlight loads, of kInFlight edges, through the read-only path before
// it folds them into a register with XOR. Each warp writes its fold, 8
// bytes a lane, to out[warp, pass] so that no load is dead code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSegLen = 256;
constexpr int kSlab = 128;        // bfloat16 columns a pass covers

template <int kInFlight>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_probe_kernel(const uint16_t* __restrict__ x,
                    const int32_t* __restrict__ cols, int64_t n_edges, int d,
                    uint2* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t w =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t e0 = w * kSegLen;
  if (e0 >= n_edges) return;
  const int n = n_edges - e0 < kSegLen ? (int)(n_edges - e0) : kSegLen;
  const int f = blockIdx.y * kSlab + lane * 4;
  uint2 acc = make_uint2(0u, 0u);
  for (int base = 0; base < n; base += 32) {
    const int m = n - base < 32 ? n - base : 32;
    const int32_t col_l = lane < m ? cols[e0 + base + lane] : 0;
    for (int i = 0; i < m; i += kInFlight) {
      uint2 raw[kInFlight];
#pragma unroll
      for (int g = 0; g < kInFlight; ++g) {
        const int32_t col = __shfl_sync(0xffffffffu, col_l, (i + g) & 31);
        raw[g] = make_uint2(0u, 0u);
        if (i + g < m && f < d)
          raw[g] = __ldg(reinterpret_cast<const uint2*>(
              x + (int64_t)col * d + f));
      }
#pragma unroll
      for (int g = 0; g < kInFlight; ++g) {
        acc.x ^= raw[g].x;
        acc.y ^= raw[g].y;
      }
    }
  }
  out[(w * gridDim.y + blockIdx.y) * 32 + lane] = acc;
}

template <int kInFlight>
int launch(const void* x, const void* cols, int64_t n_edges, int d,
           void* out, void* stream) {
  const int64_t n_warps = (n_edges + kSegLen - 1) / kSegLen;
  const dim3 grid((unsigned)((n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((d + kSlab - 1) / kSlab));
  gather_probe_kernel<kInFlight>
      <<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint16_t*>(x), static_cast<const int32_t*>(cols),
          n_edges, d, static_cast<uint2*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). The caller passes a
// contiguous bfloat16 x (n_rows, d) with d % 4 == 0 and an 8-byte-aligned
// base, int32 cols in [0, n_rows), and out as (ceil(n_edges / 256),
// ceil(d / 128), 32) uint2 (8 bytes each); in_flight is 4 (K2's) or 8.
extern "C" int gather_probe_bf16(const void* x, const void* cols,
                                 int64_t n_edges, int d, int in_flight,
                                 void* out, void* stream) {
  if (n_edges <= 0) return 0;
  if (in_flight == 4) return launch<4>(x, cols, n_edges, d, out, stream);
  if (in_flight == 8) return launch<8>(x, cols, n_edges, d, out, stream);
  return (int)cudaErrorInvalidValue;
}
