// K1 and K4 for rows of any width, on Hopper (sm_90a).
//
// maxk_topk.cu (K1) and cbsr_topk.cu (K4) hold a row in registers, 32
// values a lane, so they take D <= 1024. This kernel computes the same two
// functions for any D, bit for bit, and ops/cuda_topk.py sends it every
// row wider than 1024 columns. Like them it replaces the TPU kernels
// maxk_tpu/ops/pallas_topk.py::_maxk_kernel (entry maxk_wide_f32: y =
// x * mask and a 0/1 uint8 mask) and ::_cbsr_kernel / ::_cbsr_half_kernel
// (entry cbsr_topk_wide_f32: (V, k) float32 values and int32 selectors,
// ascending per row). The two entries share their device code with each
// other and with nothing else.
//
// The function, as in the register kernels:
//   * Key: the order-preserving map of IEEE-754 float32 onto uint32
//     (negative: ~bits, else bits | 0x80000000); -0.0 orders below +0.0.
//   * Descent: MSB-first towards the largest t with count(key >= t) >= k,
//     left at the first step whose count is exactly k. The count of the
//     last step that took its candidate starts at D, so k = D runs no step.
//   * Ties: need = k - count(key > t) of the keys equal to t are kept, in
//     column order (all of them after an early exit, possibly none).
//
// Design: a simple one that is right; its time is recorded, not targeted.
// One warp per row, lane l reading columns l + 32*j for every j, so every
// load and store of a warp is coalesced. The row is not held: each
// descent step reads it again (through L1 and L2) and recomputes the
// keys, one more pass counts key > t, and a last pass in column order
// ranks the ties and writes the output with ballots and popcounts, as the
// register kernels do for their j slots. Row offsets are 64-bit. So a row
// is read (steps + 2) times; the bytes that must move are one read of x
// and one write of the output.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t sortable_key(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The row's threshold t and the number of keys equal to t that are kept.
__device__ __forceinline__ void threshold(const float* __restrict__ xr,
                                          int d, int k, int lane,
                                          uint32_t* t_out, int* need_out) {
  uint32_t t = 0;
  if (k != d) {
#pragma unroll 1
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t cand = t | (1u << bit);
      unsigned cnt = 0;
#pragma unroll 4
      for (int c = lane; c < d; c += 32)
        cnt += sortable_key(__ldg(xr + c)) >= cand;
      cnt = __reduce_add_sync(0xffffffffu, cnt);   // the same in every lane
      t = cnt >= (unsigned)k ? cand : t;
      if (cnt == (unsigned)k) break;
    }
  }
  unsigned n_gt = 0;
#pragma unroll 4
  for (int c = lane; c < d; c += 32) n_gt += sortable_key(__ldg(xr + c)) > t;
  n_gt = __reduce_add_sync(0xffffffffu, n_gt);
  *t_out = t;
  *need_out = k - (int)n_gt;
}

// Visits the row's columns in order, 32 at a time, with each one's value
// and whether it is kept; `emit(c, v, keep, kept_ballot)` runs in every
// lane (c >= d in the lanes past the row's end, where keep is false).
template <typename Emit>
__device__ __forceinline__ void keep_pass(const float* __restrict__ xr, int d,
                                          int lane, uint32_t t, int need,
                                          Emit emit) {
  const unsigned lt_mask = (1u << lane) - 1u;
  int ties_before = 0;
#pragma unroll 1
  for (int base = 0; base < d; base += 32) {
    const int c = base + lane;
    const bool valid = c < d;
    const float v = valid ? __ldg(xr + c) : 0.0f;
    const uint32_t key = valid ? sortable_key(v) : 0u;
    const bool tie = valid && key == t;
    const unsigned ties = __ballot_sync(0xffffffffu, tie);
    const int rank = ties_before + __popc(ties & lt_mask);
    ties_before += __popc(ties);
    const bool keep = valid && (key > t || (tie && rank < need));
    emit(c, v, keep, __ballot_sync(0xffffffffu, keep), lt_mask);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
maxk_wide_kernel(const float* __restrict__ x, float* __restrict__ y,
                 uint8_t* __restrict__ mask, int64_t n_rows, int d, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // whole warps exit together
  const float* xr = x + row * d;
  uint32_t t;
  int need;
  threshold(xr, d, k, lane, &t, &need);
  float* yr = y + row * d;
  uint8_t* mr = mask + row * d;
  keep_pass(xr, d, lane, t, need,
            [&](int c, float v, bool keep, unsigned, unsigned) {
              if (c < d) {
                // Dropped entries are +0.0, as in maxk_topk.cu.
                yr[c] = keep ? v : 0.0f;
                mr[c] = keep ? 1 : 0;
              }
            });
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cbsr_topk_wide_kernel(const float* __restrict__ x, float* __restrict__ values,
                      int32_t* __restrict__ selector, int64_t n_rows, int d,
                      int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // whole warps exit together
  const float* xr = x + row * d;
  uint32_t t;
  int need;
  threshold(xr, d, k, lane, &t, &need);
  float* vr = values + row * k;
  int32_t* sr = selector + row * k;
  int kept_before = 0;         // kept entries in earlier columns
  keep_pass(xr, d, lane, t, need,
            [&](int c, float v, bool keep, unsigned kept, unsigned lt) {
              if (keep) {
                const int slot = kept_before + __popc(kept & lt);
                vr[slot] = v;
                sr[slot] = c;
              }
              kept_before += __popc(kept);
            });
}

int blocks_for(int64_t n_rows) {
  return (int)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). The caller checks
// shapes: 1 <= k <= d, n_rows >= 1, contiguous float32 x.
extern "C" int maxk_wide_f32(const void* x, void* y, void* mask,
                             int64_t n_rows, int d, int k, void* stream) {
  maxk_wide_kernel<<<blocks_for(n_rows), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<uint8_t*>(mask), n_rows, d, k);
  return (int)cudaGetLastError();
}

extern "C" int cbsr_topk_wide_f32(const void* x, void* values,
                                  void* selector, int64_t n_rows, int d,
                                  int k, void* stream) {
  cbsr_topk_wide_kernel<<<blocks_for(n_rows), kWarpsPerBlock * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(values),
      static_cast<int32_t*>(selector), n_rows, d, k);
  return (int)cudaGetLastError();
}
