// K1: exact per-row MaxK on Hopper (sm_90a).
//
// Replaces the TPU kernel maxk_tpu/ops/pallas_topk.py::_maxk_kernel
// (wrapper maxk_pallas). Per row of a (V, D) float32 matrix it finds the
// exact k-th largest value and writes y = x * mask and a 0/1 uint8 mask;
// ties at the threshold are kept first-column-first.
//
// What bounds it on the H100: bytes. Each element is read once (4 B) and
// written twice (4 B of y, 1 B of mask); the 32-step threshold descent is
// ~32 integer compares per element, well under the card's issue rate, so
// the kernel sits on the 3.35 TB/s memory roof when it is right.
//
// Design: one warp per row, the row held in registers for the whole
// search, so device memory is touched once per element.
//   * Lane l holds columns l + 32*j (j < VPL): every load and store of a
//     warp covers 32 neighbouring elements, i.e. is coalesced.
//   * Key: the order-preserving map of IEEE-754 float32 onto uint32
//     (negative: ~bits, else bits | 0x80000000). -0.0 orders below +0.0,
//     exactly as the TPU kernel's _sortable_key.
//   * Descent: 32 MSB-first steps find the largest t with
//     count(key >= t) >= k, i.e. the k-th largest key. Each step counts
//     per lane and sums the warp with __reduce_add_sync.
//   * Ties: `need` = k - count(key > t) of the tied elements are kept, in
//     column order. Column order across a warp is (j, lane), so an
//     element's rank among ties is popc of the ballots of earlier j plus
//     popc(ballot_j & lanemask_lt).
// Any 1 <= k <= D and any D <= 32 * 32 = 1024 (VPL is a template, the
// smallest power of two >= ceil(D / 32)). No uint8 quantisation of the
// values and no small-k special case.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t sortable_key(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
maxk_topk_kernel(const float* __restrict__ x, float* __restrict__ y,
                 uint8_t* __restrict__ mask, int64_t n_rows, int d, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // whole warps exit together
  const float* xr = x + row * d;

  float v[VPL];
  uint32_t key[VPL];
  bool valid[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = lane + 32 * j;
    valid[j] = c < d;
    v[j] = valid[j] ? xr[c] : 0.0f;
    key[j] = sortable_key(v[j]);
  }

  // Largest t with count(key >= t) >= k. Invalid slots never count:
  // every candidate has at least one bit set and their key is forced 0.
#pragma unroll
  for (int j = 0; j < VPL; ++j) key[j] = valid[j] ? key[j] : 0u;
  uint32_t t = 0;
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = t | (1u << bit);
    unsigned cnt = 0;
#pragma unroll
    for (int j = 0; j < VPL; ++j) cnt += key[j] >= cand;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (cnt >= (unsigned)k) t = cand;
  }

  unsigned n_gt = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) n_gt += valid[j] && key[j] > t;
  n_gt = __reduce_add_sync(0xffffffffu, n_gt);
  const int need = k - (int)n_gt;   // tied elements to keep, >= 1

  const unsigned lt_mask = (1u << lane) - 1u;
  int before = 0;                    // ties in earlier j slots
  float* yr = y + row * d;
  uint8_t* mr = mask + row * d;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool tie = valid[j] && key[j] == t;
    const unsigned ballot = __ballot_sync(0xffffffffu, tie);
    const int rank = before + __popc(ballot & lt_mask);
    before += __popc(ballot);
    const bool keep = valid[j] && (key[j] > t || (tie && rank < need));
    if (valid[j]) {
      const int c = lane + 32 * j;
      // Dropped entries are +0.0, as the TPU kernel's x * mask comes out
      // (XLA folds the multiply by a 0/1 mask into a select).
      yr[c] = keep ? v[j] : 0.0f;
      mr[c] = keep ? 1 : 0;
    }
  }
}

template <int VPL>
cudaError_t launch(const float* x, float* y, uint8_t* mask, int64_t n_rows,
                   int d, int k, cudaStream_t stream) {
  const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  maxk_topk_kernel<VPL><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                          stream>>>(x, y, mask, n_rows, d, k);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). The caller checks
// shapes: 1 <= k <= d <= 1024, n_rows >= 1, contiguous float32 x.
extern "C" int maxk_topk_f32(const void* x, void* y, void* mask,
                             int64_t n_rows, int d, int k, void* stream) {
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  uint8_t* mp = static_cast<uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpl = (d + 31) / 32;
  if (vpl <= 1) return launch<1>(xp, yp, mp, n_rows, d, k, s);
  if (vpl <= 2) return launch<2>(xp, yp, mp, n_rows, d, k, s);
  if (vpl <= 4) return launch<4>(xp, yp, mp, n_rows, d, k, s);
  if (vpl <= 8) return launch<8>(xp, yp, mp, n_rows, d, k, s);
  if (vpl <= 16) return launch<16>(xp, yp, mp, n_rows, d, k, s);
  if (vpl <= 32) return launch<32>(xp, yp, mp, n_rows, d, k, s);
  return (int)cudaErrorInvalidValue;
}
