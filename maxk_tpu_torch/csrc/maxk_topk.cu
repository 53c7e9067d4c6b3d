// K1: exact per-row MaxK on Hopper (sm_90a).
//
// Replaces the TPU kernel maxk_tpu/ops/pallas_topk.py::_maxk_kernel
// (wrapper maxk_pallas). Per row of a (V, D) float32 matrix it finds the
// exact k-th largest value and writes y = x * mask and a 0/1 uint8 mask;
// ties at the threshold are kept first-column-first.
//
// What bounds it on the H100: the integer pipe, on the threshold descent,
// with the byte floor under it. Each element is read once (4 B) and
// written twice (4 B of y, 1 B of mask): at (131072, 256) that is 302 MB,
// 0.090 ms at 3.35 TB/s. A descent step at D = 256 (8 keys a lane) is 36
// SASS instructions (cuobjdump, k1_ab.py): 3 a key (compare, add,
// predicated move), the warp sum, the compare and select of t, the exit
// test and the loop; about 22 of them on the integer ALU pipe, which
// takes 2 clocks a warp instruction in each of an SM's 4 partitions. So
// 32 steps for each of 131072 rows take ~0.18 ms on 132 SMs at ~1.98 GHz:
// twice the byte floor, and about the 0.19 ms a full descent measured.
//
// So the descent stops early. Once cnt_t = count(key >= t) == k, the k
// keys >= t are exactly the row's top k; every later step would only
// lower t towards the least of them, which keeps the same set. The keep
// set is {key >= t}, bit for bit the full descent's (`need` below is then
// the number of ties, and all are kept). The exit comes at the highest bit
// where the k-th and (k+1)-th largest keys differ:
//   steps = 32 - floor(log2(key_k ^ key_k+1)),
// 32 when they are equal, 0 when k = D. On the main path (k = 32, D =
// 256) rows run 13-15 steps on average (PERF.md), which puts the
// descent's ALU work under the byte floor; the two then overlap only in
// part. Rows whose k-th and (k+1)-th keys tie still run 32 steps.
//
// Design: one warp per row, the row held in registers for the whole
// search, so device memory is touched once per element.
//   * Lane l holds columns l + 32*j (j < VPL): every load and store of a
//     warp covers 32 neighbouring elements, i.e. is coalesced.
//   * Key: the order-preserving map of IEEE-754 float32 onto uint32
//     (negative: ~bits, else bits | 0x80000000). -0.0 orders below +0.0,
//     exactly as the TPU kernel's _sortable_key.
//   * Descent: MSB-first steps towards the largest t with
//     count(key >= t) >= k, i.e. the k-th largest key, left at the first
//     step whose count is exactly k. Each step counts per lane and sums
//     the warp with __reduce_add_sync.
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

  // MSB-first descent towards the largest t with count(key >= t) >= k,
  // left as soon as cnt_t = count(key >= t) == k (see the header). cnt_t
  // starts at the row's d valid columns, so k = d runs no step; after
  // that it is the `cnt` of the last step that took its candidate, and
  // only such a step can make it k: cnt == k implies the select took
  // cand. So the exit is one compare and one branch after the select.
  // (Nesting the test inside the taken branch made ptxas spill at
  // VPL = 16.) `cnt` is the warp's sum, the same in every
  // lane: the break is warp-uniform. Invalid slots never count: every
  // candidate has at least one bit set and their key is forced 0.
#pragma unroll
  for (int j = 0; j < VPL; ++j) key[j] = valid[j] ? key[j] : 0u;
  uint32_t t = 0;
  if (k != d) {
#pragma unroll 1
    for (int bit = 31; bit >= 0; --bit) {
      const uint32_t cand = t | (1u << bit);
      unsigned cnt = 0;
#pragma unroll
      for (int j = 0; j < VPL; ++j) cnt += key[j] >= cand;
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      t = cnt >= (unsigned)k ? cand : t;
      if (cnt == (unsigned)k) break;
    }
  }

  unsigned n_gt = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) n_gt += valid[j] && key[j] > t;
  n_gt = __reduce_add_sync(0xffffffffu, n_gt);
  // Tied elements to keep: >= 1 after a full descent; after an early
  // exit all of them (possibly none: t may lie below every kept key).
  const int need = k - (int)n_gt;

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
