// K4: exact per-row TopK -> CBSR on Hopper (sm_90a).
//
// Replaces the TPU kernels maxk_tpu/ops/pallas_topk.py::_cbsr_kernel and
// ::_cbsr_half_kernel (wrapper cbsr_topk_pallas). Per row of a (V, D)
// float32 matrix it keeps the same k entries as K1 (csrc/maxk_topk.cu):
// the exact k-th largest value, ties at the threshold kept
// first-column-first. It writes them compacted: (V, k) float32 values and
// (V, k) int32 column selectors, ascending per row. The TPU's split into
// two calls for k > 32 works around its compiler and has no counterpart
// here: one kernel takes any k.
//
// What bounds it on the H100: instruction issue, mostly on the integer
// pipe, not bytes. Each element is read once (4 B) and each kept entry
// written once (4 B of value, 4 B of selector): at (131072, 256), k = 32,
// that is 168 MB, 0.050 ms at 3.35 TB/s. In SASS at D = 256 (8 keys a
// lane; k4_ab.py counts them) a row takes ~112 instructions to load and
// key, 36 a descent step (3 a key: compare, add, predicated move; the
// warp sum, the select of t, the exit test, the loop) and ~290 to rank
// the ties and compact after a full descent. 32 steps make ~1550 a row:
// 0.19 ms for 131072 rows at one warp instruction a clock in each of the
// 528 schedulers (132 SMs at ~1.98 GHz), four times the byte floor.
//
// So the descent stops early, as K1's does. Once cnt_t = count(key >= t)
// == k, the k keys >= t are exactly the row's top k; every later step
// would only lower t towards the least of them, which keeps the same set.
// The exit comes at the highest bit where the k-th and (k+1)-th largest
// keys differ:
//   steps = 32 - floor(log2(key_k ^ key_k+1)),
// 32 when they are equal, 0 when k = D. And a row that left early (or ran
// no step) keeps exactly {key >= t}: it compacts with one ballot a j slot
// and no tie ranks (~170 instructions). On the CBSR route's inputs (k =
// 32, D = 256) rows run 13-15 steps on average, ~800 instructions a row,
// ~0.10 ms at full issue (PERF.md has the times). Rows whose k-th and
// (k+1)-th keys tie still run 32 steps and rank their ties.
//
// Design: K1's, one warp per row with the row in registers, so device
// memory is touched once per element. The key, the descent and the tie
// ranks are K1's, repeated here so that K1's code stays as it was built:
//   * Lane l holds columns l + 32*j (j < VPL), so the order of (j, lane)
//     is column order and every load is coalesced.
//   * Key: the order-preserving map of IEEE-754 float32 onto uint32;
//     -0.0 orders below +0.0, exactly as the TPU kernel's _sortable_key.
//   * Descent: MSB-first steps towards the largest t with
//     count(key >= t) >= k, left at the first step whose count is exactly
//     k, summing each step's counts with __reduce_add_sync.
//   * Ties, after a full descent only: `need` = k - count(key > t) of the
//     keys equal to t are kept, ranked in column order by ballots and
//     popcounts.
//   * Compaction: a kept element's slot is the number of kept elements in
//     earlier j plus popc(ballot_j(keep) & lanemask_lt). The selectors come
//     out ascending with no sort, and each j's stores fill one contiguous
//     run of the row's output.
// Any 1 <= k <= D and any D <= 32 * 32 = 1024 (VPL is a template, the
// smallest power of two >= ceil(D / 32)). Wider rows go to topk_wide.cu
// (ops/cuda_topk.py chooses).

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
cbsr_topk_kernel(const float* __restrict__ x, float* __restrict__ values,
                 int32_t* __restrict__ selector, int64_t n_rows, int d,
                 int k) {
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
    // Slots past d never count: every candidate has a bit set.
    key[j] = valid[j] ? sortable_key(v[j]) : 0u;
  }

  // MSB-first descent towards the largest t with count(key >= t) >= k,
  // left as soon as cnt_t = count(key >= t) == k (see the header). cnt_t
  // starts at the row's d valid columns, so k = d runs no step; after
  // that it is the `cnt` of the last step that took its candidate, and
  // only such a step can make it k: cnt == k implies the select took
  // cand. So the exit is one compare and one branch after the select, not
  // a test nested in the taken branch (which made ptxas spill in K1).
  // `cnt` is the warp's sum, the same in every lane: the break is
  // warp-uniform.
  uint32_t t = 0;
  int bit = 31;
  if (k != d) {
#pragma unroll 1
    for (; bit >= 0; --bit) {
      const uint32_t cand = t | (1u << bit);
      unsigned cnt = 0;
#pragma unroll
      for (int j = 0; j < VPL; ++j) cnt += key[j] >= cand;
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      t = cnt >= (unsigned)k ? cand : t;
      if (cnt == (unsigned)k) break;
    }
  }

  const unsigned lt_mask = (1u << lane) - 1u;
  int kept_before = 0;               // kept entries in earlier j slots
  float* vr = values + row * k;
  int32_t* sr = selector + row * k;
  if (bit >= 0) {
    // The descent left at cnt_t == k, or ran no step (k = d): the keep
    // set is exactly {key >= t}, so there are no ties to rank and no
    // count of key > t to take. One ballot a j slot. (`bit` is the same
    // in every lane, so is the branch.)
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const bool keep = valid[j] && key[j] >= t;
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int slot = kept_before + __popc(kept & lt_mask);
        vr[slot] = v[j];
        sr[slot] = lane + 32 * j;
      }
      kept_before += __popc(kept);
    }
    return;
  }

  // A full descent: t is the k-th largest key, and `need` >= 1 of the
  // keys equal to t are kept, in column order.
  unsigned n_gt = 0;
#pragma unroll
  for (int j = 0; j < VPL; ++j) n_gt += valid[j] && key[j] > t;
  n_gt = __reduce_add_sync(0xffffffffu, n_gt);
  const int need = k - (int)n_gt;
  int ties_before = 0;               // ties in earlier j slots
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const bool tie = valid[j] && key[j] == t;
    const unsigned ties = __ballot_sync(0xffffffffu, tie);
    const int rank = ties_before + __popc(ties & lt_mask);
    ties_before += __popc(ties);
    const bool keep = valid[j] && (key[j] > t || (tie && rank < need));
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      const int slot = kept_before + __popc(kept & lt_mask);
      vr[slot] = v[j];
      sr[slot] = lane + 32 * j;
    }
    kept_before += __popc(kept);
  }
}

template <int VPL>
cudaError_t launch(const float* x, float* values, int32_t* selector,
                   int64_t n_rows, int d, int k, cudaStream_t stream) {
  const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cbsr_topk_kernel<VPL><<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                          stream>>>(x, values, selector, n_rows, d, k);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaError_t (0 on success). The caller checks
// shapes: 1 <= k <= d <= 1024 (topk_wide.cu takes wider rows),
// n_rows >= 1, contiguous float32 x.
extern "C" int cbsr_topk_f32(const void* x, void* values, void* selector,
                             int64_t n_rows, int d, int k, void* stream) {
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(values);
  int32_t* sp = static_cast<int32_t*>(selector);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vpl = (d + 31) / 32;
  if (vpl <= 1) return launch<1>(xp, vp, sp, n_rows, d, k, s);
  if (vpl <= 2) return launch<2>(xp, vp, sp, n_rows, d, k, s);
  if (vpl <= 4) return launch<4>(xp, vp, sp, n_rows, d, k, s);
  if (vpl <= 8) return launch<8>(xp, vp, sp, n_rows, d, k, s);
  if (vpl <= 16) return launch<16>(xp, vp, sp, n_rows, d, k, s);
  if (vpl <= 32) return launch<32>(xp, vp, sp, n_rows, d, k, s);
  return (int)cudaErrorInvalidValue;
}
