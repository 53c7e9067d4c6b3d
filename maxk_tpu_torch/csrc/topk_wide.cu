// K1 and K4 for rows of any width, on Hopper (sm_90a).
//
// maxk_topk.cu (K1) and cbsr_topk.cu (K4) hold a row in registers, 32
// values a lane, so they take D <= 1024. This kernel computes the same two
// functions for any D, bit for bit, and ops/cuda_topk.py sends it every
// row wider than 1024 columns. Like them it replaces the TPU kernels
// maxk_tpu/ops/pallas_topk.py:95 _maxk_kernel (entry maxk_wide_f32: y =
// x * mask and a 0/1 uint8 mask) and :102 _cbsr_kernel / :131
// _cbsr_half_kernel (entry cbsr_topk_wide_f32: (V, k) float32 values and
// int32 selectors, ascending per row). The two entries share their device
// code with each other and with nothing else.
//
// The function, as in the register kernels:
//   * Key: the order-preserving map of IEEE-754 float32 onto uint32
//     (negative: ~bits, else bits | 0x80000000); -0.0 orders below +0.0.
//     The map is a bijection, so a value is recovered from its key.
//   * Descent: MSB-first towards the largest t with count(key >= t) >= k,
//     left at the first step whose count is exactly k. The count of the
//     last step that took its candidate starts at D, so k = D runs no step.
//   * Ties: after a full descent, need = k - count(key > t) of the keys
//     equal to t are kept, in column order. After an early exit (or none
//     at k = D) the keep set is exactly {key >= t}: no ranks are needed.
//
// What bounds it on the H100. The bytes that must move at (16384, 2048),
// k = 32: one read of x (134 MB) and one write of the output, y and mask
// for K1's entry (302 MB in all, 0.090 ms at 3.35 TB/s) or k values and
// selectors for K4's (138 MB, 0.041 ms). The descent adds work that does
// not touch device memory: each step counts all D keys again (16.2 steps a
// row on randn, 32 on integer ties). From shared memory that is 16.2 x
// 8 KB x 16384 rows = 2.2 GB, ~0.065 ms at the 132 SMs' 128 B a clock
// (~33 TB/s at 1.98 GHz). Its issue is the larger cost. In SASS
// (wide_ab.py) a step at 128 threads and D = 2048 is ~107 instructions a
// warp: 48 for the warp's 16 keys (3 each: compare, add, predicated move)
// and ~59 for the loop, the shared reads, the warp sum, the barrier and
// the block sum. That is ~6.9 K warp instructions a row on randn, ~0.11 ms
// at one warp instruction a clock in each of the 528 schedulers. So
// instruction issue, not bytes, sets its pace (PERF.md has the times).
//
// Design: one block of kThreads threads per row.
//   1. The row is read from device memory once. The block loads it, keys
//      it in registers and stores the keys in dynamic shared memory, zero-
//      padded to whole 16-byte quads (key 0 never counts: every candidate
//      has a bit set, and 0 > t never holds). When every row starts on a
//      16-byte boundary (D % 4 == 0 and aligned tensors) the loads are
//      16-byte vectors, four in flight a thread; otherwise scalar. (A bulk
//      asynchronous copy would land raw floats, to be keyed in a second
//      pass over shared memory or again at every step; loading through
//      registers keys them on the way.) Values are recovered from the keys
//      in the output pass, so x is not read again.
//   2. The descent is block-cooperative: on each step every thread counts
//      its D / kThreads keys (16-byte reads of shared memory), each warp
//      sums with __reduce_add_sync, and the warps' sums meet in shared
//      memory. The slots are double-buffered, so one __syncthreads a step
//      is enough, and every thread takes the same decision, the early exit
//      at count == k included. The count of key > t (after a full descent
//      only) comes from the same shared keys.
//   3. The output pass walks the row in column order, kThreads x 4 (or x 1
//      when unaligned) columns at a time, each thread its own consecutive
//      columns. Kept counts (and, after a full descent, tie counts) are
//      summed across the block by a warp scan and one exchange of the
//      warps' totals, which rank the ties and give K4's entry its
//      compaction slots: slot = (kept before) = (> t before) +
//      min(ties before, need). Stores are coalesced: y as 16-byte and mask
//      as 4-byte vectors, values and selectors in ascending runs. K1's
//      entry after an early exit needs no ranks and no barrier at all.
//   4. Any D: rows whose keys fit in the cap of shared memory that
//      ops/cuda_topk.py::wide_plan sets (48 KB, D <= 12288) take design 1;
//      wider rows run the same block-cooperative template on keys computed
//      from device memory at each step (kShared = false). The plan, made
//      in Python, passes the dynamic shared-memory bytes (0: streamed) and
//      whether the 16-byte path applies; the entry checks both and returns
//      any error, that of the shared-memory opt-in included. Row offsets
//      are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// The block: one row per block. 128 threads were kept over 256 by
// measuring both (PERF.md, wide_ab.py).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// The most dynamic shared memory a block takes for a row's keys: 48 KB,
// D <= 12288, the cap of ops/cuda_topk.py::WIDE_SMEM_CAP. With the 32 bytes
// of slots it passes the 48 KB a block gets without the opt-in.
constexpr int kSmemCap = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t sortable_key(float v) {
  uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The inverse of sortable_key, bit for bit (NaN payloads included).
__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The keys of columns c .. c + N - 1: from shared memory (sk), or keyed
// from the row in device memory (xr). N = 4 reads one 16-byte quad.
template <bool kShared, int N>
__device__ __forceinline__ void keys_at(const uint32_t* sk,
                                        const float* __restrict__ xr, int c,
                                        uint32_t (&key)[N]) {
  if constexpr (N == 4) {
    if constexpr (kShared) {
      const uint4 u = *reinterpret_cast<const uint4*>(sk + c);
      key[0] = u.x; key[1] = u.y; key[2] = u.z; key[3] = u.w;
    } else {
      const float4 f = __ldg(reinterpret_cast<const float4*>(xr + c));
      key[0] = sortable_key(f.x); key[1] = sortable_key(f.y);
      key[2] = sortable_key(f.z); key[3] = sortable_key(f.w);
    }
  } else {
    key[0] = kShared ? sk[c] : sortable_key(__ldg(xr + c));
  }
}

// This thread's count of the row's keys that pred holds for. Shared keys
// are read a quad at a time whatever the row's alignment (they are
// zero-padded); streamed ones kVec at a time.
template <bool kShared, int kVec, typename Pred>
__device__ __forceinline__ unsigned count_keys(const uint32_t* sk,
                                               const float* __restrict__ xr,
                                               int d, Pred pred) {
  constexpr int N = kShared ? 4 : kVec;
  const int n = kShared ? (d + 3) & ~3 : d;
  unsigned cnt = 0;
#pragma unroll 2
  for (int c = threadIdx.x * N; c < n; c += kThreads * N) {
    uint32_t key[N];
    keys_at<kShared, N>(sk, xr, c, key);
#pragma unroll
    for (int j = 0; j < N; ++j) cnt += pred(key[j]);
  }
  return cnt;
}

// v summed over the block, the same in every thread. Each warp's sum goes
// to slots[buf]; the next call uses the other buffer, and any write into
// this one again comes two calls later, past a barrier that every thread
// reaches only after these reads: one __syncthreads a call suffices.
__device__ __forceinline__ unsigned block_total(unsigned v,
                                                uint32_t (*slots)[kWarps],
                                                int& buf) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) slots[buf][threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += slots[buf][w];
  buf ^= 1;
  return total;
}

// The exclusive prefix of v over the block in thread order, and (in
// *total) its sum; slots as in block_total.
__device__ __forceinline__ unsigned block_scan(unsigned v,
                                               uint32_t (*slots)[kWarps],
                                               int& buf, unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, incl, o);
    incl += lane >= o ? u : 0u;
  }
  if (lane == 31) slots[buf][warp] = incl;
  __syncthreads();
  unsigned before = incl - v, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned s = slots[buf][w];
    before += w < warp ? s : 0u;
    sum += s;
  }
  buf ^= 1;
  *total = sum;
  return before;
}

// One row per block. kCompact: K4's entry (out_v = values, out_b = int32
// selectors, (V, k)); else K1's (out_v = y, out_b = uint8 mask, (V, D)).
// kShared: the row's keys sit in dynamic shared memory; else they are
// read from x at every pass. kVec: 4 when every row starts 16-byte
// aligned (D % 4 == 0), else 1.
template <bool kCompact, bool kShared, int kVec>
__global__ void __launch_bounds__(kThreads)
topk_wide_kernel(const float* __restrict__ x, float* __restrict__ out_v,
                 void* __restrict__ out_b, int d, int k) {
  extern __shared__ __align__(16) uint32_t sk[];
  __shared__ __align__(16) uint32_t slots[2][kWarps];
  int buf = 0;
  const int64_t row = blockIdx.x;
  const float* xr = x + row * d;

  if constexpr (kShared) {
    if constexpr (kVec == 4) {
      // Four 16-byte loads in flight a thread before any store.
      const int nq = d >> 2;
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      uint4* s4 = reinterpret_cast<uint4*>(sk);
#pragma unroll 1
      for (int q0 = threadIdx.x; q0 < nq; q0 += 4 * kThreads) {
        float4 f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i * kThreads;
          if (q < nq) f[i] = __ldg(x4 + q);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + i * kThreads;
          if (q < nq)
            s4[q] = make_uint4(sortable_key(f[i].x), sortable_key(f[i].y),
                               sortable_key(f[i].z), sortable_key(f[i].w));
        }
      }
    } else {
      const int n = (d + 3) & ~3;
#pragma unroll 4
      for (int c = threadIdx.x; c < n; c += kThreads)
        sk[c] = c < d ? sortable_key(__ldg(xr + c)) : 0u;
    }
    __syncthreads();
  }

  // MSB-first descent, left as soon as cnt_t = count(key >= t) == k. The
  // exit is one compare and one branch after the select, as in K1 and
  // K4; `cnt` is the block's sum, so the break is block-uniform.
  uint32_t t = 0;
  int bit = 31;
  if (k != d) {
#pragma unroll 1
    for (; bit >= 0; --bit) {
      const uint32_t cand = t | (1u << bit);
      const unsigned cnt = block_total(
          count_keys<kShared, kVec>(sk, xr, d,
                                    [cand](uint32_t key) {
                                      return key >= cand;
                                    }),
          slots, buf);
      t = cnt >= (unsigned)k ? cand : t;
      if (cnt == (unsigned)k) break;
    }
  }
  // Left early (or ran no step): keep {key >= t}. Else a full descent: t
  // is the k-th largest key, and `need` >= 1 of the keys equal to t are
  // kept, in column order.
  const bool exited = bit >= 0;
  int need = 0;
  if (!exited)
    need = k - (int)block_total(
                   count_keys<kShared, kVec>(sk, xr, d,
                                             [t](uint32_t key) {
                                               return key > t;
                                             }),
                   slots, buf);

  if constexpr (!kCompact) {
    if (exited) {
      // No ranks: every column's output is its own.
      float* yr = out_v + row * d;
      uint8_t* mr = static_cast<uint8_t*>(out_b) + row * d;
#pragma unroll 2
      for (int c = threadIdx.x * kVec; c < d; c += kThreads * kVec) {
        uint32_t key[kVec];
        keys_at<kShared, kVec>(sk, xr, c, key);
        if constexpr (kVec == 4) {
          float4 y;
          y.x = key[0] >= t ? key_value(key[0]) : 0.0f;
          y.y = key[1] >= t ? key_value(key[1]) : 0.0f;
          y.z = key[2] >= t ? key_value(key[2]) : 0.0f;
          y.w = key[3] >= t ? key_value(key[3]) : 0.0f;
          *reinterpret_cast<float4*>(yr + c) = y;
          *reinterpret_cast<uint32_t*>(mr + c) =
              (uint32_t)(key[0] >= t) | (uint32_t)(key[1] >= t) << 8 |
              (uint32_t)(key[2] >= t) << 16 | (uint32_t)(key[3] >= t) << 24;
        } else {
          // Dropped entries are +0.0, as in maxk_topk.cu.
          yr[c] = key[0] >= t ? key_value(key[0]) : 0.0f;
          mr[c] = key[0] >= t ? 1 : 0;
        }
      }
      return;
    }
  }

  // The ranked pass, in column order, kThreads * kVec columns a chunk:
  // `above` = kept whatever its rank (key >= t after an exit, else
  // key > t), `tie` = key == t after a full descent. Within a chunk both
  // counts fit 16 bits, so one scan of (above | tie << 16) gives every
  // column the number of each before it in the row.
  int above_before = 0, ties_before = 0;
#pragma unroll 1
  for (int base = 0; base < d; base += kThreads * kVec) {
    const int c0 = base + threadIdx.x * kVec;
    uint32_t key[kVec] = {};
    bool above[kVec], tie[kVec];
    unsigned mine = 0;
    if (c0 < d) keys_at<kShared, kVec>(sk, xr, c0, key);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      // kVec = 4 only when d % 4 == 0: a quad is all in or all out.
      const bool valid = c0 < d;
      above[j] = valid && (exited ? key[j] >= t : key[j] > t);
      tie[j] = valid && !exited && key[j] == t;
      mine += (unsigned)above[j] + ((unsigned)tie[j] << 16);
    }
    unsigned total;
    const unsigned before = block_scan(mine, slots, buf, &total);
    int e = ties_before + (int)(before >> 16);
    if (c0 < d) {
      if constexpr (kCompact) {
        int a = above_before + (int)(before & 0xffffu);
        float* vr = out_v + row * k;
        int32_t* sr = static_cast<int32_t*>(out_b) + row * k;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          if (above[j] || (tie[j] && e < need)) {
            const int slot = a + min(e, need);
            vr[slot] = key_value(key[j]);
            sr[slot] = c0 + j;
          }
          a += above[j];
          e += tie[j];
        }
      } else {
        float* yr = out_v + row * d;
        uint8_t* mr = static_cast<uint8_t*>(out_b) + row * d;
        bool keep[kVec];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          keep[j] = above[j] || (tie[j] && e < need);
          e += tie[j];
        }
        if constexpr (kVec == 4) {
          float4 y;
          y.x = keep[0] ? key_value(key[0]) : 0.0f;
          y.y = keep[1] ? key_value(key[1]) : 0.0f;
          y.z = keep[2] ? key_value(key[2]) : 0.0f;
          y.w = keep[3] ? key_value(key[3]) : 0.0f;
          *reinterpret_cast<float4*>(yr + c0) = y;
          *reinterpret_cast<uint32_t*>(mr + c0) =
              (uint32_t)keep[0] | (uint32_t)keep[1] << 8 |
              (uint32_t)keep[2] << 16 | (uint32_t)keep[3] << 24;
        } else {
          yr[c0] = keep[0] ? key_value(key[0]) : 0.0f;
          mr[c0] = keep[0] ? 1 : 0;
        }
      }
    }
    above_before += (int)(total & 0xffffu);
    ties_before += (int)(total >> 16);
  }
}

template <bool kCompact, bool kShared, int kVec>
cudaError_t launch(const float* x, float* out_v, void* out_b,
                   int64_t n_rows, int d, int k, int smem_bytes,
                   cudaStream_t stream) {
  auto* kernel = topk_wide_kernel<kCompact, kShared, kVec>;
  if constexpr (kShared) {
    // The opt-in to kSmemCap bytes of dynamic shared memory, a host-side
    // attribute of the current device: set once a device. Every caller
    // sets the same value, so a race only repeats the call.
    static std::atomic<bool> opted[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted[dev].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
      if (err != cudaSuccess) return err;
      opted[dev].store(true, std::memory_order_release);
    }
  }
  kernel<<<(unsigned)n_rows, kThreads, kShared ? smem_bytes : 0, stream>>>(
      x, out_v, out_b, d, k);
  return cudaGetLastError();
}

template <bool kCompact>
int dispatch(const void* x, void* out_a, void* out_b, int64_t n_rows, int d,
             int k, int vec, int smem_bytes, void* stream) {
  // The plan's shared bytes (if any) must hold the row's keys padded to
  // whole quads, within the cap; its 16-byte path needs D % 4 == 0 and
  // the three bases 16-byte aligned.
  const bool aligned =
      d % 4 == 0 &&
      ((uintptr_t)x | (uintptr_t)out_a | (uintptr_t)out_b) % 16 == 0;
  if (n_rows > 0x7fffffff || (vec != 0 && vec != 1) || (vec && !aligned) ||
      (smem_bytes != 0 &&
       (smem_bytes < 4 * ((d + 3) & ~3) || smem_bytes > kSmemCap)))
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* ap = static_cast<float*>(out_a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes != 0)
    return (int)(vec ? launch<kCompact, true, 4>(xp, ap, out_b, n_rows, d, k,
                                                  smem_bytes, s)
                     : launch<kCompact, true, 1>(xp, ap, out_b, n_rows, d, k,
                                                  smem_bytes, s));
  return (int)(vec ? launch<kCompact, false, 4>(xp, ap, out_b, n_rows, d, k,
                                                 0, s)
                   : launch<kCompact, false, 1>(xp, ap, out_b, n_rows, d, k,
                                                 0, s));
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). The caller checks
// shapes (1 <= k <= d, n_rows >= 1, contiguous float32 x) and passes its
// plan (ops/cuda_topk.py::wide_plan): `vec` 1 for 16-byte loads and stores
// (D % 4 == 0 and x and the outputs 16-byte aligned), else 0; and
// `smem_bytes`, the dynamic shared memory that holds the row's keys, or 0
// to stream the row from device memory at every pass.
extern "C" int maxk_wide_f32(const void* x, void* y, void* mask,
                             int64_t n_rows, int d, int k, int vec,
                             int smem_bytes, void* stream) {
  return dispatch<false>(x, y, mask, n_rows, d, k, vec, smem_bytes, stream);
}

extern "C" int cbsr_topk_wide_f32(const void* x, void* values,
                                  void* selector, int64_t n_rows, int d,
                                  int k, int vec, int smem_bytes,
                                  void* stream) {
  return dispatch<true>(x, values, selector, n_rows, d, k, vec, smem_bytes,
                        stream);
}
