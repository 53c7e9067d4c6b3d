// K3: CBSR gather on Hopper (sm_90a), out[i, l] = dense[i, selector[i, l]].
//
// Replaces the TPU kernel maxk_tpu/ops/pallas_gather.py::_gather_kernel
// (wrapper cbsr_gather_pallas; the JAX package's XLA formulation is
// ops/cbsr.py::cbsr_gather). It samples a (V, D) float32 or bfloat16
// matrix at each row's k selector columns and returns (V, k) in the
// input's type: the sampling step of the CBSR route's backward SSpMM.
//
// What bounds it on the H100: bytes. It reads the (V, k) int32 selectors
// and writes (V, k) outputs once each, coalesced. Each gathered element
// pulls a whole 32-byte sector of its row of `dense`, so the gathered
// bytes are 32 per distinct sector that a row's selectors touch, not 4 or
// 2 per element: at k = 32 of D = 256 in bfloat16, top-k selectors touch
// about 14 of a row's 16 sectors.
//
// Design: V*k output elements in tiles of 1024, one tile per block of
// 256 threads, each thread taking the elements t, t + 256, t + 512 and
// t + 768 of its tile. Neighbouring threads take neighbouring (i, l), so
// the selector loads and the output stores of a warp are contiguous. A
// thread first loads its four selectors, then issues its four gathers,
// then stores: four independent loads in flight per thread hide the
// latency of the dependent selector -> gather chain. No shared memory and
// no atomics: each output is written by one thread. bfloat16 is moved as
// its 16 bits, so the output is the input's value bit for bit. The
// caller guarantees 0 <= selector < D (top-k selectors are).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cbsr_gather_kernel(const T* __restrict__ dense,
                   const int32_t* __restrict__ selector, T* __restrict__ out,
                   int64_t n, int d, int k) {
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x;
  int32_t s[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int64_t i = base + e * kThreads;
    s[e] = i < n ? selector[i] : 0;
  }
  T val[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int64_t i = base + e * kThreads;
    if (i < n) val[e] = dense[(i / k) * d + s[e]];
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int64_t i = base + e * kThreads;
    if (i < n) out[i] = val[e];
  }
}

template <typename T>
cudaError_t launch(const void* dense, const void* selector, void* out,
                   int64_t n_rows, int d, int k, void* stream) {
  const int64_t n = n_rows * k;
  const int64_t blocks = (n + kTile - 1) / kTile;
  cbsr_gather_kernel<T><<<(unsigned)blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dense), static_cast<const int32_t*>(selector),
      static_cast<T*>(out), n, d, k);
  return cudaGetLastError();
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success). The caller checks
// shapes and contiguity: n_rows * k >= 1, dense (n_rows, d), selector and
// out (n_rows, k).
extern "C" int cbsr_gather_f32(const void* dense, const void* selector,
                               void* out, int64_t n_rows, int d, int k,
                               void* stream) {
  return launch<float>(dense, selector, out, n_rows, d, k, stream);
}

extern "C" int cbsr_gather_bf16(const void* dense, const void* selector,
                                void* out, int64_t n_rows, int d, int k,
                                void* stream) {
  return launch<uint16_t>(dense, selector, out, n_rows, d, k, stream);
}
