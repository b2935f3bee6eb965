// RG-LRU diagonal recurrence (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py:
// rglru_scan_btd (its kernel body at :33, wrapped by ops.py:rglru_scan).
// For every (batch, channel) it carries one f32 state over the sequence:
//
//   h_{-1} = 0,   h_t = a_t * h_{t-1} + b_t
//
// a and b are (B, T, D), float32 or bfloat16, upcast to f32 on load; h is
// (B, T, D) f32.  Rounding: the product and the add are rounded one at a
// time (__fmul_rn, then __fadd_rn), as the TPU kernel's body writes them
// (kernel.py:47, `at * h + btk`) and as the plain version's two torch ops
// compute them, so kernel and plain version agree bit for bit.  nvcc would
// otherwise contract the two into one FMA.
//
// Bound: at RecurrentGemma-9B's prefill shape (B 4, T 1024, D 4096, f32)
// the bytes (a, b read once, h written once: 3 B T D 4 = 201 MB, 0.060 ms
// at 3.35 TB/s) bound it; the work is one multiply and one add per element.
// This is the simple, right version: B D = 16,384 threads each walk a
// 1024-step dependency chain, so it is bound by the latency of that chain
// and of its loads, not by the bytes (PERF.md).  A two-pass chunked scan
// (chunk products and offsets, then a fix-up) is a later step.
//
// Design: one thread per (b, d) channel, kThreads threads per CTA; thread i
// of a CTA takes channel d = i mod D of row b = i / D, so consecutive
// threads read and write consecutive addresses at every time step (each
// step's loads and stores coalesce).  The state stays in a register; the
// loop is unrolled so the loads of several steps are in flight at once.
//
// C entry point (bound with ctypes): rglru_scan_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ h_out,
                  int B, int n_steps, int D) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * D) return;
  const int64_t row = idx / D, d = idx % D;
  const int64_t base = row * n_steps * D + d;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < n_steps; ++t) {
    const int64_t off = base + static_cast<int64_t>(t) * D;
    h = __fadd_rn(__fmul_rn(to_f32(a[off]), h), to_f32(b[off]));
    h_out[off] = h;
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int n_steps, int D, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(B) * D;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(h), B, n_steps, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: contiguous (B, T, D) of one type (dtype 0 = float32, 1 = bfloat16);
// h: contiguous (B, T, D) float32.  The caller checked shapes, devices and
// contiguity and allocated h.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B, int T, int D,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return launch<float>(a, b, h, B, T, D, s);
    case 1: return launch<__nv_bfloat16>(a, b, h, B, T, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
