// RG-LRU diagonal recurrence (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan/kernel.py:
// rglru_scan_btd (its kernel body at :33, wrapped by ops.py:rglru_scan).
// For every (batch, channel) it carries one f32 state over the sequence:
//
//   h_{-1} = 0,   h_t = a_t * h_{t-1} + b_t
//
// a and b are (B, T, D), float32 or bfloat16, upcast to f32 on load; h is
// (B, T, D) f32 (its last step is the decode cache's state).  Rounding: the
// product and the add are rounded one at a time (__fmul_rn, then
// __fadd_rn), as the TPU kernel's body writes them (kernel.py:47,
// `at * h + btk`) and as the plain version's two torch ops compute them, so
// kernel and plain version agree bit for bit.  nvcc would otherwise
// contract the two into one FMA.  That also rules out a two-pass chunked
// scan, which sums in another order: each channel stays one sequential
// chain.
//
// Bound: at RecurrentGemma-9B's prefill shape (B 4, T 1024, D 4096, f32)
// the bytes (a, b read once, h written once: 3 B T D 4 = 201 MB, 0.060 ms
// at 3.35 TB/s) bound it; the work is one multiply and one add per element.
// There are only B D = 16,384 chains (about four warps per SM), so what
// keeps the bytes moving is how many loads each chain has in flight: at the
// device-memory latency, 3.35 TB/s needs some tens of KB in flight per SM.
//
// Design (the ring path): a CTA is one warp of kCols channels of one batch
// row, 512 CTAs at the path's shape, all resident at once (four to an SM,
// 32 KB of shared memory each).  A ring of kStages stages, each kSteps time
// steps x kCols channels of a and of b, is filled by the TMA engine's bulk
// copies (lane l copies step l's row of a and of b; all complete on the
// stage's mbarrier), so up to kStages x 8 KB per CTA are in flight while
// the chain walks the oldest stage.  h is written by coalesced stores, one
// 128-byte row per warp and step.
// A bulk copy needs 16-byte aligned rows: where a row of D elements is not
// a multiple of 16 bytes (or a pointer is not 16-byte aligned), the kernel
// takes the direct path, one thread per channel with direct loads, the
// same arithmetic.
//
// C entry point (bound with ctypes): rglru_scan_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;    // channels per CTA on the ring path: one warp
constexpr int kSteps = 32;   // time steps per ring stage: one bulk copy per lane
constexpr int kStages = 4;
constexpr int kDirectThreads = 128;
constexpr uint32_t kSpinLimit = 1u << 28;  // a lost barrier phase traps, never hangs

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kSpinLimit) __trap();
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the TMA engine, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

template <typename T>
__global__ void __launch_bounds__(kCols)
rglru_scan_ring(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ h_out,
                int n_steps, int D) {
  __shared__ __align__(128) T as[kStages][kSteps][kCols];
  __shared__ __align__(128) T bs[kStages][kSteps][kCols];
  __shared__ __align__(8) uint64_t full[kStages];

  const int lane = threadIdx.x;
  const int d0 = blockIdx.x * kCols, row = blockIdx.y;
  const int ncols = min(kCols, D - d0);
  const uint32_t row_bytes = ncols * sizeof(T);
  const int64_t base = static_cast<int64_t>(row) * n_steps * D + d0;
  const int n_chunks = (n_steps + kSteps - 1) / kSteps;

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // stage s takes chunk c: lane l copies step c * kSteps + l of a and of b
  auto issue = [&](int s, int c) {
    const int t0 = c * kSteps, n = min(kSteps, n_steps - t0);
    const uint32_t bar = smem_u32(&full[s]);
    if (lane == 0) mbar_expect_tx(bar, 2 * n * row_bytes);
    __syncwarp();
    if (lane < n) {
      const int64_t off = base + static_cast<int64_t>(t0 + lane) * D;
      bulk_load(smem_u32(&as[s][lane][0]), a + off, row_bytes, bar);
      bulk_load(smem_u32(&bs[s][lane][0]), b + off, row_bytes, bar);
    }
  };
  for (int s = 0; s < kStages && s < n_chunks; ++s) issue(s, s);

  float h = 0.f;
  float* out = h_out + base + lane;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages, t0 = c * kSteps, n = min(kSteps, n_steps - t0);
    mbar_wait(smem_u32(&full[s]), (c / kStages) & 1);
    if (lane < ncols) {
      float* o = out + static_cast<int64_t>(t0) * D;
      if (n == kSteps) {
#pragma unroll
        for (int t = 0; t < kSteps; ++t) {
          h = step(to_f32(as[s][t][lane]), h, to_f32(bs[s][t][lane]));
          o[static_cast<int64_t>(t) * D] = h;
        }
      } else {
        for (int t = 0; t < n; ++t) {
          h = step(to_f32(as[s][t][lane]), h, to_f32(bs[s][t][lane]));
          o[static_cast<int64_t>(t) * D] = h;
        }
      }
    }
    __syncwarp();  // every lane is done with stage s
    if (c + kStages < n_chunks) issue(s, c + kStages);
  }
}

// the direct path: one thread per (b, d) channel; consecutive threads take
// consecutive channels, so each step's loads and stores coalesce
template <typename T>
__global__ void __launch_bounds__(kDirectThreads)
rglru_scan_direct(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ h_out,
                  int B, int n_steps, int D) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kDirectThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(B) * D) return;
  const int64_t row = idx / D, d = idx % D;
  const int64_t base = row * n_steps * D + d;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < n_steps; ++t) {
    const int64_t off = base + static_cast<int64_t>(t) * D;
    h = step(to_f32(a[off]), h, to_f32(b[off]));
    h_out[off] = h;
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int n_steps, int D, cudaStream_t stream) {
  // the bulk copies need 16-byte aligned rows and base addresses
  const bool aligned = (static_cast<int64_t>(D) * sizeof(T)) % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  if (aligned && B <= 65535) {
    const dim3 grid((D + kCols - 1) / kCols, B);
    rglru_scan_ring<T><<<grid, kCols, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(h), n_steps, D);
  } else {
    const int64_t blocks = (static_cast<int64_t>(B) * D + kDirectThreads - 1) / kDirectThreads;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    rglru_scan_direct<T><<<static_cast<unsigned>(blocks), kDirectThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(h), B, n_steps,
        D);
  }
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
