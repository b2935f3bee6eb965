// RWKV-6 matrix-state scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan/kernel.py:
// _rwkv_kernel (launched by rwkv6_scan_bhtd, wrapped by ops.py:rwkv6_scan).
// For every (batch, head) it carries a D x D f32 state S over the sequence:
//
//   kv  = k_t^T v_t                      (outer product)
//   y_t = r_t . (S + u * kv)             u: (D,) per head, scales the rows
//   S   = diag(w_t) S + kv
//
// Inputs r, k, v, w are (B, T, H, D) in the op's own layout (read through
// the token and head strides, no transposes), float32 or bfloat16, upcast
// to f32 on load as the TPU kernel upcasts them (kernel.py:35-39); u is
// (H, D) f32; y is (B, T, H, D) f32.  The sequence is walked token by token
// from S = 0, so the result does not depend on the op's block_t (which
// only sets the TPU kernel's VMEM chunk).
//
// Bound: at the serving path's prefill shape (B 4, T 1024, H 40, D 64, f32)
// the bytes (r, k, v, w read once, y written once: 5 B T H D 4 = 210 MB,
// 0.063 ms at 3.35 TB/s) and the work (per state element and token one
// multiply and three FMAs, 7 FLOP: 4.7 GFLOP, 0.070 ms at the 67 TFLOP/s
// f32 CUDA-core peak) are close; the work bounds it.  This is the simple,
// right version: 160 CTAs of 64 threads leave most of the card idle and the
// token loop is a serial chain, so it runs far from that bound (PERF.md).
// A chunked form (the intra-chunk part as products on the tensor cores) is
// a later step.
//
// Design: one CTA of D threads per (head, batch).  Thread j owns column j of
// S in D registers, so y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
// is a serial dot in one thread (no cross-thread reduction) and the update
// S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j] is a register update.  r, k, w
// and v of kChunk tokens are staged in shared memory as f32 (each row a
// coalesced load of D elements); every thread reads r, k, w and u as
// broadcasts.  D is a template parameter: 16, 32 or 64.
//
// C entry point (bound with ctypes): rwkv6_scan_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;  // tokens staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(D)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ w, const float* __restrict__ u, float* __restrict__ y,
                  int n_tokens, int H) {
  __shared__ __align__(16) float rs[kChunk][D];
  __shared__ __align__(16) float ks[kChunk][D];
  __shared__ __align__(16) float ws[kChunk][D];
  __shared__ __align__(16) float vs[kChunk][D];
  __shared__ __align__(16) float us[D];

  const int j = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int64_t tok = static_cast<int64_t>(H) * D;  // one sequence step
  const int64_t base = static_cast<int64_t>(b) * n_tokens * tok + static_cast<int64_t>(h) * D;
  us[j] = u[h * D + j];

  float S[D];  // column j of the state
#pragma unroll
  for (int i = 0; i < D; ++i) S[i] = 0.f;

  for (int t0 = 0; t0 < n_tokens; t0 += kChunk) {
    const int n = min(kChunk, n_tokens - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int c = 0; c < n; ++c) {
      const int64_t off = base + static_cast<int64_t>(t0 + c) * tok + j;
      rs[c][j] = to_f32(r[off]);
      ks[c][j] = to_f32(k[off]);
      vs[c][j] = to_f32(v[off]);
      ws[c][j] = to_f32(w[off]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float kv = ks[c][i] * vj;
        acc = fmaf(rs[c][i], fmaf(us[i], kv, S[i]), acc);
        S[i] = fmaf(ws[c][i], S[i], kv);
      }
      y[base + static_cast<int64_t>(t0 + c) * tok + j] = acc;
    }
  }
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
           int B, int n_tokens, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  rwkv6_scan_kernel<T, D><<<grid, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u), static_cast<float*>(y), n_tokens, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
               int B, int n_tokens, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, B, n_tokens, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, y, B, n_tokens, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, y, B, n_tokens, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, w: contiguous (B, T, H, D) of one type (dtype 0 = float32,
// 1 = bfloat16); u: contiguous (H, D) float32; y: contiguous (B, T, H, D)
// float32.  D 16, 32 or 64.  The caller checked shapes, devices and
// contiguity and allocated y.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, void* y, int B, int T, int H, int D, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return dispatch_d<float>(r, k, v, w, u, y, B, T, H, D, s);
    case 1: return dispatch_d<__nv_bfloat16>(r, k, v, w, u, y, B, T, H, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
