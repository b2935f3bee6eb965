// Blockwise online-softmax attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _attn_kernel (launched by flash_attention_bhsd, wrapped by
// ops.py:flash_attention).  It computes what that kernel computes, for
// q, k, v of shape (B, S, H, D) in the op's own layout (read through
// strides, no transposes):
//
//   s = (q . k) * scale            scale = D^-0.5 in f32, after the product
//   masked s = -1e30               causal: kpos <= qpos; window W: kpos > qpos - W
//   m_new = max(m, rowmax(s)), alpha = exp(m - m_new), p = exp(s - m_new)
//   p = 0 where masked             (a fully masked row of a live tile would
//                                   otherwise get exp(0) = 1)
//   l = l * alpha + rowsum(p), acc = acc * alpha + p . v
//   out = acc / max(l, 1e-30)      rounded once to the input type
//
// Inputs (float32 or bfloat16) are upcast to f32 before both products; all
// arithmetic is f32.  kv tiles that lie wholly outside the causal or window
// band of a q tile are skipped, as the TPU kernel skips them with pl.when.
//
// Bound: at the serving path's prefill shape (B 4, H 32, S 1024, D 64,
// bf16, causal) the bytes (q, k, v read once, out written once: 64 MiB,
// 0.020 ms at 3.35 TB/s) and the operations (4 B H D S(S+1)/2 = 17.2 GFLOP,
// 0.017 ms at the bf16 tensor-core peak) are close; bytes bound it.  This
// kernel is the simple, right version: f32 FMAs on the CUDA cores, with no
// tensor cores, TMA or pipelining, so it runs far from that bound (see
// PERF.md).  wgmma and a TMA ring are a later step.
//
// Design: one CTA of 256 threads per (q tile of 64 rows, head, batch).  The
// CTA stages its q tile and each kv tile of BK rows (32 or 64) in shared
// memory as f32, rows padded by one word so the column walks below hit
// distinct banks.  Each thread owns a 4 x (BK/16) block of the score tile
// and a 4 x (D/16) block of the output accumulator (rows 4*ty..4*ty+3,
// columns tx + 16*c), kept in registers.  The running max, sum and the
// tile's rescale factor per row live in shared memory; four neighbouring
// lanes own one row for the softmax step and combine with shuffles.  Rows
// and keys past S read as zero and are masked, so a ragged tail is safe.
//
// C entry point (bound with ctypes): flash_attention_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D, int BK>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (D + 1)  // q tile
         + static_cast<size_t>(BK) * (D + 1)  // k tile
         + static_cast<size_t>(BK) * D        // v tile
         + static_cast<size_t>(kBQ) * (BK + 1)  // scores, then p
         + 3 * kBQ;                           // m, l, alpha per row
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int S, int causal, int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int causal, int window, float scale) {
  constexpr int QS = D + 1;   // padded row stride of the q and k tiles
  constexpr int SS = BK + 1;  // padded row stride of the score tile
  constexpr int CS = BK / 16; // score columns per thread
  constexpr int CO = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ss = Vs + BK * D;
  float* m_s = Ss + kBQ * SS;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * kBQ;
  const int64_t row_stride = static_cast<int64_t>(H) * D;  // one sequence step
  const int64_t base = static_cast<int64_t>(blockIdx.z) * S * row_stride +
                       static_cast<int64_t>(blockIdx.y) * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = q_start + r;
    Qs[r * QS + d] = s < S ? to_f32(q[base + s * row_stride + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;

  const int n_kv = (S + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BK;
    // the TPU kernel's block skip; uniform over the CTA
    bool live = true;
    if (causal) live = k_start <= q_start + kBQ - 1;
    if (window > 0) live = live && (k_start + BK - 1 > q_start - window);
    if (!live) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int r = idx / D, d = idx % D, s = k_start + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = to_f32(k[base + s * row_stride + d]);
        vx = to_f32(v[base + s * row_stride + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    // scores: rows 4*ty+i, keys tx+16*c
    float sc[4][CS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CS; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[CS];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(4 * ty + i) * QS + d];
#pragma unroll
      for (int c = 0; c < CS; ++c) kv[c] = Ks[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CS; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CS; ++c) Ss[(4 * ty + i) * SS + tx + 16 * c] = sc[i][c] * scale;
    __syncthreads();

    // online softmax: four neighbouring lanes per row
    {
      const int r = tid / 4, part = tid % 4, qpos = q_start + r;
      float mx = kNegInf;
      for (int c = part; c < BK; c += 4) {
        if (allowed(qpos, k_start + c, S, causal, window)) mx = fmaxf(mx, Ss[r * SS + c]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = allowed(qpos, k_start + c, S, causal, window)
                            ? expf(Ss[r * SS + c] - m_new) : 0.f;
        Ss[r * SS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      // every lane of the row read m_s[r] before the shuffles above
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[4 * ty + i];
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[CO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(4 * ty + i) * SS + j];
#pragma unroll
      for (int c = 0; c < CO; ++c) vv[c] = Vs[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i, s = q_start + r;
    if (s < S) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < CO; ++c) store_out(o + base + s * row_stride + tx + 16 * c, acc[i][c] / l);
    }
  }
}

template <typename T, int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<D, BK>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(o), S, H,
                                            causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BK>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int D,
               int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64, BK>(q, k, v, o, B, S, H, causal, window, scale, stream);
    case 128: return launch<T, 128, BK>(q, k, v, o, B, S, H, causal, window, scale, stream);
    case 256: return launch<T, 256, BK>(q, k, v, o, B, S, H, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_bk(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int D,
                int causal, int window, int kv_tile, float scale, cudaStream_t stream) {
  switch (kv_tile) {
    case 32: return dispatch_d<T, 32>(q, k, v, o, B, S, H, D, causal, window, scale, stream);
    case 64: return dispatch_d<T, 64>(q, k, v, o, B, S, H, D, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o: contiguous (B, S, H, D) of one type; dtype 0 = float32,
// 1 = bfloat16; window <= 0 means none; kv_tile 32 or 64; D 64, 128 or 256.
// The caller checked shapes, devices and contiguity and allocated o.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int D, int causal, int window, int kv_tile,
                                   float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case 0: return dispatch_bk<float>(q, k, v, o, B, S, H, D, causal, window, kv_tile, scale, s);
    case 1:
      return dispatch_bk<__nv_bfloat16>(q, k, v, o, B, S, H, D, causal, window, kv_tile, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
