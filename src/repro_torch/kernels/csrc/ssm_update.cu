// Mamba-2 decode state update for Hopper (sm_90a): one token of the
// selective state-space recurrence over every (session, head) of a batch.
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 layer.  Added for
// Granite-4.0-H's decode (models/mamba2.py), where the plain version
// (kernels/ssm_update/ref.py) makes about eight passes over the state: the
// decay's product, the outer product, their sum, the output's product.
//
//   h <- exp(dt * A) * h + (dt * x) outer B,    y = h @ C + D * x
//
// per (session b, head i): h (P, N) float32, x (P), dt and A and D scalars,
// B and C (N) of the head's group i / (H / G).  The state is updated in
// place (the decode cache's leaf) and y (P) written.
//
// Bound: bandwidth.  The state is read once and written once; the rest is
// small: 4 * (2*Bt*H*P*N + 2*Bt*H*P + Bt*H + 2*H + 2*Bt*G*N) bytes at
// 3.35 TB/s (the benchmark counts it so).  Granite-4.0-H-Micro at 32
// sessions: 134 MB, 0.040 ms a layer.
//
// Design: one CTA of 8 warps per (session, head); B and C go to shared
// memory once.  Warp w owns rows w, w + 8, ...; a lane owns 16-byte column
// chunks lane, lane + 32, ... of a row (N = 128: one chunk).  A warp loads
// kRows rows before it computes them, so each warp keeps that many
// 512-byte loads in flight; y[p] is the warp's shuffle sum plus D * x[p].
//
// C entry point (bound with ctypes): ssm_update_fwd returns
// cudaGetLastError() after the launch, 0 on success.  The caller checked
// shapes, dtypes, contiguity, N % 4 == 0, N <= 512 and a 16-byte aligned h.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;  // rows a warp loads before it computes

template <int kVec>  // 16-byte chunks a lane holds per row: ceil(N / 128)
__global__ void __launch_bounds__(kWarps * 32)
ssm_update_kernel(float* __restrict__ h, const float* __restrict__ x,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ D, float* __restrict__ y, int H, int P, int N,
                  int G) {
  extern __shared__ float4 smem[];  // B, then C: N / 4 chunks each
  float* sB = reinterpret_cast<float*>(smem);
  float* sC = sB + N;
  const int bh = blockIdx.x;  // session * H + head
  const int b = bh / H;
  const int head = bh - b * H;
  const int g = head / (H / G);
  const float* Bsrc = Bm + (static_cast<int64_t>(b) * G + g) * N;
  const float* Csrc = Cm + (static_cast<int64_t>(b) * G + g) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sB[i] = Bsrc[i];
    sC[i] = Csrc[i];
  }
  __syncthreads();
  const float4* sB4 = reinterpret_cast<const float4*>(sB);
  const float4* sC4 = reinterpret_cast<const float4*>(sC);

  const int n4 = N >> 2;
  const float dtv = dt[bh];
  const float dA = expf(dtv * A[head]);
  const float Dv = D[head];
  const float* xr = x + static_cast<int64_t>(bh) * P;
  float* yr = y + static_cast<int64_t>(bh) * P;
  float4* hb = reinterpret_cast<float4*>(h + static_cast<int64_t>(bh) * P * N);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int p0 = warp; p0 < P; p0 += kWarps * kRows) {  // p0 is the same across a warp
    float4 hv[kRows][kVec];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = p0 + r * kWarps;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int c = lane + 32 * v;
        if (p < P && c < n4) hv[r][v] = hb[static_cast<int64_t>(p) * n4 + c];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = p0 + r * kWarps;
      if (p >= P) break;
      const float xv = xr[p];
      const float dtx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int c = lane + 32 * v;
        if (c < n4) {
          float4 s = hv[r][v];
          const float4 bb = sB4[c];
          const float4 cc = sC4[c];
          s.x = dA * s.x + dtx * bb.x;
          s.y = dA * s.y + dtx * bb.y;
          s.z = dA * s.z + dtx * bb.z;
          s.w = dA * s.w + dtx * bb.w;
          hb[static_cast<int64_t>(p) * n4 + c] = s;
          acc += s.x * cc.x + s.y * cc.y + s.z * cc.z + s.w * cc.w;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) yr[p] = acc + Dv * xv;
    }
  }
}

template <int kVec>
void launch(float* h, const float* x, const float* dt, const float* A, const float* B,
            const float* C, const float* D, float* y, int64_t bt, int H, int P, int N, int G,
            cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(float);
  ssm_update_kernel<kVec><<<static_cast<unsigned>(bt * H), kWarps * 32, smem, stream>>>(
      h, x, dt, A, B, C, D, y, H, P, N, G);
}

}  // namespace

extern "C" int ssm_update_fwd(void* h, const void* x, const void* dt, const void* A,
                              const void* B, const void* C, const void* D, void* y, int64_t bt,
                              int H, int P, int N, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hp = static_cast<float*>(h);
  const float* xp = static_cast<const float*>(x);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* Bp = static_cast<const float*>(B);
  const float* Cp = static_cast<const float*>(C);
  const float* Dp = static_cast<const float*>(D);
  float* yp = static_cast<float*>(y);
  if (N % 4 != 0 || N > 512 || G < 1 || H % G != 0 || bt * H > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((N / 4 + 31) / 32) {
    case 1: launch<1>(hp, xp, dtp, Ap, Bp, Cp, Dp, yp, bt, H, P, N, G, s); break;
    case 2: launch<2>(hp, xp, dtp, Ap, Bp, Cp, Dp, yp, bt, H, P, N, G, s); break;
    case 3: launch<3>(hp, xp, dtp, Ap, Bp, Cp, Dp, yp, bt, H, P, N, G, s); break;
    default: launch<4>(hp, xp, dtp, Ap, Bp, Cp, Dp, yp, bt, H, P, N, G, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
