// RWKV-6 matrix-state scan (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan/kernel.py:
// _rwkv_kernel (launched by rwkv6_scan_bhtd, wrapped by ops.py:rwkv6_scan).
// For every (batch, head) it carries a D x D f32 state S over the sequence:
//
//   y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] c_t,   c_t = sum_i r_t[i] u[i] k_t[i]
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// (the first line is y_t = r_t . (S + u * k_t^T v_t) with the bonus term
// summed once per token and head).  Inputs r, k, v, w are (B, T, H, D) in the
// op's own layout, float32 or bfloat16, upcast to f32 on load as the TPU
// kernel upcasts them (kernel.py:35-39); u is (H, D) f32; y is (B, T, H, D)
// f32.  With a non-null S_out the final state is written to a contiguous
// (B, H, D, D) f32 tensor, S_out[b, h, i, j] with i the k index and j the v
// index, the layout the decode cache holds.
//
// Bound: at the serving path's prefill shape (B 4, T 1024, H 40, D 64, f32)
// the bytes (r, k, v, w read once, y written once: 210 MB) take 0.0626 ms at
// 3.35 TB/s; the work, 5 FLOP per state element and token (r.S, k*v, the
// decayed update), takes 0.0509 ms at the 67 TFLOP/s f32 CUDA-core rate.
// That is three f32 instructions per element and token, and the partial
// dots must be summed across the threads that share a column, so the
// instruction issue of the CUDA cores, not the bytes, is what limits it.  No
// tensor cores: the work bound is already under the bytes bound; TF32 or
// bf16 products miss the 1e-4 gate against the plain version; and a chunked
// form needs products of decays within a chunk, which underflow f32 for
// decays near 0.05.
//
// Design, against each limit of the earlier one-CTA-per-head kernel (160
// CTAs of 64 threads, one column of S per thread, every load serial):
// * Parallelism.  Column j of S depends only on column j, so the grid runs
//   over (column tile of CT, head, batch) with no communication between
//   CTAs: 640 CTAs of 64 threads at the path's shape, all resident at once
//   (about 40 KB of shared memory each, five to an SM).  A thread holds a
//   4 x 4 block of S in registers (Tile), so each value it reads from
//   shared memory feeds four updates.
// * Column sums.  The 16 threads that share a column block are 16 lanes of
//   one warp; their partial dots for 4 tokens at once are summed by a
//   reduce-scatter of warp shuffles in a fixed order (column_sums), which
//   leaves one (token, column) of y in each lane: no atomics, the same bits
//   from launch to launch.  A whole chunk is straight-line code, so the
//   shuffles of one batch overlap the arithmetic of the next.
// * Loads in flight.  A ring of kStages stages, each kChunk tokens of r, k
//   and w (all D) and of the tile's CT columns of v, is filled by the TMA
//   engine, one tensor-map box per input and stage, completing on the
//   stage's mbarrier, so the next chunks load while this one computes.
// * Arithmetic.  The bonus c_t is summed per row group from the r, k the
//   thread already holds and folded into its partial dots before the column
//   sums: 5 FLOP per state element, not 7.
// The token chunk is fixed, so the op's block_t changes no bit.
//
// C entry point (bound with ctypes): rwkv6_scan_fwd returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;                  // tokens per ring stage
constexpr int kStages = 3;
constexpr uint32_t kSpinLimit = 1u << 28;   // a lost barrier phase traps, never hangs

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// How the CTAs and threads tile one head's D x D state.  A thread holds an
// R x C block (R rows, C columns).  The G = D / R threads that share its C
// columns (the row groups) are G consecutive lanes of one warp, so the
// column sums of y are warp shuffles; they are taken for TB tokens at once,
// G values, so that after the sums each lane holds one (token, column) of
// y.  A CTA of NT threads covers CT columns.
template <int D>
struct Tile {
  static constexpr int R = 4;
  static constexpr int C = D == 16 ? 2 : 4;
  static constexpr int G = D / R;
  static constexpr int TB = G / C;
  static constexpr int NT = D == 16 ? 32 : 64;
  static constexpr int CT = NT / G * C;
  static_assert(32 % G == 0 && G % C == 0 && kChunk % TB == 0 && D % CT == 0,
                "a column group lies in one warp; a chunk holds whole batches");
};

// N consecutive elements of a row in shared memory (N 2 or a multiple of 4,
// 8- or 16-byte aligned), as f32
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = x.x, out[4 * q + 1] = x.y, out[4 * q + 2] = x.z, out[4 * q + 3] = x.w;
    }
  }
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&out)[N]) {
  if constexpr (N == 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = x.x, out[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 raw = reinterpret_cast<const uint2*>(p)[q];
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      out[4 * q] = lo.x, out[4 * q + 1] = lo.y, out[4 * q + 2] = hi.x, out[4 * q + 3] = hi.y;
    }
  }
}

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

// box {cols, 1 head, kChunk tokens, 1 batch} at (d0, h, t0, b) of a (B, T, H,
// D) tensor into shared memory by the TMA engine, completing on the mbarrier
// `bar` (rows past T arrive as zeros)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int d0, int h,
                                         int t0, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(t0), "r"(b),
        "r"(bar)
      : "memory");
}

// Sum the V values p[] of each lane over its G row-group lanes (the low
// log2 G bits of the lane) in a fixed order, as a reduce-scatter: at level
// l a lane keeps the lower or upper half of what it carries (by its lane
// bit l) and adds its partner's copy of that half.  On return p[0] holds
// the sum of value flat_index(lane) (V == G: one value per lane).
template <int V, int G>
__device__ __forceinline__ void column_sums(float (&p)[V], int lane) {
  static_assert(V == G, "one value per lane after the sums");
#pragma unroll
  for (int l = 0; l < ilog2(G); ++l) {
    const bool upper = (lane >> l) & 1;
    constexpr int kMax = V / 2;
    const int half = V >> (l + 1);
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < half) {
        const float send = upper ? p[i] : p[i + half];
        const float keep = upper ? p[i + half] : p[i];
        p[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << l);
      }
    }
  }
}

template <int V, int G>
__device__ __forceinline__ int flat_index(int lane) {
  int f = 0;
#pragma unroll
  for (int l = 0; l < ilog2(G); ++l) f += ((lane >> l) & 1) * (V >> (l + 1));
  return f;
}

template <typename T, int D>
struct Stage {
  T r[kChunk][D];
  T k[kChunk][D];
  T w[kChunk][D];
  T v[kChunk][Tile<D>::CT];
};

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::NT)
rwkv6_scan_kernel(const __grid_constant__ CUtensorMap tm_r, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_w, const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ u, float* __restrict__ y, float* __restrict__ S_out,
                  int n_tokens, int H) {
  using L = Tile<D>;
  constexpr int R = L::R, C = L::C, G = L::G, TB = L::TB, CT = L::CT;
  __shared__ __align__(128) Stage<T, D> ring[kStages];
  __shared__ __align__(8) uint64_t full[kStages];  // stage s holds its chunk

  const int tid = threadIdx.x, lane = tid % 32;
  const int rg = lane % G;                                  // row group: rows rg*R ..
  const int cc = (tid / 32) * (32 / G) + lane / G;          // column group: cols cc*C ..
  const int col0 = blockIdx.x * CT, h = blockIdx.y, b = blockIdx.z;
  const int64_t tok = static_cast<int64_t>(H) * D;          // one sequence step
  const int64_t base = static_cast<int64_t>(b) * n_tokens * tok + static_cast<int64_t>(h) * D;
  const int n_chunks = (n_tokens + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // thread 0 fills stage s with chunk c: one box of kChunk rows of each of
  // r, k and w (D elements) and of v (the tile's CT columns)
  auto issue = [&](int s, int c) {
    const int t0 = c * kChunk;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, sizeof(Stage<T, D>));
    tma_load(smem_u32(&ring[s].r[0][0]), &tm_r, 0, h, t0, b, bar);
    tma_load(smem_u32(&ring[s].k[0][0]), &tm_k, 0, h, t0, b, bar);
    tma_load(smem_u32(&ring[s].w[0][0]), &tm_w, 0, h, t0, b, bar);
    tma_load(smem_u32(&ring[s].v[0][0]), &tm_v, col0, h, t0, b, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages && s < n_chunks; ++s) issue(s, s);
  }

  float ur[R];      // u of the thread's rows
  float S[R][C];    // the thread's block of the state
#pragma unroll
  for (int i = 0; i < R; ++i) {
    ur[i] = u[h * D + rg * R + i];
#pragma unroll
    for (int j = 0; j < C; ++j) S[i][j] = 0.f;
  }
  // the (token of the batch, column) of y this lane sums
  const int f = flat_index<TB * C, G>(lane);
  float* yl = y + base + static_cast<int64_t>(f / C) * tok + col0 + cc * C + f % C;

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages, t0 = c * kChunk, n = min(kChunk, n_tokens - t0);
    mbar_wait(smem_u32(&full[s]), (c / kStages) & 1);
    const Stage<T, D>& st = ring[s];
    // TB tokens from tb: the state steps, then the column sums of their y
    // (tokens from `valid` on are past the sequence's end)
    auto batch = [&](int tb, int valid) {
      float p[TB * C];
#pragma unroll
      for (int e = 0; e < TB; ++e) {
        const int t = tb + e;
        if (t >= valid) {
#pragma unroll
          for (int j = 0; j < C; ++j) p[e * C + j] = 0.f;
          continue;
        }
        float rv[R], kv[R], wv[R], vv[C];
        load_row(st.r[t] + rg * R, rv);
        load_row(st.k[t] + rg * R, kv);
        load_row(st.w[t] + rg * R, wv);
        load_row(st.v[t] + cc * C, vv);
        // this row group's share of the bonus c_t = sum_i r_i u_i k_i
        float bonus = 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) bonus = fmaf(rv[i] * ur[i], kv[i], bonus);
#pragma unroll
        for (int j = 0; j < C; ++j) p[e * C + j] = vv[j] * bonus;
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            p[e * C + j] = fmaf(rv[i], S[i][j], p[e * C + j]);
            S[i][j] = fmaf(wv[i], S[i][j], kv[i] * vv[j]);
          }
        }
      }
      column_sums<TB * C, G>(p, lane);
      if (tb + f / C < valid) yl[static_cast<int64_t>(t0 + tb) * tok] = p[0];
    };
    if (n == kChunk) {  // a whole chunk: one block of straight-line code
#pragma unroll
      for (int tb = 0; tb < kChunk; tb += TB) batch(tb, kChunk);
    } else {
      for (int tb = 0; tb < n; tb += TB) batch(tb, n);
    }
    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && c + kStages < n_chunks) issue(s, c + kStages);
  }

  if (S_out != nullptr) {
    float* out = S_out + ((static_cast<int64_t>(b) * H + h) * D + rg * R) * D + col0 + cc * C;
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) out[static_cast<int64_t>(i) * D + j] = S[i][j];
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a (B, T, H, D) tensor as dims {D, H, T, B}, in boxes of cols x 1 x kChunk x 1
template <typename T>
bool encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int n_tokens, int H,
                int D, int cols) {
  constexpr cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(n_tokens), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * es,
                                 static_cast<cuuint64_t>(H) * D * es,
                                 static_cast<cuuint64_t>(n_tokens) * H * D * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, kChunk, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
           void* S_out, int B, int n_tokens, int H, cudaStream_t stream) {
  using L = Tile<D>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap mr, mk, mw, mv;
  if (!encode_map<T>(fn, &mr, r, B, n_tokens, H, D, D) ||
      !encode_map<T>(fn, &mk, k, B, n_tokens, H, D, D) ||
      !encode_map<T>(fn, &mw, w, B, n_tokens, H, D, D) ||
      !encode_map<T>(fn, &mv, v, B, n_tokens, H, D, L::CT))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {  // shared memory first: five CTAs of ~40 KB to an SM
    cudaFuncSetAttribute(rwkv6_scan_kernel<T, D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    configured = true;
  }
  const dim3 grid(D / L::CT, H, B);
  rwkv6_scan_kernel<T, D><<<grid, L::NT, 0, stream>>>(mr, mk, mw, mv, static_cast<const float*>(u),
                                                       static_cast<float*>(y),
                                                       static_cast<float*>(S_out), n_tokens, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
               void* S_out, int B, int n_tokens, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, S_out, B, n_tokens, H, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, y, S_out, B, n_tokens, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, y, S_out, B, n_tokens, H, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v, w: contiguous (B, T, H, D) of one type (dtype 0 = float32,
// 1 = bfloat16), each 16-byte aligned; u: contiguous (H, D) float32; y:
// contiguous (B, T, H, D) float32; S_out: null, or contiguous (B, H, D, D)
// float32 for the final state.  D 16, 32 or 64.  The caller checked shapes,
// devices, contiguity and alignment and allocated y and S_out.
extern "C" int rwkv6_scan_fwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, void* y, void* S_out, int B, int T, int H, int D,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w);
  if (addr % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  switch (dtype) {
    case 0: return dispatch_d<float>(r, k, v, w, u, y, S_out, B, T, H, D, s);
    case 1: return dispatch_d<__nv_bfloat16>(r, k, v, w, u, y, S_out, B, T, H, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
