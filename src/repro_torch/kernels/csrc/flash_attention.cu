// Blockwise online-softmax attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:30
// (_attn_kernel, launched by flash_attention_bhsd, wrapped by
// ops.py:flash_attention).  It computes what that kernel computes, for q, k,
// v of shape (B, S, H, D) in the op's own layout (no transposes):
//
//   s = (q . k) * scale            scale = D^-0.5 in f32, after the product
//   masked s = -1e30               causal: kpos <= qpos; window W: kpos > qpos - W;
//                                  keys at or past S
//   m_new = max(m, rowmax(s)), alpha = exp(m - m_new), p = exp(s - m_new)
//   p = 0 where masked             (a fully masked row of a live tile would
//                                   otherwise get exp(0) = 1)
//   l = l * alpha + rowsum(p), acc = acc * alpha + p . v
//   out = acc / max(l, 1e-30)      rounded once to the input type
//
// kv tiles that lie wholly outside the causal or window band of a q tile are
// skipped, as the TPU kernel skips them with pl.when.
//
// Bound (bf16, causal; q, k, v read once, out written once): at
// StableLM-2-1.6B's prefill shape (B 4, S 1024, H 32, D 64) 64 MiB, 0.0200 ms
// at 3.35 TB/s, against 17.2 GFLOP, 0.0174 ms at the 989 TFLOP/s bf16
// tensor-core rate; at RecurrentGemma-9B's (B 4, S 1024, H 16, D 256, window
// 2048) 0.0401 ms of bytes against 0.0348 ms of operations.  Both are bytes
// bound, with the operations close behind: the tensor cores and a pipeline
// that keeps them fed are what reach the bound.
//
// Two routes, chosen by dtype:
//
// bfloat16 (the serving path): flash_wgmma_kernel, persistent, one CTA of
// three warpgroups per SM.
//   - Work: a q tile of 128 rows of one (head, batch).  A CTA takes units of
//     two q tiles, j and n_qt - 1 - j of one (head, batch), whose causal kv
//     tiles add up to the same count for every j, so the CTAs' loads come
//     out even; the heavier tile first.  Units are numbered head-major, so
//     the CTAs at work at one time read the kv tiles of a few heads from L2.
//   - Warpgroup 2 is the producer: it gives up its registers (setmaxnreg) and
//     one thread issues TMA loads: each work item's q rows, then every live
//     kv tile's K and V into a ring of stages, each with a "full" mbarrier
//     that counts the bytes in and an "empty" one that the consumers' warps
//     arrive on.  The ring runs on across work items, and the next item's
//     first kv tiles load while the consumers finish the last one.  Tensor
//     maps over dims {D, H, S, B} read the (B, S, H, D) tensors in place, in
//     boxes of 64 columns (128 bytes, 128-byte swizzle): D 256 is four boxes
//     per tile.  Rows past S come in as zeros.
//   - Warpgroups 0 and 1 each own 64 q rows of the item and take the
//     registers (setmaxnreg 240).  S = Q.K^T is wgmma m64nBKk16 with both
//     operands K-major in shared memory; the f32 scores stay in registers,
//     and the online softmax runs there, a row's four lanes combining with
//     shuffles.  P is packed to bf16 straight from the score fragment, which
//     is wgmma's A register fragment, and O += P.V is wgmma m64nDk16 with A
//     in registers and V as an MN-major B (D contiguous) in shared memory.
//     Only tiles on the diagonal, the window's edge or past S compute a
//     per-element mask; a tile wholly masked for one warpgroup's rows is
//     skipped by that warpgroup alone.
//   - The output is normalised, rounded to bf16 into the warpgroup's own
//     (no longer needed) q rows of shared memory, and written by a TMA store,
//     which clips the rows past S; the q rows go back to the producer once
//     the store has read them.
//   - The one numeric change from the f32 route: P is rounded to bf16 for the
//     second product.  l is summed from the f32 p, as the TPU kernel sums it.
//   - Deterministic: no atomics, no split over kv, and a fixed assignment of
//     work to CTAs; every launch on the same inputs gives the same bits.
//   Tiles (Bf16Tiles): q 128 rows; D 64: kv 128 rows, 3 stages (112 KiB);
//   D 128: kv 128, 2 stages (160 KiB); D 256: kv 64, 2 stages (192 KiB), O
//   then takes 128 f32 registers per consumer thread.
//
// float32 (the parity checks): flash_simt_kernel, f32 FMAs on the CUDA cores
// (the tensor cores would round to TF32).  One CTA of 256 threads per (q tile
// of 64 rows, head, batch) stages its q tile and each kv tile of kv_tile rows
// (32 or 64) in shared memory, rows padded by one word; each thread owns a
// 4 x (kv_tile/16) block of the scores and a 4 x (D/16) block of the output
// accumulator; the running max, sum and rescale factor per row live in
// shared memory, four neighbouring lanes per row combining with shuffles.
// kv_tile applies to this route only.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled, found
// through the runtime's driver entry point, so the library needs no -lcuda.
//
// C entry point (bound with ctypes): flash_attention_fwd returns an error
// code after the launch, 0 on success.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool allowed(int qpos, int kpos, int S, int causal, int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// ------------------------------------------------------------ float32 route
constexpr int kSimtThreads = 256;
constexpr int kSimtBQ = 64;

template <int D, int BK>
constexpr size_t simt_smem_floats() {
  return static_cast<size_t>(kSimtBQ) * (D + 1)    // q tile
         + static_cast<size_t>(BK) * (D + 1)       // k tile
         + static_cast<size_t>(BK) * D             // v tile
         + static_cast<size_t>(kSimtBQ) * (BK + 1)  // scores, then p
         + 3 * kSimtBQ;                            // m, l, alpha per row
}

template <int D, int BK>
__global__ void __launch_bounds__(kSimtThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int S, int H, int causal,
                  int window, float scale) {
  constexpr int QS = D + 1;   // padded row stride of the q and k tiles
  constexpr int SS = BK + 1;  // padded row stride of the score tile
  constexpr int CS = BK / 16; // score columns per thread
  constexpr int CO = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kSimtBQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ss = Vs + BK * D;
  float* m_s = Ss + kSimtBQ * SS;
  float* l_s = m_s + kSimtBQ;
  float* a_s = l_s + kSimtBQ;

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * kSimtBQ;
  const int64_t row_stride = static_cast<int64_t>(H) * D;  // one sequence step
  const int64_t base = static_cast<int64_t>(blockIdx.z) * S * row_stride +
                       static_cast<int64_t>(blockIdx.y) * D;

  for (int idx = tid; idx < kSimtBQ * D; idx += kSimtThreads) {
    const int r = idx / D, d = idx % D, s = q_start + r;
    Qs[r * QS + d] = s < S ? q[base + s * row_stride + d] : 0.f;
  }
  if (tid < kSimtBQ) {
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
    if (causal) live = k_start <= q_start + kSimtBQ - 1;
    if (window > 0) live = live && (k_start + BK - 1 > q_start - window);
    if (!live) continue;

    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += kSimtThreads) {
      const int r = idx / D, d = idx % D, s = k_start + r;
      float kx = 0.f, vx = 0.f;
      if (s < S) {
        kx = k[base + s * row_stride + d];
        vx = v[base + s * row_stride + d];
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
      for (int c = 0; c < CO; ++c) o[base + s * row_stride + tx + 16 * c] = acc[i][c] / l;
    }
  }
}

template <int D, int BK>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = simt_smem_floats<D, BK>() * sizeof(float);
  auto kernel = flash_simt_kernel<D, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kSimtBQ - 1) / kSimtBQ, H, B);
  kernel<<<grid, kSimtThreads, bytes, stream>>>(static_cast<const float*>(q),
                                                static_cast<const float*>(k),
                                                static_cast<const float*>(v),
                                                static_cast<float*>(o), S, H, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int BK>
int simt_dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                    int D, int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_simt<64, BK>(q, k, v, o, B, S, H, causal, window, scale, stream);
    case 128: return launch_simt<128, BK>(q, k, v, o, B, S, H, causal, window, scale, stream);
    case 256: return launch_simt<256, BK>(q, k, v, o, B, S, H, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ----------------------------------------------------------- bfloat16 route
// kv tile rows and ring stages per head dim (mirrored by ops.py:BF16_TILES)
template <int D> struct Bf16Tiles;
template <> struct Bf16Tiles<64> { static constexpr int kBK = 128, kStages = 3; };
template <> struct Bf16Tiles<128> { static constexpr int kBK = 128, kStages = 2; };
template <> struct Bf16Tiles<256> { static constexpr int kBK = 64, kStages = 2; };

constexpr int kBQ = 128;             // q rows per CTA: two consumer warpgroups of 64
constexpr int kWgRows = 64;
constexpr int kWgmmaThreads = 384;   // two consumer warpgroups + one producer warpgroup
constexpr int kBoxCols = 64;         // one 128-byte swizzle atom of bf16
constexpr int kRowBytes = 128;
constexpr int kConsumerWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kSpinLimit = 1u << 28;  // a lost barrier phase traps, never hangs

template <int D>
struct Bf16Smem {
  static constexpr int kBK = Bf16Tiles<D>::kBK, kStages = Bf16Tiles<D>::kStages;
  static constexpr uint32_t kQBytes = kBQ * D * 2;
  static constexpr uint32_t kKVBytes = kBK * D * 2;  // one stage of K (or of V)
  static constexpr uint32_t kK = kQBytes;
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBars = kV + kStages * kKVBytes;  // the mbarriers
  static constexpr uint32_t kBytes = kBars + (2 * kStages + 4) * 8 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over a CTA's shared memory");
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
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

// box {64 columns, 1 head, rows, 1 batch} at (d0, h, s0, b) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int d0, int h,
                                         int s0, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(h), "r"(s0), "r"(b),
        "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int d0, int h,
                                          int s0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(d0), "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (atoms 1024-byte aligned)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q . K^T for one warpgroup's 64 rows and a kv tile, 16 columns of D per
// wgmma, both operands K-major in shared memory
template <int D, int BK>
__device__ __forceinline__ void qk_tile(float (&sc)[BK / 2], uint32_t sQw, uint32_t sKs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_atom = (kk % 4) * 32;
    wgmma_ss(sc, smem_desc(sQw + (kk / 4) * (kBQ * kRowBytes) + in_atom, 16, 1024),
             smem_desc(sKs + (kk / 4) * (BK * kRowBytes) + in_atom, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
}

// O += P . V with P as wgmma's A register fragment and V an MN-major B
template <int D, int BK>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const uint32_t (&a)[BK / 16][4],
                                        uint32_t sVs) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, a[kk], smem_desc(sVs + kk * (16 * kRowBytes), BK * kRowBytes, 1024));
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(o);
}

// The online-softmax step of one kv tile for this thread's two rows: scales
// and masks the scores, updates m and l, returns O's rescale factor per row
// in alpha and P, rounded to bf16, as wgmma's A fragment (the score
// fragment's layout is the A fragment's).  A per-element mask only where the
// tile crosses the diagonal, the window's edge or S.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], uint32_t (&a)[BK / 16][4],
                                             float (&alpha)[2], float (&m)[2], float (&l)[2],
                                             bool edge, const int (&qpos)[2], int k0, int col,
                                             int S, int causal, int window, float scale) {
#pragma unroll
  for (int x = 0; x < BK / 2; ++x) sc[x] *= scale;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        if (!allowed(qpos[x / 2], k0 + 8 * j + col + x % 2, S, causal, window))
          sc[4 * j + x] = kNegInf;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
    // p = exp(s - m_new); a masked s (-1e30) gives exactly 0, and a row with
    // no allowed key yet (m_new = -1e30) gets p = 0 everywhere
    const float shift = m_new == kNegInf ? __uint_as_float(0xff800000u) : -m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * r + e];
        x = exp2_approx(fmaf(x, kLog2e, shift));
        sum += x;  // l sums the f32 p, as the TPU kernel does
      }
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[4 * j + x] *= alpha[x / 2];
}

// Work items: a q tile of kBQ rows of one (head, batch).  A unit pairs q
// tile j with q tile n_qt - 1 - j of one (head, batch): under a causal mask
// their live kv tiles add up to the same count for every j, so units cost
// alike.  CTA c of G takes units c, c + G, c + 2G, ..., and of each unit the
// heavier q tile first, whose kv tiles include the lighter one's.  Units are
// numbered head-major, so the CTAs at work at one time share the kv tiles of
// a few heads in L2.  item_at gives the CTA's item in slot `slot`: 1 and the
// item, 2 for an empty slot (the middle tile of an odd n_qt stands alone),
// 0 past the end.
struct Item {
  int h, b, q0;
};

__device__ __forceinline__ int item_at(int slot, int S, int H, int B, Item& it) {
  const int n_qt = (S + kBQ - 1) / kBQ, n_half = (n_qt + 1) / 2;
  const int u = (slot / 2) * static_cast<int>(gridDim.x) + static_cast<int>(blockIdx.x);
  if (u >= n_half * H * B) return 0;
  const int j = u % n_half, hb = u / n_half;
  const int qt = slot % 2 ? j : n_qt - 1 - j;
  if (slot % 2 && qt == n_qt - 1 - j) return 2;
  it = {hb % H, hb / H, qt * kBQ};
  return 1;
}

// the live kv tiles lo .. hi for rows q0 .. q0 + rows - 1, a contiguous run
// (the TPU kernel's skip)
template <int BK>
__device__ __forceinline__ void kv_run(int q0, int rows, int S, int causal, int window, int& lo,
                                       int& hi) {
  hi = (S + BK - 1) / BK - 1;
  if (causal) hi = min(hi, (q0 + rows - 1) / BK);
  lo = 0;
  if (window > 0) {
    const int x = q0 - window - BK + 1;  // live: kt * BK > x
    if (x >= 0) lo = min(x / BK + 1, hi);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, int B, int S, int H, int causal,
                   int window, float scale) {
  using L = Bf16Smem<D>;
  constexpr int BK = L::kBK, kStages = L::kStages, kChunks = D / kBoxCols;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::kK, sV = base + L::kV, sBar = base + L::kBars;
  // mbarriers: full and empty per ring stage; q_full and q_empty per warpgroup
  auto full = [&](uint32_t pos) { return sBar + 8u * (pos % kStages); };
  auto empty = [&](uint32_t pos) { return sBar + 8u * (kStages + pos % kStages); };
  auto q_full = [&](int w) { return sBar + 8u * (2 * kStages + w); };
  auto q_empty = [&](int w) { return sBar + 8u * (2 * kStages + 2 + w); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(q_full(w), 1);
      mbar_init(q_empty(w), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform by construction (a broadcast)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    // ---- producer: one thread keeps the TMA loads in flight.  The ring
    // position `pos` runs on across work items, as in the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x != 2 * 128) return;
    uint32_t pos = 0;
    int k = 0;  // items taken so far
    Item it;
    for (int slot = 0, got; (got = item_at(slot, S, H, B, it)) != 0; ++slot) {
      if (got == 2) continue;
      int lo, hi;
      kv_run<BK>(it.q0, kBQ, S, causal, window, lo, hi);
      const int n = hi - lo + 1;
      auto load_kv = [&](int j) {
        const uint32_t p = pos + j;
        if (p >= kStages) mbar_wait(empty(p), (p / kStages - 1) & 1);
        mbar_expect_tx(full(p), 2 * L::kKVBytes);
        const uint32_t off = (p % kStages) * L::kKVBytes;
        for (int c = 0; c < kChunks; ++c) {
          tma_load(sK + off + c * (BK * kRowBytes), &tm_k, c * kBoxCols, it.h, (lo + j) * BK,
                   it.b, full(p));
          tma_load(sV + off + c * (BK * kRowBytes), &tm_v, c * kBoxCols, it.h, (lo + j) * BK,
                   it.b, full(p));
        }
      };
      // the first kv tiles go out while the warpgroups finish the last item
      const int pre = min(n, kStages);
      for (int j = 0; j < pre; ++j) load_kv(j);
      for (int w = 0; w < 2; ++w) {
        if (k > 0) mbar_wait(q_empty(w), (k - 1) & 1);
        const int qw0 = it.q0 + w * kWgRows;
        if (qw0 >= S) {  // rows wholly past S (S <= 64): no load, the phase just completes
          mbar_arrive(q_full(w));
          continue;
        }
        mbar_expect_tx(q_full(w), L::kQBytes / 2);
        for (int c = 0; c < kChunks; ++c)
          tma_load(sQ + c * (kBQ * kRowBytes) + w * (kWgRows * kRowBytes), &tm_q, c * kBoxCols,
                   it.h, qw0, it.b, q_full(w));
      }
      for (int j = pre; j < n; ++j) load_kv(j);
      pos += n;
      ++k;
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows qw0 .. qw0 + 63 of each item
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int cw = wg;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row = warp * 16 + lane / 4;  // this thread's rows: row, row + 8
  const int col = 2 * (lane % 4);        // and columns 8j + col + {0, 1}
  const uint32_t sQw = sQ + cw * (kWgRows * kRowBytes);
  uint32_t pos = 0;
  int k = 0;  // items taken so far
  Item it;
  for (int slot = 0, got; (got = item_at(slot, S, H, B, it)) != 0; ++slot) {
    if (got == 2) continue;
    const int qw0 = it.q0 + cw * kWgRows;
    const int qpos[2] = {qw0 + row, qw0 + row + 8};
    int lo, hi, wlo, whi;
    kv_run<BK>(it.q0, kBQ, S, causal, window, lo, hi);
    // this warpgroup's own run; the item's other tiles are wholly masked
    // for its rows, and it only hands their stages back
    kv_run<BK>(qw0, kWgRows, S, causal, window, wlo, whi);
    if (qw0 >= S) whi = wlo - 1;

    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only

    mbar_wait(q_full(cw), k & 1);
    for (int kt = lo; kt <= hi; ++kt, ++pos) {
      mbar_wait(full(pos), (pos / kStages) & 1);
      if (kt >= wlo && kt <= whi) {
        const uint32_t off = (pos % kStages) * L::kKVBytes;
        const int k0 = kt * BK;
        float sc[BK / 2];
        uint32_t a[BK / 16][4];
        qk_tile<D, BK>(sc, sQw, sK + off);
        const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > qw0) ||
                          (window > 0 && k0 <= qw0 + kWgRows - 1 - window);
        float alpha[2];
        softmax_tile<BK>(sc, a, alpha, m, l, edge, qpos, k0, col, S, causal, window, scale);
        rescale<D>(o, alpha);
        pv_tile<D, BK>(o, a, sV + off);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(pos));  // this warp is done with the stage
    }

    // out = o / max(l, 1e-30) in bf16, into this warpgroup's q rows (read by
    // no one any more), then one TMA store per 64-column box; the q rows are
    // handed back once the store has read them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row + 8 * r;
        const uint32_t addr = sQw + (j / 8) * (kBQ * kRowBytes) + rr * kRowBytes +
                              (((j % 8) ^ (rr % 8)) * 16) + (lane % 4) * 4;
        const uint32_t v = pack_bf16(o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
    if (t == 0) {
      if (qw0 < S) {
        for (int c = 0; c < kChunks; ++c)
          tma_store(&tm_o, sQw + c * (kBQ * kRowBytes), c * kBoxCols, it.h, qw0, it.b);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
      mbar_arrive(q_empty(cw));
    }
    ++k;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

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

// a (B, S, H, D) bf16 tensor as dims {D, H, S, B}, in boxes of 64 columns x rows
bool encode_map(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
                int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                 int causal, int window, float scale, cudaStream_t stream) {
  using L = Bf16Smem<D>;
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap mq, mk, mv, mo;
  if (!encode_map(fn, &mq, q, B, S, H, D, kWgRows) || !encode_map(fn, &mk, k, B, S, H, D, L::kBK) ||
      !encode_map(fn, &mv, v, B, S, H, D, L::kBK) || !encode_map(fn, &mo, o, B, S, H, D, kWgRows))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent: one CTA per SM walks the work items
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_units = ((S + kBQ - 1) / kBQ + 1) / 2 * H * B;
  kernel<<<min(n_units, sms), kWgmmaThreads, L::kBytes, stream>>>(mq, mk, mv, mo, B, S, H, causal,
                                                                  window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (B, S, H, D) of one type; dtype 0 = float32 (the
// SIMT route, kv_tile 32 or 64), 1 = bfloat16 (the wgmma route, which picks
// its own tiles by D; q, k, v, o 16-byte aligned); window <= 0 means none;
// D 64, 128 or 256.  The caller checked shapes, devices and contiguity and
// allocated o.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int H, int D, int causal, int window, int kv_tile,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (kv_tile) {
      case 32: return simt_dispatch_d<32>(q, k, v, o, B, S, H, D, causal, window, scale, st);
      case 64: return simt_dispatch_d<64>(q, k, v, o, B, S, H, D, causal, window, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_wgmma<64>(q, k, v, o, B, S, H, causal, window, scale, st);
      case 128: return launch_wgmma<128>(q, k, v, o, B, S, H, causal, window, scale, st);
      case 256: return launch_wgmma<256>(q, k, v, o, B, S, H, causal, window, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
