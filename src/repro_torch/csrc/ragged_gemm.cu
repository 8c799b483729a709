// Ragged (grouped) GEMM for MoE experts on Hopper:
//     out[m*tm : (m+1)*tm, :] = x[m*tm : (m+1)*tm, :] @ w[tile_expert[m]]
// x (T, D) tokens sorted by expert with T % tm == 0, w (E, D, F),
// tile_expert (T / tm,) int32, out (T, F) in x's type, fp32 accumulation.
//
// Replaces the TPU kernel ragged_gemm_pallas
// (src/repro/kernels/ragged_gemm.py). There a scalar-prefetched
// tile_expert routes the weight BlockSpec so grid step (m, n) runs one
// dense (tm x D) @ (D x tn) MXU product; the dispatch pads every expert's
// rows to a multiple of tm, so no tile mixes two experts.
//
// What bounds it here: operations at the prefill shapes (2 T D F flops
// against T D + E D F + T F elements: ~300 flops a byte at T = 20,480,
// D = 4,096, F = 6,400, above the H100's ~295 for bf16), bytes at the
// decode shapes (every expert's weights for 128 rows each). The tensor
// cores carry the bf16 instance; wgmma and TMA come later, this kernel is
// the simple, right one.
//
// Design: blocks run in no order and nothing carries between them, so one
// CTA owns one (kBM x kBN) output tile: it reads its expert from
// tile_expert[m0 / tm] (kBM divides tm, checked by the wrapper), walks D in
// kBK-deep slices staged in shared memory, and accumulates in fp32: bf16 by
// WMMA (mma.sync 16 x 16 x 16, four warps of 64 x 64 each) from a ring of
// kStages slices that cp.async fills while the tensor cores work (where
// D and F are multiples of 8 and the CTA's tile is whole; the ragged edge
// tiles load synchronously, masked), fp32 by a
// 16 x 16 thread grid of 4 x 4 register tiles on the CUDA cores (the
// instance the card tests hold to ~1e-5). The accumulator is rounded to
// the output type once, at the store. Any D and F: slices past D and
// columns past F are zero-filled on load and masked on store.
// Row and expert offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ---- bf16: tensor cores --------------------------------------------------
constexpr int kBK = 32;             // D slice staged per step

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// BM x BN output tile per CTA (BM divides tm), a WM x WN grid of warps,
// each owning (BM / WM) x (BN / WN) outputs as 16 x 16 WMMA fragments,
// STAGES D slices in the cp.async ring (the kernel also takes MINB, the
// CTAs an SM that ptxas must leave room for)
template <int BM, int BN, int WM, int WN, int STAGES>
struct Tiling {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kFM = BM / WM / 16;     // fragments a warp, rows
  static constexpr int kFN = BN / WN / 16;     // ... columns
  static constexpr int kLdA = kBK + 8;         // bf16; rows 16-byte aligned
  static constexpr int kLdB = BN + 8;
  static constexpr int kTileA = BM * kLdA;     // elements of one stage
  static constexpr int kTileB = kBK * kLdB;
  static constexpr int kSmemBytes = STAGES * (kTileA + kTileB) * 2;
  static_assert(kFM * WM * 16 == BM && kFN * WN * 16 == BN, "warp tiling");
  static_assert(kSmemBytes >= WM * WN * 256 * 4, "epilogue staging");
};

template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__(WM * WN * 32, MINB)
ragged_gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const int* __restrict__ tile_expert,
                        bf16* __restrict__ out, int d, int f, int tm,
                        int vec) {
  using L = Tiling<BM, BN, WM, WN, STAGES>;
  constexpr int kLdA = L::kLdA, kLdB = L::kLdB, kFM = L::kFM, kFN = L::kFN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);           // [STAGES][BM][kLdA]
  bf16* Bs = As + STAGES * L::kTileA;                 // [STAGES][kBK][kLdB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / WN;         // warp rows wm * kFM * 16 ..
  const int wn = warp % WN;         // warp columns wn * kFN * 16 ..
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long e = __ldg(tile_expert + m0 / tm);
  const bf16* xb = x + m0 * d;
  const bf16* wb = w + e * d * f;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // x[m0 : m0+BM, k0 : k0+kBK] and w[e, k0 : k0+kBK, n0 : n0+BN] into a
  // stage, 16 bytes a thread per copy, without waiting
  auto load_async = [&](int stage, int k0) {
    bf16* a = As + stage * L::kTileA;
    bf16* b = Bs + stage * L::kTileB;
    for (int c = tid; c < BM * kBK / 8; c += L::kThreads) {
      const int r = c / (kBK / 8);
      const int cc = (c % (kBK / 8)) * 8;
      cp_async16(a + r * kLdA + cc, xb + (long long)r * d + k0 + cc);
    }
    for (int c = tid; c < kBK * BN / 8; c += L::kThreads) {
      const int r = c / (BN / 8);
      const int cc = (c % (BN / 8)) * 8;
      cp_async16(b + r * kLdB + cc, wb + (long long)(k0 + r) * f + n0 + cc);
    }
  };
  // the same slice into stage 0, masked and zero-filled past D and F
  auto load_masked = [&](int k0) {
    for (int i = tid; i < BM * kBK; i += L::kThreads) {
      const int r = i / kBK;
      const int cc = i % kBK;
      As[r * kLdA + cc] = k0 + cc < d ? xb[(long long)r * d + k0 + cc] : zero;
    }
    for (int i = tid; i < kBK * BN; i += L::kThreads) {
      const int r = i / BN;
      const int cc = i % BN;
      Bs[r * kLdB + cc] = (k0 + r < d && n0 + cc < f)
                              ? wb[(long long)(k0 + r) * f + n0 + cc] : zero;
    }
  };
  auto compute = [&](int stage) {
    const bf16* a_st = As + stage * L::kTileA + wm * kFM * 16 * kLdA;
    const bf16* b_st = Bs + stage * L::kTileB + wn * kFN * 16;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[kFN];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        wmma::load_matrix_sync(a[i], a_st + i * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(b[j], b_st + kk * kLdB + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                     acc[i][j]);
    }
  };

  const int ktiles = (d + kBK - 1) / kBK;
  if (vec && d % kBK == 0 && n0 + BN <= f) {
    // STAGES - 1 slices in flight while one is multiplied
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < ktiles) load_async(st, st * kBK);
      cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      cp_async_wait<STAGES - 2>();   // slice kt has landed
      __syncthreads();               // ... and slice kt-1 is consumed
      const int nk = kt + STAGES - 1;
      if (nk < ktiles) load_async(nk % STAGES, nk * kBK);
      cp_async_commit();
      compute(kt % STAGES);
    }
    cp_async_wait<0>();
  } else {
    for (int k0 = 0; k0 < d; k0 += kBK) {
      load_masked(k0);
      __syncthreads();
      compute(0);
      __syncthreads();
    }
  }
  __syncthreads();

  // each fragment through the warp's own 16 x 16 staging tile (the stage
  // buffers are free now); a lane writes 8 consecutive outputs of a row
  float* cs = reinterpret_cast<float*>(smem) + warp * 256;
  const int row = lane >> 1;
  const int col0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kFM; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long grow = m0 + (wm * kFM + i) * 16 + row;
      const int gcol = n0 + (wn * kFN + j) * 16 + col0;
      bf16* o = out + grow * f + gcol;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (gcol + c < f) o[c] = __float2bfloat16(cs[row * 16 + col0 + c]);
      __syncwarp();
    }
  }
}

template <int BM, int BN, int WM, int WN, int STAGES, int MINB>
int launch_bf16(const void* x, const void* w, const int* tile_expert,
                void* out, long long t, int d, int f, int tm, int vec,
                cudaStream_t stream) {
  using L = Tiling<BM, BN, WM, WN, STAGES>;
  auto kernel = ragged_gemm_bf16_kernel<BM, BN, WM, WN, STAGES, MINB>;
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((f + BN - 1) / BN, (unsigned)(t / BM));
  kernel<<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), tile_expert,
      static_cast<bf16*>(out), d, f, tm, vec);
  return (int)cudaGetLastError();
}

// ---- fp32: CUDA cores ----------------------------------------------------
constexpr int kCM = 64;             // rows per CTA (divides tm)
constexpr int kCN = 64;
constexpr int kCK = 16;
constexpr int kCThreads = 256;      // 16 x 16, a 4 x 4 tile each

__global__ void __launch_bounds__(kCThreads)
ragged_gemm_f32_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const int* __restrict__ tile_expert,
                       float* __restrict__ out, int d, int f, int tm) {
  __shared__ float As[kCK][kCM + 4];   // As[k][m] = x[m0 + m, k0 + k]
  __shared__ float Bs[kCK][kCN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * kCM;
  const int n0 = blockIdx.x * kCN;
  const long long e = __ldg(tile_expert + m0 / tm);
  const float* xb = x + m0 * d;
  const float* wb = w + e * d * f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kCK) {
    for (int i = tid; i < kCM * kCK; i += kCThreads) {
      const int r = i / kCK;
      const int kk = i % kCK;
      As[kk][r] = k0 + kk < d ? xb[(long long)r * d + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kCK * kCN; i += kCThreads) {
      const int kk = i / kCN;
      const int cc = i % kCN;
      Bs[kk][cc] = (k0 + kk < d && n0 + cc < f)
                       ? wb[(long long)(k0 + kk) * f + n0 + cc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kCK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long grow = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gcol = n0 + tx * 4 + j;
      if (gcol < f) out[grow * f + gcol] = acc[i][j];
    }
  }
}

}  // namespace

// T % tm == 0 and tm % 128 == 0 are the wrapper's checks; vec != 0 only
// where D % 8 == 0, F % 8 == 0 and x, w are 16-byte aligned.
extern "C" int ragged_gemm_bf16(const void* x, const void* w,
                                const int* tile_expert, void* out,
                                long long t, int d, int f, int tm, int vec,
                                cudaStream_t stream) {
  // four warps of 64 x 64: fewer fragment loads a product than eight warps
  // of 32 x 64, and faster at the prefill and decode shapes (PERF.md)
  return launch_bf16<128, 128, 2, 2, 4, 2>(x, w, tile_expert, out, t, d, f,
                                           tm, vec, stream);
}

extern "C" int ragged_gemm_f32(const void* x, const void* w,
                               const int* tile_expert, void* out,
                               long long t, int d, int f, int tm, int vec,
                               cudaStream_t stream) {
  (void)vec;
  const dim3 grid((f + kCN - 1) / kCN, (unsigned)(t / kCM));
  ragged_gemm_f32_kernel<<<grid, kCThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      tile_expert, static_cast<float*>(out), d, f, tm);
  return (int)cudaGetLastError();
}
