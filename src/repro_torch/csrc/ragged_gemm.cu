// Ragged (grouped) GEMM for MoE experts on Hopper:
//     out[m*tm : (m+1)*tm, :] = x[m*tm : (m+1)*tm, :] @ w[tile_expert[m]]
// x (T, D) tokens sorted by expert with T % tm == 0, w (E, D, F),
// tile_expert (T / tm,) int32, out (T, F) in x's type, fp32 accumulation.
// With trans_w (the backward's dX = dY W^T) the same w is read in place
// as (E, F, D): x is dY (T, F) and out (T, D). Below, the product's depth
// K is D forward and F with trans_w, its width N the other one.
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
// decode shapes (every expert's weights for 128 rows each).
//
// Three instances, chosen by the wrapper from dtype, shape and alignment
// alone (kernels/ragged_gemm.ragged_instance); each is one CTA per output
// tile, reads its expert from tile_expert[m0 / tm] (the tile's rows lie in
// one tm-row tile: tm % 128 == 0, checked by the wrapper) and walks D
// itself. Nothing carries between CTAs, no atomics: deterministic. Row
// and expert offsets are 64-bit.
//
// - bf16, D % 8 == 0, F % 8 == 0, x and w 16-byte aligned
//   (ragged_gemm_wgmma_kernel; the main path): a 128 x 256 output tile.
//   One thread of a producer warpgroup issues TMA loads into a ring of 4
//   stages of 64 D rows (mbarriers "full" and "empty"): x through a 2-D
//   map over (T, D), K-major, one (128 x 64) box; w through a 3-D map
//   over (E, D, F), MN-major (F contiguous), four (64 D x 64 F) boxes at
//   the tile's expert; both 128-byte swizzled. Rows past D and columns
//   past F read as zero (TMA's fill), so any D and F that TMA can stride
//   are exact; a box wholly past F is not loaded, and the columns it
//   would feed are not stored. Two consumer warpgroups own 64 rows each:
//   four wgmma m64n256k16 a stage from shared memory (A K-major, B
//   MN-major through the transpose bit), the fp32 accumulator (128
//   registers a thread) in registers, one wgmma group in flight while the
//   previous stage is handed back, no __syncthreads in the loop. The
//   producer warpgroup gives its registers to the consumers (setmaxnreg
//   40 / 232). Epilogue: the accumulator is rounded to bf16 in registers,
//   staged in the (now idle) ring, and written as whole 16-byte vectors,
//   a warp a 512-byte row. Tiles are rastered in groups of 8 row tiles,
//   rows fastest, so the CTAs in flight share each weight column block
//   through L2; at decode (one row tile an expert) every expert's weights
//   stream from memory once.
//   The dX instance (trans_w) reads W^T in place: element (k = f, n = d)
//   of the product's B is w[e][d][f], contiguous along K, which is
//   wgmma's K-major B, no transpose bit. One 3-D box a stage over
//   (E, D, F): 64 F (128 bytes, swizzled) x 256 D rows, the same 32 KB as
//   the forward's four boxes; A is dY (T, F), K-major; TMA's fill reads
//   F past its end and D rows past theirs as zero, and the columns past
//   D are not stored. Nothing copies W.
// - bf16, any other D, F or alignment (ragged_gemm_bf16_kernel; the card
//   tests' D = 100): WMMA mma.sync 16 x 16 x 16 on a 128 x 128 tile, four
//   warps of 64 x 64, K in masked 32-deep slices through shared memory.
// - fp32 (ragged_gemm_f32_kernel; the fp32 smoke configuration and the
//   1e-5 card tests): a 16 x 16 thread grid of 4 x 4 register tiles on
//   the CUDA cores, 64 x 64 a CTA.
//   Both read w transposed in place where trans_w is set: their slice
//   loads take w[e][n][k] for B's (k, n), walking k fastest.
// Each rounds its fp32 accumulator to the output type once, at the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

// ---- bf16: wgmma from a TMA ring ------------------------------------------

namespace wg {
constexpr int kBM = 128;                  // rows a CTA: 2 warpgroups of 64
constexpr int kBN = 256;                  // columns a CTA: m64n256k16
constexpr int kBK = 64;                   // D rows a stage: 128 B of bf16
constexpr int kBoxN = 64;                 // F columns a w box: 128 B
constexpr int kStages = 4;
constexpr int kGroupM = 8;                // row tiles a raster group
constexpr int kThreads = 3 * 128;         // 2 consumer + 1 producer WG
constexpr int kABytes = kBM * kBK * 2;                 // 16 KB
constexpr int kBoxBytes = kBK * kBoxN * 2;             // 8 KB
constexpr int kBBytes = kBN / kBoxN * kBoxBytes;       // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;         // 48 KB
constexpr int kOutLd = kBN + 8;           // bf16 a staged output row
constexpr int kSmem = kStages * kStageBytes + 1024;    // + 1024 alignment
static_assert(2 * 64 * kOutLd * 2 <= kStages * kStageBytes, "staging");
}  // namespace wg

// depth: the product's K (D, or F with kTransW); width: its N, the
// output's columns (F, or D)
template <bool kTransW>
__global__ void __launch_bounds__(wg::kThreads, 1)
ragged_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xm,
                         const __grid_constant__ CUtensorMap wm,
                         const int* __restrict__ tile_expert,
                         bf16* __restrict__ out, int depth, int width,
                         int tm, int m_tiles, int n_tiles) {
  using namespace wg;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // groups of kGroupM row tiles, all their column tiles, rows fastest
  const int per_group = kGroupM * n_tiles;
  const int first_m = blockIdx.x / per_group * kGroupM;
  const int gm = min(kGroupM, m_tiles - first_m);
  const int within = blockIdx.x % per_group;
  const long long m0 = (long long)(first_m + within % gm) * kBM;
  const int n0 = within / gm * kBN;
  const int expert = __ldg(tile_expert + m0 / tm);
  const int k_steps = (depth + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);    // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread keeps the ring full, the others only
    // hand their registers to the consumers
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      hopper::prefetch_tensor_map(&xm);
      hopper::prefetch_tensor_map(&wm);
      // forward: the F boxes of the tile that start before F's end; dX:
      // one box of 256 D rows (rows past D count, read as zero)
      const int boxes =
          kTransW ? 1 : min(kBN / kBoxN, (width - n0 + kBoxN - 1) / kBoxN);
      const uint32_t bytes = kABytes + (kTransW ? kBBytes
                                                : boxes * kBoxBytes);
      int stage = 0;
      uint32_t phase = 0;
      for (int k = 0; k < k_steps; ++k) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage], bytes);
        unsigned char* st = smem + stage * kStageBytes;
        hopper::tma_load_2d(st, &xm, &full[stage], k * kBK, (int)m0);
        if (kTransW)
          hopper::tma_load_3d(st + kABytes, &wm, &full[stage], k * kBK, n0,
                              expert);
        else
          for (int j = 0; j < boxes; ++j)
            hopper::tma_load_3d(st + kABytes + j * kBoxBytes, &wm,
                                &full[stage], n0 + j * kBoxN, k * kBK,
                                expert);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // consumer warpgroups: wg owns rows 64 wg .. 64 wg + 63 of the tile;
    // acc[4 j + 2 h + c] is row 16 (warp % 4) + lane / 4 + 8 h, column
    // 8 j + 2 (lane % 4) + c of the warpgroup's 64 x 256
    hopper::setmaxnreg_inc<232>();
    const int wgi = warp >> 2;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

    const uint32_t base = hopper::smem_u32(smem);
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int k = 0; k < k_steps; ++k) {
      hopper::mbar_wait(&full[stage], phase);
      const uint32_t a = base + stage * kStageBytes + wgi * 64 * 128;
      const uint32_t b = base + stage * kStageBytes + kABytes;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: 128-byte rows, 8-row groups 1024 B apart, the k16 step 32 B
        // into the row. B forward: 8 D rows of 128 B (64 columns) an
        // atom, the next 8 D rows 1024 B on (SBO), the next 64 columns a
        // box on (LBO), the k16 step 16 D rows on. B for dX: K-major as A
        // is, 256 D rows of 64 F
        const uint64_t da = hopper::smem_desc(a + kk * 32, 16, 1024, 128);
        if (kTransW) {
          const uint64_t db = hopper::smem_desc(b + kk * 32, 16, 1024, 128);
          hopper::WgmmaBf16SS<kBN, 0>::mma(acc, da, db, 1);
        } else {
          const uint64_t db =
              hopper::smem_desc(b + kk * 16 * 128, kBoxBytes, 1024, 128);
          hopper::WgmmaBf16SS<kBN, 1>::mma(acc, da, db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();            // step k - 1's products are done
      hopper::fence_regs(acc);
      if (k > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) { stage = 0; phase ^= 1; }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // epilogue: both warpgroups are past their last wgmma (and every TMA
    // load has landed), so the ring holds the staged bf16 rows
    hopper::named_barrier_sync(1, 256);
    bf16* stg = reinterpret_cast<bf16*>(smem) + wgi * 64 * kOutLd;
    const int r0 = (warp & 3) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(stg + (r0 + 8 * h) * kOutLd + 8 * j +
                                     c0) =
            hopper::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
    hopper::named_barrier_sync(2 + wgi, 128);
    const int cols = min(kBN, width - n0);
    const int c = lane * 8;
    if (c < cols) {
      bf16* dst = out + (m0 + wgi * 64) * width + n0 + c;
      for (int r = warp & 3; r < 64; r += 4)
        *reinterpret_cast<uint4*>(dst + (long long)r * width) =
            *reinterpret_cast<const uint4*>(stg + r * kOutLd + c);
    }
  }
}

template <bool kTransW>
int launch_wgmma(const void* x, const void* w, const int* tile_expert,
                 void* out, long long t, int d, int f, int tm, int e,
                 cudaStream_t stream) {
  using namespace wg;
  const int depth = kTransW ? f : d, width = kTransW ? d : f;
  CUtensorMap m_x, m_w;
  const cuuint64_t xdims[2] = {(cuuint64_t)depth, (cuuint64_t)t};
  const cuuint64_t xstrides[1] = {(cuuint64_t)depth * 2};
  const cuuint32_t xbox[2] = {kBK, kBM};
  int rc = hopper::make_tensor_map(&m_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                   x, xdims, xstrides, xbox,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const cuuint64_t wdims[3] = {(cuuint64_t)f, (cuuint64_t)d, (cuuint64_t)e};
  const cuuint64_t wstrides[2] = {(cuuint64_t)f * 2,
                                  (cuuint64_t)d * f * 2};
  // forward: 64 F x 64 D rows (four a stage); dX: 64 F x 256 D rows
  const cuuint32_t wbox[3] = {kBoxN, kTransW ? (cuuint32_t)kBN : kBK, 1};
  rc = hopper::make_tensor_map(&m_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w,
                               wdims, wstrides, wbox,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ragged_gemm_wgmma_kernel<kTransW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const long long m_tiles = t / kBM;
  const long long n_tiles = (width + kBN - 1) / kBN;
  if (m_tiles * n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ragged_gemm_wgmma_kernel<kTransW>
      <<<(unsigned)(m_tiles * n_tiles), kThreads, kSmem, stream>>>(
          m_x, m_w, tile_expert, static_cast<bf16*>(out), depth, width, tm,
          (int)m_tiles, (int)n_tiles);
  return (int)cudaGetLastError();
}

// ---- bf16, other shapes: WMMA ---------------------------------------------

namespace mma16 {
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kWM = 2, kWN = 2;           // warps: 64 x 64 outputs each
constexpr int kThreads = kWM * kWN * 32;
constexpr int kFM = kBM / kWM / 16;       // fragments a warp, rows
constexpr int kFN = kBN / kWN / 16;       // ... columns
constexpr int kLdA = kBK + 8;             // bf16; rows 16-byte aligned
constexpr int kLdB = kBN + 8;
constexpr int kSmemBytes = (kBM * kLdA + kBK * kLdB) * 2;
static_assert(kSmemBytes >= kWM * kWN * 256 * 4, "epilogue staging");
}  // namespace mma16

__global__ void __launch_bounds__(mma16::kThreads, 2)
ragged_gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const int* __restrict__ tile_expert,
                        bf16* __restrict__ out, int depth, int width, int tm,
                        int trans_w) {
  using namespace mma16;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* As = reinterpret_cast<bf16*>(smem);           // [kBM][kLdA]
  bf16* Bs = As + kBM * kLdA;                         // [kBK][kLdB]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp / kWN;        // warp rows wm * kFM * 16 ..
  const int wn = warp % kWN;        // warp columns wn * kFN * 16 ..
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const long long e = __ldg(tile_expert + m0 / tm);
  const bf16* xb = x + m0 * depth;
  const bf16* wb = w + e * depth * width;
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFM][kFN];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < depth; k0 += kBK) {
    // x[m0 : m0+kBM, k0 : k0+kBK] and B's (k0 : k0+kBK, n0 : n0+kBN):
    // w[e, k, n], or w[e, n, k] with trans_w (read along k); zero past
    // the depth and the width
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int cc = i % kBK;
      As[r * kLdA + cc] =
          k0 + cc < depth ? xb[(long long)r * depth + k0 + cc] : zero;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = trans_w ? i % kBK : i / kBN;
      const int cc = trans_w ? i / kBK : i % kBN;
      const bool in = k0 + r < depth && n0 + cc < width;
      const long long at = trans_w
          ? (long long)(n0 + cc) * depth + k0 + r
          : (long long)(k0 + r) * width + n0 + cc;
      Bs[r * kLdB + cc] = in ? wb[at] : zero;
    }
    __syncthreads();
    const bf16* a_st = As + wm * kFM * 16 * kLdA;
    const bf16* b_st = Bs + wn * kFN * 16;
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
    __syncthreads();
  }

  // each fragment through the warp's own 16 x 16 staging tile (the slice
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
      bf16* o = out + grow * width + gcol;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (gcol + c < width)
          o[c] = __float2bfloat16(cs[row * 16 + col0 + c]);
      __syncwarp();
    }
  }
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
                       float* __restrict__ out, int depth, int width, int tm,
                       int trans_w) {
  __shared__ float As[kCK][kCM + 4];   // As[k][m] = x[m0 + m, k0 + k]
  __shared__ float Bs[kCK][kCN + 4];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long m0 = (long long)blockIdx.y * kCM;
  const int n0 = blockIdx.x * kCN;
  const long long e = __ldg(tile_expert + m0 / tm);
  const float* xb = x + m0 * depth;
  const float* wb = w + e * depth * width;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += kCK) {
    for (int i = tid; i < kCM * kCK; i += kCThreads) {
      const int r = i / kCK;
      const int kk = i % kCK;
      As[kk][r] = k0 + kk < depth ? xb[(long long)r * depth + k0 + kk] : 0.f;
    }
    for (int i = tid; i < kCK * kCN; i += kCThreads) {
      const int kk = trans_w ? i % kCK : i / kCN;
      const int cc = trans_w ? i / kCK : i % kCN;
      const bool in = k0 + kk < depth && n0 + cc < width;
      const long long at = trans_w
          ? (long long)(n0 + cc) * depth + k0 + kk
          : (long long)(k0 + kk) * width + n0 + cc;
      Bs[kk][cc] = in ? wb[at] : 0.f;
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
      if (gcol < width) out[grow * width + gcol] = acc[i][j];
    }
  }
}

}  // namespace

// Every entry takes (x, w, tile_expert, out, T, D, F, tm, E, trans_w,
// stream), w always (E, D, F): x (T, D) and out (T, F), or with trans_w x
// (T, F) and out (T, D). Each returns cudaGetLastError() after the launch
// (0 on success; the wgmma instance returns 1000 +
// cuTensorMapEncodeTiled's result if a map cannot be encoded). The
// wrapper's checks: T % tm == 0, tm % 128 == 0, tile_expert (T / tm,)
// with ids in [0, E), all arrays contiguous on the current device; for
// ragged_gemm_bf16_wgmma also D % 8 == 0, F % 8 == 0 and x, w 16-byte
// aligned.
extern "C" int ragged_gemm_bf16_wgmma(const void* x, const void* w,
                                      const int* tile_expert, void* out,
                                      long long t, int d, int f, int tm,
                                      int e, int trans_w,
                                      cudaStream_t stream) {
  if (d <= 0 || f <= 0 || d % 8 || f % 8 || e <= 0)
    return (int)cudaErrorInvalidValue;
  return trans_w
      ? launch_wgmma<true>(x, w, tile_expert, out, t, d, f, tm, e, stream)
      : launch_wgmma<false>(x, w, tile_expert, out, t, d, f, tm, e, stream);
}

extern "C" int ragged_gemm_bf16(const void* x, const void* w,
                                const int* tile_expert, void* out,
                                long long t, int d, int f, int tm, int e,
                                int trans_w, cudaStream_t stream) {
  (void)e;
  if (t / mma16::kBM > 65535) return (int)cudaErrorInvalidValue;
  const int depth = trans_w ? f : d, width = trans_w ? d : f;
  const dim3 grid((width + mma16::kBN - 1) / mma16::kBN,
                  (unsigned)(t / mma16::kBM));
  ragged_gemm_bf16_kernel<<<grid, mma16::kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), tile_expert,
      static_cast<bf16*>(out), depth, width, tm, trans_w);
  return (int)cudaGetLastError();
}

extern "C" int ragged_gemm_f32(const void* x, const void* w,
                               const int* tile_expert, void* out,
                               long long t, int d, int f, int tm, int e,
                               int trans_w, cudaStream_t stream) {
  (void)e;
  if (t / kCM > 65535) return (int)cudaErrorInvalidValue;
  const int depth = trans_w ? f : d, width = trans_w ? d : f;
  const dim3 grid((width + kCN - 1) / kCN, (unsigned)(t / kCM));
  ragged_gemm_f32_kernel<<<grid, kCThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      tile_expert, static_cast<float*>(out), depth, width, tm, trans_w);
  return (int)cudaGetLastError();
}
