// Block-sparse-row SpMM (sum semiring) for Hopper, fp32 in and out:
//     out[r*br + i, :] = sum_{b in block row r} sum_j
//                        blocks[b, i, j] * h[blk_col[b]*bc + j, :]
//
// Replaces the TPU kernel bsr_spmm_pallas (src/repro/kernels/bsr_spmm.py),
// the repository's "generated" kernel. That kernel walks the blocks in a
// sequential grid dimension, keeps a block row's (br, fk) accumulator
// resident in VMEM across the row's blocks, and lets the MXU take each
// (br x bc) @ (bc x fk) tile product at default precision (one bf16 pass).
//
// What bounds it here: operations. Each stored tile costs 2 br bc K flops
// against br bc 4 bytes of tile. Here the products run on the tensor cores
// in split TF32 ("3xTF32"): x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi)
// and a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi, each product exact in the
// fp32 accumulator, so the result stays within a few fp32 ulps of an fp32
// sum (the dropped a_lo b_lo and the two roundings are 3 * 2^-22 relative
// at most). Three TF32 passes cost 3 / 495 TFLOP/s a flop, against 1 / 67
// on the CUDA cores. At low tile fill no dense-tile kernel reaches a
// gather kernel: the tile bytes alone outweigh the edges.
//
// Design.
// - Pre-pass (bsr_spmm_kernel_prepass): h (h_rows, K) is written once a
//   call as h^T in chunks of 32 nodes, (ld / 32, K, 32), ld = h_rows
//   rounded up to 32: TF32 wgmma takes its shared-memory B operand
//   K-major only (no transpose bit), the tile-product depth is h's row
//   axis, and a chunk's (FK x 32) box is one contiguous read.
// - Main kernel (bsr_spmm_kernel): a CTA owns up to 128 rows of one block
//   row (two 128-row halves for br = 256), one K tile of FK = 64 or 128
//   columns (the K tiles of a chunk are neighbours in the grid, so a
//   tile's second read comes from L2), and one chunk of the row's tiles.
//   One thread of a producer warpgroup issues TMA loads into a ring of 4
//   stages (mbarriers "full" and "empty"); a
//   stage is 32 tile columns, one 128-byte swizzled row of fp32: a
//   (ROWS x 32) box of the tile array viewed as (nblocks * br, bc) and an
//   (FK x 32) box of h^T at the tile's block column. TMA's zero fill past
//   h and past K replaces any bounds test. One or two consumer
//   warpgroups (64 rows each) split each landed B box in shared memory
//   (hi in place, lo into one of two buffers outside the ring by step
//   parity; a proxy fence and a named barrier hand it to the tensor
//   cores), load their A fragments (ALayout_64x8) from the swizzled
//   stage and split them in registers, and issue three wgmma m64nFKk8 per
//   8 columns into an fp32 accumulator in registers. A fragments of two
//   steps are kept, so a step's split and loads run while the previous
//   step's wgmmas do (wgmma.wait_group 1). The producer warpgroup gives
//   its registers to the consumers (setmaxnreg 40 / 232): a 384-thread
//   CTA is otherwise held to 168 registers a thread, and the wgmma
//   operands then spill and ptxas serialises the wgmmas.
// - Accuracy: the tensor cores truncate their fp32 running sum at each
//   step instead of rounding it, so over a long chain the error grows
//   with the number of steps, all one way (129 tiles of N(0,1) products
//   summed in one chain erred by 2e-4 of the output). Every 8 steps the
//   consumers drain the wgmmas and add the partial sum to a second
//   register accumulator with round to nearest, which is what the 256
//   registers of two (64 x 128) accumulators allow (hence FK <= 128).
//   That accumulator is stored once, in place: no atomics, deterministic.
// - Load balance: a block row's tiles are cut into chunks of `chunk`
//   tiles (the wrapper sizes them for ~16 CTAs an SM), so a long row does
//   not make the tail. A row of one chunk stores into out; a row of
//   several stores each chunk into the workspace, and
//   bsr_spmm_kernel_reduce adds them in chunk order (deterministic).
// - Kept from the CUDA-core design: padding blocks (zero tiles of the
//   last row) add nothing, an empty block row stores zeros, any K >= 1,
//   64-bit offsets (TMA addresses the tile array itself; out and the
//   workspace use 64-bit indices).
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kDepth = 32;            // tile columns a stage: 128 B of fp32
constexpr int kSmemMax = 232448;      // shared memory a block can use
constexpr int kMaxStages = 4;
constexpr int kFoldSteps = 8;         // steps a partial sum runs on the TCs

template <int ROWS, int FK>
struct Cfg {
  static constexpr int kWarpgroups = ROWS > 64 ? 2 : 1;
  // consumers, then a producer warpgroup (one TMA thread; the others
  // give up their registers so that two consumer warpgroups keep their
  // (64 x FK) accumulators and two steps of A fragments in registers)
  static constexpr int kThreads = (kWarpgroups + 1) * 128;
  static constexpr int kABytes = ROWS * kDepth * 4;
  static constexpr int kBBytes = FK * kDepth * 4;
  static constexpr int kStageBytes = kABytes + kBBytes;   // what TMA fills
  static constexpr int kFit =
      (kSmemMax - 1024 - 64 - 2 * kBBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // the ring, two B lo buffers (steps alternate), and slack to align them
  // to 1024 bytes (the barriers are static)
  static constexpr int kLoOffset = kStages * kStageBytes;
  static constexpr int kSmem = kLoOffset + 2 * kBBytes + 1024;
  static_assert(kStages >= 2, "ring");
};

// element (row, col) of a (rows x 32) fp32 box in 128-byte swizzle
__device__ __forceinline__ int swz(int row, int col) {
  return row * 32 + ((((col >> 2) ^ row) & 7) << 2) + (col & 3);
}

template <int ROWS, int FK>
__global__ void __launch_bounds__(Cfg<ROWS, FK>::kThreads, 1)
bsr_spmm_kernel(const __grid_constant__ CUtensorMap tiles,
                   const __grid_constant__ CUtensorMap h_t,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ chunk_ptr,
                   const int* __restrict__ blk_col, float* __restrict__ out,
                   float* __restrict__ ws, int n_brows, int br, int bc, int k,
                   int chunk, int k_tiles) {
  using C = Cfg<ROWS, FK>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::kStages], empty[C::kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int n_sub = (br / ROWS) * k_tiles;
  const int item = blockIdx.x / n_sub;
  const int sub = blockIdx.x % n_sub;
  if (item >= __ldg(chunk_ptr + n_brows)) return;  // grid is an upper bound
  // the block row of this chunk: the last r with chunk_ptr[r] <= item
  int lo = 0, hi = n_brows - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(chunk_ptr + mid) <= item) lo = mid; else hi = mid - 1;
  }
  const int r = lo;
  const int first_chunk = __ldg(chunk_ptr + r);
  const bool direct = __ldg(chunk_ptr + r + 1) - first_chunk == 1;
  const int row_end = __ldg(row_ptr + r + 1);
  const int b0 = __ldg(row_ptr + r) + (item - first_chunk) * chunk;
  const int b1 = min(row_end, b0 + chunk);
  const int half = sub / k_tiles;
  const int kt = sub % k_tiles;
  const int steps_per_tile = bc / kDepth;
  const int n_steps = b1 > b0 ? (b1 - b0) * steps_per_tile : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], C::kWarpgroups * 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= C::kWarpgroups * 4) {
    // producer warpgroup: one thread keeps the ring full, the others only
    // hand their registers to the consumers
    if constexpr (C::kWarpgroups == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == C::kWarpgroups * 128 && n_steps > 0) {
      hopper::prefetch_tensor_map(&tiles);
      hopper::prefetch_tensor_map(&h_t);
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < n_steps; ++s) {
        const int b = b0 + s / steps_per_tile;
        const int col = (s % steps_per_tile) * kDepth;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[stage],
                                      C::kABytes + C::kBBytes);
        unsigned char* st = smem + stage * C::kStageBytes;
        hopper::tma_load_2d(st, &tiles, &full[stage], col,
                            b * br + half * ROWS);
        const int chunk32 = (__ldg(blk_col + b) * bc + col) / kDepth;
        hopper::tma_load_3d(st + C::kABytes, &h_t, &full[stage], 0, kt * FK,
                            chunk32);
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // consumer warpgroups: warpgroup wg owns rows 64 wg .. 64 wg + 63
    if constexpr (C::kWarpgroups == 2) hopper::setmaxnreg_inc<232>();
    const int g = lane >> 2;
    const int t = lane & 3;
    const int row0 = warp * 16 + g;       // = 64 wg + 16 (warp % 4) + g
    const bool live = warp * 16 < ROWS;   // br = 32: warps 2, 3 hold no rows
    // acc: the tensor cores' running sum, which they truncate at every
    // step; master: acc folded in every kFoldSteps steps, in fp32 with
    // round to nearest
    float acc[FK / 2], master[FK / 2];
#pragma unroll
    for (int i = 0; i < FK / 2; ++i) acc[i] = master[i] = 0.f;
    auto fold = [&]() {
      hopper::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < FK / 2; ++i) {
        master[i] += acc[i];
        acc[i] = 0.f;
      }
    };

    // wait for a stage and split its B box: hi over the raw values, lo
    // into the lo buffer of the step's parity
    constexpr int kConsumers = C::kWarpgroups * 128;
    auto prepare = [&](int stg, uint32_t ph, int parity) {
      hopper::mbar_wait(&full[stg], ph);
      unsigned char* st = smem + stg * C::kStageBytes;
      float4* b_raw = reinterpret_cast<float4*>(st + C::kABytes);
      float4* b_lo = reinterpret_cast<float4*>(smem + C::kLoOffset +
                                               parity * C::kBBytes);
#pragma unroll
      for (int i = threadIdx.x; i < C::kBBytes / 16; i += kConsumers) {
        const float4 x = b_raw[i];
        float4 xh, xl;
        xh.x = __uint_as_float(hopper::tf32_rna(x.x));
        xh.y = __uint_as_float(hopper::tf32_rna(x.y));
        xh.z = __uint_as_float(hopper::tf32_rna(x.z));
        xh.w = __uint_as_float(hopper::tf32_rna(x.w));
        xl.x = __uint_as_float(hopper::tf32_rna(x.x - xh.x));
        xl.y = __uint_as_float(hopper::tf32_rna(x.y - xh.y));
        xl.z = __uint_as_float(hopper::tf32_rna(x.z - xh.z));
        xl.w = __uint_as_float(hopper::tf32_rna(x.w - xh.w));
        b_raw[i] = xh;
        b_lo[i] = xl;
      }
      hopper::fence_proxy_async();      // visible to the tensor cores
      hopper::named_barrier_sync(1, kConsumers);
    };

    // A fragments of two steps in registers (set = step parity), so the
    // next step's split overlaps this step's wgmma
    uint32_t a_hi[2][4][4], a_lo[2][4][4];
    auto load_a = [&](auto set, int stg) {
      constexpr int p = decltype(set)::value;
      const float* as =
          reinterpret_cast<const float*>(smem + stg * C::kStageBytes);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // ALayout_64x8: (row0, 8ks + t), (row0 + 8, ..), (row0, 8ks + t +
        // 4), (row0 + 8, 8ks + t + 4)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = row0 + (q & 1) * 8;
          const int cc = ks * 8 + t + (q >> 1) * 4;
          const float x = live ? as[swz(rr, cc)] : 0.f;
          a_hi[p][ks][q] = hopper::tf32_rna(x);
          a_lo[p][ks][q] =
              hopper::tf32_rna(x - __uint_as_float(a_hi[p][ks][q]));
        }
      }
    };

    int stage = 0, prev_stage = 0;
    uint32_t phase = 0;
    auto step = [&](auto set, int s) {
      constexpr int p = decltype(set)::value;
      const uint32_t b_hi =
          hopper::smem_u32(smem + stage * C::kStageBytes + C::kABytes);
      const uint32_t b_lo =
          hopper::smem_u32(smem + C::kLoOffset + p * C::kBBytes);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dh = hopper::smem_desc(b_hi + ks * 32, 16, 1024, 128);
        const uint64_t dl = hopper::smem_desc(b_lo + ks * 32, 16, 1024, 128);
        hopper::WgmmaTf32RS<FK>::mma(acc, a_lo[p][ks], dh, 1);
        hopper::WgmmaTf32RS<FK>::mma(acc, a_hi[p][ks], dl, 1);
        hopper::WgmmaTf32RS<FK>::mma(acc, a_hi[p][ks], dh, 1);
      }
      hopper::wgmma_commit();
      if ((s + 1) % kFoldSteps == 0) {
        hopper::wgmma_wait<0>();          // steps s - 1 and s are done
        fold();
      } else {
        hopper::wgmma_wait<1>();          // step s - 1 is done
      }
      if (s > 0) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[prev_stage]);
      }
      prev_stage = stage;
      if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      if (s + 1 < n_steps) {
        prepare(stage, phase, 1 - p);
        load_a(std::integral_constant<int, 1 - p>(), stage);
      }
    };

    if (n_steps > 0) {
      prepare(0, 0, 0);
      load_a(std::integral_constant<int, 0>(), 0);
    }
    hopper::fence_regs(acc);
    for (int s = 0; s < n_steps; s += 2) {
      step(std::integral_constant<int, 0>(), s);
      if (s + 1 < n_steps) step(std::integral_constant<int, 1>(), s + 1);
    }
    hopper::wgmma_wait<0>();
    fold();

    if (!live) return;
    float* dst = direct ? out + ((long long)r * br + half * ROWS) * k
                        : ws + ((long long)item * br + half * ROWS) * k;
    const bool pairs = (k & 1) == 0;
#pragma unroll
    for (int j = 0; j < FK / 8; ++j) {
      const int col = kt * FK + j * 8 + 2 * t;
      if (col >= k) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* p = dst + (long long)(row0 + 8 * h) * k + col;
        const float v0 = master[4 * j + 2 * h];
        const float v1 = master[4 * j + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (col + 1 < k) p[1] = v1;
        }
      }
    }
  }
}

// h (h_rows, k) -> h^T in chunks of 32 nodes, (ld / 32, k, 32): node n,
// feature c at ((n / 32) k + c) 32 + n % 32, through a 32 x 32 shared
// tile; nodes h_rows .. ld - 1 are zero
__global__ void __launch_bounds__(256)
bsr_spmm_kernel_prepass(const float* __restrict__ h, float* __restrict__ h_t,
                 int h_rows, int k) {
  __shared__ float tile[32][33];
  const long long n0 = (long long)blockIdx.x * 32;
  const int k0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const long long n = n0 + i;
    const int c = k0 + threadIdx.x;
    tile[i][threadIdx.x] = n < h_rows && c < k ? __ldg(h + n * k + c) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const long long c = k0 + i;
    if (c < k)
      h_t[(n0 * k + c * 32) + threadIdx.x] = tile[threadIdx.x][i];
  }
}

// out[block row r] = sum over its chunks, in chunk order, of the workspace
// (rows of one chunk were stored in place by the main kernel)
__global__ void __launch_bounds__(256)
bsr_spmm_kernel_reduce(const int* __restrict__ chunk_ptr,
                  const float* __restrict__ ws, float* __restrict__ out,
                  int br, int k) {
  const int r = blockIdx.x;
  const int c0 = __ldg(chunk_ptr + r);
  const int c1 = __ldg(chunk_ptr + r + 1);
  if (c1 - c0 < 2) return;
  const long long n = (long long)br * k;
  for (long long e = (long long)blockIdx.y * blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.y * blockDim.x) {
    float s = ws[(long long)c0 * n + e];
    for (int c = c0 + 1; c < c1; ++c) s += ws[(long long)c * n + e];
    out[(long long)r * n + e] = s;
  }
}

template <int ROWS, int FK>
int launch(const int* row_ptr, const int* chunk_ptr, const int* blk_col,
           const float* blocks, const float* h_t, float* out, float* ws,
           int n_brows, int n_items, int nblocks, int br, int bc, int ld,
           int k, int chunk, cudaStream_t stream) {
  using C = Cfg<ROWS, FK>;
  CUtensorMap m_tiles, m_h;
  const cuuint64_t dims[2] = {(cuuint64_t)bc, (cuuint64_t)nblocks * br};
  const cuuint64_t strides[1] = {(cuuint64_t)bc * 4};
  const cuuint32_t box[2] = {kDepth, ROWS};
  int rc = hopper::make_tensor_map(&m_tiles, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                   2, blocks, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  // h^T in chunks of 32 nodes: (ld / 32, k, 32), a box one chunk's FK
  // features, 16 KB contiguous at FK = 128
  const cuuint64_t hdims[3] = {kDepth, (cuuint64_t)k,
                               (cuuint64_t)ld / kDepth};
  const cuuint64_t hstrides[2] = {kDepth * 4, (cuuint64_t)k * kDepth * 4};
  const cuuint32_t hbox[3] = {kDepth, FK, 1};
  rc = hopper::make_tensor_map(&m_h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, h_t,
                               hdims, hstrides, hbox,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;

  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_spmm_kernel<ROWS, FK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int k_tiles = (k + FK - 1) / FK;
  const long long ctas = (long long)n_items * (br / ROWS) * k_tiles;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bsr_spmm_kernel<ROWS, FK>
      <<<(unsigned)ctas, C::kThreads, C::kSmem, stream>>>(
          m_tiles, m_h, row_ptr, chunk_ptr, blk_col, out, ws, n_brows, br,
          bc, k, chunk, k_tiles);
  return (int)cudaGetLastError();
}

template <int ROWS>
int dispatch_fk(int fk, const int* row_ptr, const int* chunk_ptr,
                const int* blk_col, const float* blocks, const float* h_t,
                float* out, float* ws, int n_brows, int n_items, int nblocks,
                int br, int bc, int ld, int k, int chunk, cudaStream_t s) {
  switch (fk) {
    case 64:
      return launch<ROWS, 64>(row_ptr, chunk_ptr, blk_col, blocks, h_t, out,
                              ws, n_brows, n_items, nblocks, br, bc, ld, k,
                              chunk, s);
    case 128:
      return launch<ROWS, 128>(row_ptr, chunk_ptr, blk_col, blocks, h_t, out,
                               ws, n_brows, n_items, nblocks, br, bc, ld, k,
                               chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Writes h^T of h (h_rows, k) in chunks of 32 nodes, (ld / 32, k, 32);
// ld >= h_rows, a multiple of 32. Returns cudaGetLastError() after the
// launch.
extern "C" int bsr_transpose_h_f32(const float* h, float* h_t, int h_rows,
                                   int k, int ld, void* stream) {
  if (h_rows < 0 || k <= 0 || ld < h_rows || ld % kDepth ||
      (k + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(ld / 32), (unsigned)((k + 31) / 32));
  bsr_spmm_kernel_prepass<<<grid, dim3(32, 8), 0,
                            static_cast<cudaStream_t>(stream)>>>(h, h_t,
                                                                 h_rows, k);
  return (int)cudaGetLastError();
}

// The tile products and, when a block row spans several chunks, the
// ordered reduction of its workspace slots. The caller guarantees:
// n_brows >= 1, k >= 1, br in {32, 64, 128, 256}, bc a positive multiple
// of 32, fk in {64, 128}; row_ptr has n_brows + 1 monotone entries
// indexing blk_col and the (nblocks, br, bc) tiles; chunk_ptr[r] is the
// first chunk (of `chunk` tiles, at least one a row) of block row r,
// chunk_ptr[n_brows] = n_items at most `grid_items`; ws holds grid_items
// x br x k floats; h_t comes from bsr_transpose_h_f32; all arrays 16-byte
// aligned, contiguous, on the current device. Returns cudaGetLastError()
// after the launches (0 on success), or 1000 + the driver's code if a
// tensor map cannot be encoded.
extern "C" int bsr_spmm_f32(const int* row_ptr, const int* chunk_ptr,
                            const int* blk_col, const float* blocks,
                            const float* h_t, float* out, float* ws,
                            int n_brows, int grid_items, int nblocks, int br,
                            int bc, int ld, int k, int fk, int chunk,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc <= 0 || bc % kDepth != 0 || chunk <= 0 || nblocks <= 0)
    return (int)cudaErrorInvalidValue;
  int rc;
  switch (br) {
    case 32:
      rc = dispatch_fk<32>(fk, row_ptr, chunk_ptr, blk_col, blocks, h_t, out,
                           ws, n_brows, grid_items, nblocks, br, bc, ld, k,
                           chunk, s);
      break;
    case 64:
      rc = dispatch_fk<64>(fk, row_ptr, chunk_ptr, blk_col, blocks, h_t, out,
                           ws, n_brows, grid_items, nblocks, br, bc, ld, k,
                           chunk, s);
      break;
    case 128:
    case 256:
      rc = dispatch_fk<128>(fk, row_ptr, chunk_ptr, blk_col, blocks, h_t,
                            out, ws, n_brows, grid_items, nblocks, br, bc, ld,
                            k, chunk, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  const long long per_row = (long long)br * k;
  const unsigned ys = (unsigned)min(64LL, (per_row + 255) / 256);
  bsr_spmm_kernel_reduce<<<dim3((unsigned)n_brows, ys), 256, 0, s>>>(
      chunk_ptr, ws, out, br, k);
  return (int)cudaGetLastError();
}
