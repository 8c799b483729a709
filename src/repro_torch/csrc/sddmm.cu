// Block SDDMM for Hopper, fp32: for every stored BSR tile b,
//     out[b, i, j] = x[blk_row[b]*br + i] . y[blk_col[b]*bc + j]
//                    (* blocks[b, i, j] when scale_by_a)
// at every position of the tile, stored or zero.
//
// Replaces the TPU kernel sddmm_bsr_pallas (src/repro/kernels/sddmm.py),
// which walks the tiles in a sequential grid and takes each (br x D) @
// (D x bc) product on the MXU, after padding D to 128 lanes.
//
// Both instances: a CTA owns a slice of 32 rows of a block row's tiles,
// with the slice's x rows resident in shared memory (tile_scores.cuh).
// Every output element is written by exactly one thread: no atomics,
// deterministic. Padding blocks (zero tiles replicating the last block
// row) are written like any tile; a block row without tiles has nothing
// to write. D is taken unpadded; rows of x past x_rows and of y past
// y_rows read as zero. Offsets into blocks and out are 64-bit
// (nblocks*br*bc passes 2^31 at 131 k tiles of 128 x 128).
//
// Unscaled (sddmm_kernel): every position's score is output, so the work
// is bound by operations, 2 br bc D flops a tile on the fp32 CUDA cores
// (tile::scores, four rows a warp in registers). A CTA walks one block
// row's tiles [row_ptr[r], row_ptr[r+1]) in their stored order.
//
// Scaled by A (sddmm_nnz_kernel): a position where A is zero stores 0, so
// the output needs one dot product per stored nonzero and the function is
// bound by bytes: one read of A's tiles and one write of the output. A
// CTA walks kChunk consecutive tiles (in storage order, so the CTAs in
// flight stream neighbouring memory and share the load evenly), staging
// x again where the block row changes, and streams each tile once: a
// warp owns four rows of the slice and reads each as whole 16-byte
// vectors (the next tile's rows are loaded while this tile's are used).
// The warps' ballots list the slice's nonzeros in shared memory; each
// 8-lane group of every warp then takes one entry at a time and
// computes x_i . y_j (lane t of the group takes d = 32 c + 4 t + e,
// e = 0..3, in order with fma, as 16-byte loads where D % 4 == 0 and y
// is aligned, then the group's sum over xor 4, 2, 1: a fixed order),
// x_i from shared memory, y_j from L2 (A and the output are read and
// written evict-first); the warp that owns the row then writes it as
// whole 16-byte vectors, a * s at the nonzeros and 0 elsewhere (the
// plain version writes s * 0 there, NaN where s is not finite). The y
// reads, ~1 KB a nonzero at D = 256, are what keeps the kernel above the
// bytes of the tiles (tools/compare_kernels.py). A slice whose
// nonzeros exceed 1 / kDenseDiv of its positions takes tile::scores
// within the same launch instead (tools/compare_kernels.py: at 50 % fill
// the per-nonzero route ran 2.5x slower than the tile products; the two
// cross near 20 %), decided per tile from the warps' counts, and writes
// a * s where A is nonzero, 0 elsewhere.
#include <cstdint>

#include "tile_scores.cuh"

namespace {

using tile::kRows;
using tile::kThreads;
using tile::kYStride;

constexpr int kWarps = kThreads / 32;
constexpr int kDenseDiv = 5;   // a slice denser than 1/5 takes tile::scores
                               // (kernels/sddmm.DENSE_DIV)
constexpr int kChunk = 32;     // consecutive tiles a scaled CTA walks

// ---- unscaled: every position's score, dense tile products -------------

template <int NC>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ blk_col,
             const float* __restrict__ x, const float* __restrict__ y,
             float* __restrict__ out, int slices, int br, int x_rows,
             int y_rows, int d, int dp) {
  constexpr int BC = NC * 32;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;              // kRows * dp
  float* Ys = smem + kRows * dp; // BC * kYStride
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r_blk = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const long long row0 = (long long)r_blk * br + slice * kRows;
  tile::stage_x(x, Xs, row0, x_rows, d, dp);
  const int b0 = __ldg(row_ptr + r_blk);
  const int b1 = __ldg(row_ptr + r_blk + 1);
  for (int b = b0; b < b1; ++b) {
    const long long off = (long long)b * br * BC + (long long)slice * kRows * BC;
    float s[4][NC];
    tile::scores<NC>(Xs, Ys, y, (long long)__ldg(blk_col + b) * BC, y_rows,
                     d, dp, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        out[off + (4 * w + r) * BC + lane + 32 * c] = s[r][c];
    }
  }
}

// ---- scaled by A: one dot product a stored nonzero ----------------------

__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// the list of a sparse slice's nonzeros (shared memory)
template <int BC>
struct NnzList {
  static constexpr int kCap = kRows * BC / kDenseDiv;  // at most, sparse
  int pos[kCap];        // (local row << 16) | column in the tile
  float a[kCap];        // A's value there
  float s[kCap];        // a * (x_i . y_j)
};

// NC = bc / 32; a lane holds V = bc / 128 float4 of each of its warp's
// four rows, columns 4 lane + 128 v .. + 3
template <int NC>
__global__ void __launch_bounds__(kThreads, NC == 4 ? 3 : 2)
sddmm_nnz_kernel(const int* __restrict__ blk_row,
                 const int* __restrict__ blk_col,
                 const float* __restrict__ blocks,
                 const float* __restrict__ x, const float* __restrict__ y,
                 float* __restrict__ out, int nblocks, int slices, int br,
                 int x_rows, int y_rows, int d, int dp, int vec) {
  constexpr int BC = NC * 32;
  constexpr int V = BC / 128;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;              // kRows * dp
  float* Ys = smem + kRows * dp; // BC * kYStride (dense slices)
  auto* list = reinterpret_cast<NnzList<BC>*>(Ys + BC * kYStride);
  __shared__ int counts[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  const int g = lane >> 3;              // 8-lane group and lane in it
  const int t = lane & 7;
  const int slice = blockIdx.x % slices;
  const int b0 = blockIdx.x / slices * kChunk;
  const int b1 = min(nblocks, b0 + kChunk);

  auto tile_off = [&](int b) {
    return (long long)b * br * BC + (long long)slice * kRows * BC;
  };
  // this warp's four rows of tile b, read once (streaming)
  auto load = [&](int b, float4 (&a)[4][V]) {
    const float4* src = reinterpret_cast<const float4*>(blocks + tile_off(b));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        a[r][v] = __ldcs(src + (4 * w + r) * (BC / 4) + lane + 32 * v);
    }
  };

  float4 a[4][V], next[4][V];
  load(b0, a);
  int staged = -1;                      // the block row Xs holds
  for (int b = b0; b < b1; ++b) {
    if (b + 1 < b1) load(b + 1, next);
    const long long off = tile_off(b);
    const long long col0 = (long long)__ldg(blk_col + b) * BC;
    const int r_blk = __ldg(blk_row + b);
    if (r_blk != staged) {              // the same for every thread
      __syncthreads();                  // every warp is done with Xs
      tile::stage_x(x, Xs, (long long)r_blk * br + slice * kRows, x_rows,
                    d, dp);
      staged = r_blk;
    }

    // the slice's nonzeros: each warp's count (the barrier also publishes
    // the staged rows, and orders this tile's list after the last one's)
    int nz = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int q = 0; q < 4; ++q) nz += component(a[r][v], q) != 0.f;
      }
    }
    nz = __reduce_add_sync(0xffffffffu, nz);
    if (lane == 0) counts[w] = nz;
    __syncthreads();
    int total = 0, base = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      base += i < w ? counts[i] : 0;
      total += counts[i];
    }

    if (total * kDenseDiv > kRows * BC) {
      // dense slice: every score of the tile, A re-read from L2
      float s[4][NC];
      tile::scores<NC>(Xs, Ys, y, col0, y_rows, d, dp, s);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const long long e = off + (4 * w + r) * BC + lane + 32 * c;
          const float av = __ldg(blocks + e);
          __stcs(out + e, av != 0.f ? s[r][c] * av : 0.f);
        }
      }
    } else {
      // (1) the list: this warp's nonzeros at base.., in (row, vector,
      // component, lane) order
      int at = base;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float c = component(a[r][v], q);
            const unsigned bal = __ballot_sync(0xffffffffu, c != 0.f);
            if (c != 0.f) {
              const int i = at + __popc(bal & below);
              list->pos[i] = (4 * w + r) << 16 | (128 * v + 4 * lane + q);
              list->a[i] = c;
            }
            at += __popc(bal);
          }
        }
      }
      __syncthreads();
      // (2) four entries at a time a warp, one an 8-lane group (group g of
      // warp w takes entry 4 (w + 8 i) + g): lane t of the group sums
      // d = 32 c + 4 t + e (c = 0, 1, ..; e = 0..3) in that order with
      // fma, then the group sums over xor 4, 2, 1
      for (int e = 4 * w + g; e - g < total; e += 4 * kWarps) {
        const int ps = e < total ? list->pos[e] : 0;
        const long long j = col0 + (ps & 0xffff);
        const float* xr = Xs + (ps >> 16) * dp;
        const float* yr = e < total && j < y_rows ? y + j * d : nullptr;
        float p = 0.f;
        if (vec) {                      // d % 4 == 0, y 16-byte aligned
#pragma unroll 4
          for (int c = 4 * t; c < dp; c += 32) {
            const float4 xv = *reinterpret_cast<const float4*>(xr + c);
            const float4 yv =
                yr && c < d ? __ldg(reinterpret_cast<const float4*>(yr + c))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
            p = fmaf(xv.x, yv.x, p);
            p = fmaf(xv.y, yv.y, p);
            p = fmaf(xv.z, yv.z, p);
            p = fmaf(xv.w, yv.w, p);
          }
        } else {
#pragma unroll 2
          for (int c = 4 * t; c < dp; c += 32) {
#pragma unroll
            for (int k = c; k < c + 4; ++k)
              p = fmaf(xr[k], yr && k < d ? __ldg(yr + k) : 0.f, p);
          }
        }
        p += __shfl_xor_sync(0xffffffffu, p, 4);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        if (t == 0 && e < total) list->s[e] = list->a[e] * p;
      }
      __syncthreads();
      // (3) this warp's rows, in the order of (1): a * s at the nonzeros,
      // 0 elsewhere, as whole 16-byte vectors
      at = base;
      float4* dst = reinterpret_cast<float4*>(out + off + 4 * w * BC);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float o4[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float c = component(a[r][v], q);
            const unsigned bal = __ballot_sync(0xffffffffu, c != 0.f);
            o4[q] = c != 0.f ? list->s[at + __popc(bal & below)] : 0.f;
            at += __popc(bal);
          }
          __stcs(dst + r * (BC / 4) + lane + 32 * v,
                 make_float4(o4[0], o4[1], o4[2], o4[3]));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) a[r][v] = next[r][v];
    }
  }
}

template <int NC>
int launch(const int* row_ptr, const int* blk_row, const int* blk_col,
           const float* blocks, const float* x, const float* y, float* out,
           int n_brows, int nblocks, int br, int x_rows, int y_rows, int d,
           int scale_by_a, cudaStream_t stream) {
  const int dp = tile::round_depth(d);
  size_t smem = sizeof(float) * ((size_t)kRows * dp + NC * 32 * kYStride);
  const int slices = br / kRows;
  const long long ctas =
      scale_by_a ? (long long)(nblocks + kChunk - 1) / kChunk * slices
                 : (long long)n_brows * slices;
  if (scale_by_a) smem += sizeof(NnzList<NC * 32>);
  if (ctas > 0x7fffffffLL || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (scale_by_a) {
    err = cudaFuncSetAttribute(sddmm_nnz_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sddmm_nnz_kernel<NC>
        <<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
            blk_row, blk_col, blocks, x, y, out, nblocks, slices, br, x_rows,
            y_rows, d, dp,
            d % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0);
  } else {
    err = cudaFuncSetAttribute(sddmm_kernel<NC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sddmm_kernel<NC><<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
        row_ptr, blk_col, x, y, out, slices, br, x_rows, y_rows, d, dp);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// guarantees: n_brows >= 1, nblocks >= 1, br a positive multiple of 32,
// bc 128 or 256 (the tile widths the tuner picks), d >= 0; blk_row
// (nblocks,) sorted, row_ptr (n_brows + 1) its monotone row pointers from
// 0 to nblocks (read by the unscaled kernel), blk_col (nblocks,), the
// (nblocks, br, bc) tiles, x (x_rows, d) and y (y_rows, d) row-major, out
// (nblocks, br, bc), all contiguous on the current device, blocks and out
// 16-byte aligned. The shared memory the launch needs, 4 * (32 *
// round_up(d, 32) + bc * 36) bytes (and, scaled, 12 * (32 * bc / 5) more
// for the nonzero list), must fit the 227 KB of a Hopper block, else
// cudaErrorInvalidValue. scale_by_a selects sddmm_nnz_kernel, else
// sddmm_kernel.
extern "C" int sddmm_f32(const int* row_ptr, const int* blk_row,
                         const int* blk_col, const float* blocks,
                         const float* x, const float* y, float* out,
                         int n_brows, int nblocks, int br, int bc, int x_rows,
                         int y_rows, int d, int scale_by_a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br <= 0 || br % kRows != 0 || d < 0 || nblocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bc) {
    case 128: return launch<4>(row_ptr, blk_row, blk_col, blocks, x, y, out,
                               n_brows, nblocks, br, x_rows, y_rows, d,
                               scale_by_a, s);
    case 256: return launch<8>(row_ptr, blk_row, blk_col, blocks, x, y, out,
                               n_brows, nblocks, br, x_rows, y_rows, d,
                               scale_by_a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
