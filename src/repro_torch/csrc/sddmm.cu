// Block SDDMM for Hopper, fp32: for every stored BSR tile b,
//     out[b, i, j] = x[blk_row[b]*br + i] . y[blk_col[b]*bc + j]
//                    (* blocks[b, i, j] when scale_by_a)
// at every position of the tile, stored or zero.
//
// Replaces the TPU kernel sddmm_bsr_pallas (src/repro/kernels/sddmm.py),
// which walks the tiles in a sequential grid and takes each (br x D) @
// (D x bc) product on the MXU, after padding D to 128 lanes.
//
// What bounds it here: operations at this repository's widths. Each tile
// costs 2*br*bc*D flops against br*bc*4 bytes written (and as many read
// when scaling by A), so from D ~ 40 on the fp32 CUDA-core rate
// (67 TFLOP/s) is the limit, not the 3.35 TB/s of HBM. Scaled by A, the
// output itself needs only one dot product per stored edge (the rest are
// zeros), a bytes bound that this dense design does not reach. Tensor
// cores (TF32 wgmma) and more warps per SM are later work; this kernel is
// the simple, right one.
//
// Design: one CTA owns a slice of 32 rows of one block row and walks that
// block row's tiles [row_ptr[r], row_ptr[r+1]) in their stored order, with
// the slice's x rows resident in shared memory (tile_scores.cuh). Every
// output element is written by exactly one thread: no atomics,
// deterministic. Padding blocks (zero tiles replicating the last block
// row) fall inside the last row's range and are written like any tile.
// D is taken unpadded; rows of x past x_rows and of y past y_rows read as
// zero. Offsets into blocks and out are 64-bit (nblocks*br*bc passes 2^31
// at 131 k tiles of 128 x 128).
#include "tile_scores.cuh"

namespace {

using tile::kRows;
using tile::kThreads;
using tile::kYStride;

template <int NC>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ row_ptr, const int* __restrict__ blk_col,
             const float* __restrict__ blocks, const float* __restrict__ x,
             const float* __restrict__ y, float* __restrict__ out,
             int slices, int br, int x_rows, int y_rows, int d, int dp,
             int scale_by_a) {
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
    float a[4][NC];
    if (scale_by_a) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          a[r][c] = __ldg(blocks + off + (4 * w + r) * BC + lane + 32 * c);
      }
    }
    float s[4][NC];
    tile::scores<NC>(Xs, Ys, y, (long long)__ldg(blk_col + b) * BC, y_rows,
                     d, dp, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float v = scale_by_a ? s[r][c] * a[r][c] : s[r][c];
        out[off + (4 * w + r) * BC + lane + 32 * c] = v;
      }
    }
  }
}

template <int NC>
int launch(const int* row_ptr, const int* blk_col, const float* blocks,
           const float* x, const float* y, float* out, int n_brows, int br,
           int x_rows, int y_rows, int d, int scale_by_a,
           cudaStream_t stream) {
  const int dp = tile::round_depth(d);
  const size_t smem = sizeof(float) * ((size_t)kRows * dp + NC * 32 * kYStride);
  const int slices = br / kRows;
  const long long ctas = (long long)n_brows * slices;
  if (ctas > 0x7fffffffLL || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      sddmm_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sddmm_kernel<NC><<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
      row_ptr, blk_col, blocks, x, y, out, slices, br, x_rows, y_rows, d, dp,
      scale_by_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// guarantees: n_brows >= 1, br a positive multiple of 32, bc 128 or 256
// (the tile widths the tuner picks), d >= 0, row_ptr has n_brows + 1 monotone entries
// from 0 to nblocks indexing blk_col and the (nblocks, br, bc) tiles, x
// (x_rows, d) and y (y_rows, d) row-major, out (nblocks, br, bc), all
// contiguous on the current device. The shared memory the launch needs,
// 4 * (32 * round_up(d, 32) + bc * 36) bytes, must fit the 227 KB of a
// Hopper block, else cudaErrorInvalidValue.
extern "C" int sddmm_f32(const int* row_ptr, const int* blk_col,
                         const float* blocks, const float* x, const float* y,
                         float* out, int n_brows, int br, int bc, int x_rows,
                         int y_rows, int d, int scale_by_a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br <= 0 || br % kRows != 0 || d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bc) {
    case 128: return launch<4>(row_ptr, blk_col, blocks, x, y, out, n_brows,
                               br, x_rows, y_rows, d, scale_by_a, s);
    case 256: return launch<8>(row_ptr, blk_col, blocks, x, y, out, n_brows,
                               br, x_rows, y_rows, d, scale_by_a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
