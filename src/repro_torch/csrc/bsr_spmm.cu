// Block-sparse-row SpMM (sum semiring) for Hopper, fp32:
//     out[r*BR + i, :] = sum_{b in block row r} sum_j
//                        blocks[b, i, j] * h[blk_col[b]*bc + j, :]
//
// Replaces the TPU kernel bsr_spmm_pallas (src/repro/kernels/bsr_spmm.py),
// the repository's "generated" kernel. That kernel walks the blocks in a
// sequential grid dimension, keeps a block row's (br, fk) accumulator
// resident in VMEM across consecutive blocks of the row and zero-inits it
// on the row's first block; the MXU takes each (br x bc) @ (bc x fk) tile
// product.
//
// What bounds it here: operations. Each stored tile costs 2*br*bc*K flops
// against br*bc*4 bytes of tile (read once) plus its share of h, so at
// K >= 16 the fp32 CUDA-core rate (67 TFLOP/s) is the limit, not the
// 3.35 TB/s of HBM. Tensor cores (TF32 / bf16 wgmma) and TMA staging are
// later work; this kernel is the simple, right one.
//
// Design: GPU blocks run in no order, so nothing carries between CTAs. One
// CTA owns one (block row, K tile of kFk columns) pair and walks the block
// row's blocks [row_ptr[r], row_ptr[r+1]) itself (row_ptr comes from a
// searchsorted over the sorted blk_row on the device). Per block it stages
// kDepth-column slices of the A tile (transposed) and the matching kDepth
// rows of h in shared memory and accumulates a (BR x kFk) tile in
// registers: thread (ty, tx) of a 16 x 16 grid owns rows ty*TM .. +TM and
// columns tx*4 .. +4. The tile is stored once: no atomics, deterministic.
// The K tiles of one block row are neighbours in the grid, so a tile read
// from HBM serves all of them from L2. Padding blocks (zeros, replicating
// the last block row) fall inside the last row's range and add nothing; an
// empty range stores zeros. Offsets into blocks, h and out are 64-bit
// (b*br*bc passes 2^31 past 131 k blocks of 128 x 128). Any K >= 1: the
// last K tile is masked. Rows of h past h_rows (the padding up to a
// multiple of bc) read as zero, so the caller never pads h.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kFk = 64;        // K tile: output columns per CTA
constexpr int kDepth = 32;     // tile columns (h rows) staged per step
constexpr int kPad = 4;        // keeps As rows 16-byte aligned

template <int BR>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ blk_col,
                const float* __restrict__ blocks, const float* __restrict__ h,
                float* __restrict__ out, int k_tiles, int bc, int h_rows,
                int k) {
  constexpr int TM = BR / 16;
  static_assert(TM % 4 == 0 || TM == 2, "BR in {32, 64, 128, 256}");
  static_assert((kDepth * (BR + kPad) + kDepth * kFk) * 4 <= 48 * 1024,
                "static shared memory");
  __shared__ __align__(16) float As[kDepth][BR + kPad];  // As[j][i] = A[i][j]
  __shared__ __align__(16) float Hs[kDepth][kFk];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int r = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kFk;
  const int b0 = __ldg(row_ptr + r);
  const int b1 = __ldg(row_ptr + r + 1);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }

  for (int b = b0; b < b1; ++b) {
    const float* a_tile = blocks + (long long)b * BR * bc;
    const long long h_row0 = (long long)__ldg(blk_col + b) * bc;
    for (int j0 = 0; j0 < bc; j0 += kDepth) {
      // A[:, j0:j0+kDepth], read as float4 along j (8 threads per tile row,
      // coalesced), stored transposed
      for (int e = tid; e < BR * (kDepth / 4); e += kThreads) {
        const int i = e / (kDepth / 4);
        const int jq = (e % (kDepth / 4)) * 4;
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            a_tile + (long long)i * bc + j0 + jq));
        As[jq + 0][i] = v.x;
        As[jq + 1][i] = v.y;
        As[jq + 2][i] = v.z;
        As[jq + 3][i] = v.w;
      }
      // h[h_row0 + j0 + j, k0 + c], zero past h_rows and past K
      for (int e = tid; e < kDepth * kFk; e += kThreads) {
        const int j = e / kFk;
        const int c = e % kFk;
        const long long hr = h_row0 + j0 + j;
        float v = 0.f;
        if (hr < h_rows && k0 + c < k) v = __ldg(h + hr * k + k0 + c);
        Hs[j][c] = v;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kDepth; ++j) {
        float a[TM];
        if constexpr (TM % 4 == 0) {
#pragma unroll
          for (int q = 0; q < TM / 4; ++q) {
            const float4 v =
                *reinterpret_cast<const float4*>(&As[j][ty * TM + 4 * q]);
            a[4 * q + 0] = v.x;
            a[4 * q + 1] = v.y;
            a[4 * q + 2] = v.z;
            a[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = As[j][ty * TM + i];
        }
        const float4 hv = *reinterpret_cast<const float4*>(&Hs[j][tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(a[i], hv.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], hv.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], hv.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], hv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float* orow = out + ((long long)r * BR + ty * TM + i) * k;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = k0 + tx * 4 + c;
      if (col < k) orow[col] = acc[i][c];
    }
  }
}

template <int BR>
int launch(const int* row_ptr, const int* blk_col, const float* blocks,
           const float* h, float* out, int n_brows, int bc, int h_rows, int k,
           cudaStream_t stream) {
  const int k_tiles = (k + kFk - 1) / kFk;
  const long long ctas = (long long)n_brows * k_tiles;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bsr_spmm_kernel<BR><<<static_cast<unsigned>(ctas), kThreads, 0, stream>>>(
      row_ptr, blk_col, blocks, h, out, k_tiles, bc, h_rows, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// guarantees: n_brows >= 1, k >= 1, br in {32, 64, 128, 256}, bc a
// positive multiple of 32, row_ptr has n_brows + 1 monotone entries
// indexing blk_col and the (nblocks, br, bc) tiles, blocks 16-byte
// aligned, out (n_brows * br, k), all arrays contiguous on the current
// device.
extern "C" int bsr_spmm_f32(const int* row_ptr, const int* blk_col,
                            const float* blocks, const float* h, float* out,
                            int n_brows, int br, int bc, int h_rows, int k,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc <= 0 || bc % kDepth != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (br) {
    case 32: return launch<32>(row_ptr, blk_col, blocks, h, out, n_brows, bc,
                               h_rows, k, s);
    case 64: return launch<64>(row_ptr, blk_col, blocks, h, out, n_brows, bc,
                               h_rows, k, s);
    case 128: return launch<128>(row_ptr, blk_col, blocks, h, out, n_brows,
                                 bc, h_rows, k, s);
    case 256: return launch<256>(row_ptr, blk_col, blocks, h, out, n_brows,
                                 bc, h_rows, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
