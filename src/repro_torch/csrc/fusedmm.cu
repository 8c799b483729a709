// FusedMM over BSR tiles for Hopper, fp32 (paper §3.4; Rahman et al.,
// IPDPS'21): SDDMM -> edge nonlinearity -> SpMM in one pass,
//     out[i] = sum_{j : A_ij != 0} f(x_i . y_j) h_j
// with f an online row softmax (graph attention), a sigmoid, or none.
// Only `out` reaches device memory: scores and weights live in registers
// and shared memory. A's values only mask (A_ij != 0); they do not scale.
//
// Replaces the TPU kernel fusedmm_bsr_pallas (src/repro/kernels/
// fusedmm.py). That kernel walks the tiles in a sequential grid, keeps a
// block row's running max, denominator and (br, K) accumulator in VMEM
// from its first tile to its last, and pads D and K to 128 lanes.
//
// What bounds it here. The function needs one read of the tiles (to find
// the mask) and 2*(D + K) flops per stored edge: at the fill of a real
// graph (< 1 % of a 128 x 128 tile) that is a bytes bound. This design,
// the reference's, does 2*br*bc*(D + K) flops of dense tile work per
// stored tile whatever its fill, so the fp32 CUDA-core rate (67 TFLOP/s)
// limits it, ~100x above the per-edge work. As written it is further
// held back by occupancy: the accumulator and score registers leave room
// for one 8-warp CTA per SM, and the p @ h and score loops load one
// shared-memory float4 per four fma of a row. Fewer registers per thread,
// tensor cores and a gather variant are later work (ROADMAP).
//
// Design: no CTA carries state to another, so one CTA owns a slice of 32
// rows of one block row and walks that block row's tiles [row_ptr[r],
// row_ptr[r+1]) itself, in their stored order. The slice's x rows stay in
// shared memory for the whole walk; per tile the score routine of
// tile_scores.cuh leaves a 32 x bc score tile in registers, four whole
// rows per warp, so the row max and the row sum of the online softmax are
// warp shuffles. Running max m (from -1e30), denominator z and the
// accumulator acc (32 x KW, four rows by 4*NQ columns per thread) stay in
// registers from the first tile to the last:
//     m_new = max(m, max_j s_ij (masked: -1e30)),  alpha = exp(m - m_new)
//     p_ij  = A_ij != 0 ? exp(s_ij - m_new) : 0
//     z = z alpha + sum_j p_ij,   acc = acc alpha + p @ h_tile
// and the row is stored once as acc / max(z, 1e-30): a row with no
// unmasked entry stores 0, every row of every block row is written. No
// atomics, a fixed order: deterministic. p goes to shared memory
// (transposed, so a float4 broadcast gives a warp its four rows' weights)
// and the h tile is staged 32 rows at a time. One launch covers up to
// KW = 512 columns of h (NQ = KW / 128 register groups); the wrapper
// launches once per 512 columns of a wider h. Offsets into blocks, x, y,
// h and out are 64-bit.
#include "tile_scores.cuh"

namespace {

using tile::kRows;
using tile::kThreads;
using tile::kYStride;

constexpr int kJc = 32;          // h tile rows staged per step
constexpr int kPStride = kRows + 4;  // Ps row: 36 floats, 16-byte aligned
constexpr float kNegInf = -1e30f;
enum EdgeOp { kSoftmax = 0, kSigmoid = 1, kNone = 2 };

template <int NC, int NQ>
__host__ __device__ constexpr int buf_floats() {
  return (NC * 32 * kYStride > kJc * NQ * 128) ? NC * 32 * kYStride
                                               : kJc * NQ * 128;
}

template <int NC, int NQ>
__global__ void __launch_bounds__(kThreads)
fusedmm_kernel(const int* __restrict__ row_ptr,
               const int* __restrict__ blk_col,
               const float* __restrict__ blocks, const float* __restrict__ x,
               const float* __restrict__ y, const float* __restrict__ h,
               float* __restrict__ out, int slices, int br, int x_rows,
               int y_rows, int d, int dp, int h_rows, long long h_ld, int kw,
               long long out_ld, int edge_op) {
  constexpr int BC = NC * 32;
  constexpr int KW = NQ * 128;
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                   // kRows * dp
  float* Ps = Xs + kRows * dp;        // BC * kPStride, Ps[j][row]
  float* buf = Ps + BC * kPStride;    // Ys (scores) or Hs[kJc][KW]
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r_blk = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const long long row0 = (long long)r_blk * br + slice * kRows;
  tile::stage_x(x, Xs, row0, x_rows, d, dp);

  float acc[4][NQ][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][q][i] = 0.f;
    }
  }
  float m[4], z[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    z[r] = 0.f;
  }

  const int b0 = __ldg(row_ptr + r_blk);
  const int b1 = __ldg(row_ptr + r_blk + 1);
  for (int b = b0; b < b1; ++b) {
    const long long col0 = (long long)__ldg(blk_col + b) * BC;
    const float* a_tile =
        blocks + (long long)b * br * BC + (long long)slice * kRows * BC;
    bool mk[4][NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        mk[r][c] = __ldg(a_tile + (4 * w + r) * BC + lane + 32 * c) != 0.f;
    }
    float p[4][NC];
    tile::scores<NC>(Xs, buf, y, col0, y_rows, d, dp, p);

    if (edge_op == kSoftmax) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float tmax = kNegInf;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          tmax = fmaxf(tmax, mk[r][c] ? p[r][c] : kNegInf);
        const float m_new = fmaxf(m[r], tile::warp_max(tmax));
        const float alpha = expf(m[r] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          p[r][c] = mk[r][c] ? expf(p[r][c] - m_new) : 0.f;
          psum += p[r][c];
        }
        z[r] = z[r] * alpha + tile::warp_sum(psum);
        m[r] = m_new;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[r][q][i] *= alpha;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float s = p[r][c];
          p[r][c] = !mk[r][c] ? 0.f
                    : edge_op == kSigmoid ? 1.f / (1.f + expf(-s)) : s;
        }
      }
    }
    // scores() closed with a barrier: nobody reads Ps from the last tile
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(Ps + (lane + 32 * c) * kPStride + 4 * w) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);

    // acc += p @ h[col0 .. col0 + BC), kJc rows of h at a time
    for (int j0 = 0; j0 < BC; j0 += kJc) {
      __syncthreads();  // Ps written; the last step is done with buf
      for (int e = threadIdx.x; e < kJc * KW; e += kThreads) {
        const int jj = e / KW;
        const int c = e % KW;
        const long long gr = col0 + j0 + jj;
        buf[e] = (gr < h_rows && c < kw) ? __ldg(h + gr * h_ld + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kJc; ++jj) {
        const float4 pv =
            *reinterpret_cast<const float4*>(Ps + (j0 + jj) * kPStride + 4 * w);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const float4 hv = *reinterpret_cast<const float4*>(
              buf + jj * KW + q * 128 + lane * 4);
          const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][q][0] = fmaf(pr[r], hv.x, acc[r][q][0]);
            acc[r][q][1] = fmaf(pr[r], hv.y, acc[r][q][1]);
            acc[r][q][2] = fmaf(pr[r], hv.z, acc[r][q][2]);
            acc[r][q][3] = fmaf(pr[r], hv.w, acc[r][q][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float zc = edge_op == kSoftmax ? fmaxf(z[r], 1e-30f) : 1.f;
    float* orow = out + (row0 + 4 * w + r) * out_ld;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = q * 128 + lane * 4 + i;
        if (col < kw) orow[col] = edge_op == kSoftmax ? acc[r][q][i] / zc
                                                      : acc[r][q][i];
      }
    }
  }
}

template <int NC, int NQ>
int launch(const int* row_ptr, const int* blk_col, const float* blocks,
           const float* x, const float* y, const float* h, float* out,
           int n_brows, int br, int x_rows, int y_rows, int d, int h_rows,
           long long h_ld, int kw, long long out_ld, int edge_op,
           cudaStream_t stream) {
  const int dp = tile::round_depth(d);
  const size_t smem =
      sizeof(float) * ((size_t)kRows * dp + NC * 32 * kPStride +
                       buf_floats<NC, NQ>());
  const int slices = br / kRows;
  const long long ctas = (long long)n_brows * slices;
  if (ctas > 0x7fffffffLL || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fusedmm_kernel<NC, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fusedmm_kernel<NC, NQ>
      <<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
          row_ptr, blk_col, blocks, x, y, h, out, slices, br, x_rows, y_rows,
          d, dp, h_rows, h_ld, kw, out_ld, edge_op);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_k(const int* row_ptr, const int* blk_col, const float* blocks,
             const float* x, const float* y, const float* h, float* out,
             int n_brows, int br, int x_rows, int y_rows, int d, int h_rows,
             long long h_ld, int kw, long long out_ld, int edge_op,
             cudaStream_t s) {
  switch ((kw + 127) / 128) {
    case 1: return launch<NC, 1>(row_ptr, blk_col, blocks, x, y, h, out,
                                 n_brows, br, x_rows, y_rows, d, h_rows,
                                 h_ld, kw, out_ld, edge_op, s);
    case 2: return launch<NC, 2>(row_ptr, blk_col, blocks, x, y, h, out,
                                 n_brows, br, x_rows, y_rows, d, h_rows,
                                 h_ld, kw, out_ld, edge_op, s);
    case 3: return launch<NC, 3>(row_ptr, blk_col, blocks, x, y, h, out,
                                 n_brows, br, x_rows, y_rows, d, h_rows,
                                 h_ld, kw, out_ld, edge_op, s);
    case 4: return launch<NC, 4>(row_ptr, blk_col, blocks, x, y, h, out,
                                 n_brows, br, x_rows, y_rows, d, h_rows,
                                 h_ld, kw, out_ld, edge_op, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// guarantees: n_brows >= 1, br a positive multiple of 32, bc 128 or 256
// (the tile widths the tuner picks), d >= 0, 1 <= kw <= 512, edge_op 0 (softmax),
// 1 (sigmoid) or 2 (none), row_ptr has n_brows + 1 monotone entries from
// 0 to nblocks indexing blk_col and the (nblocks, br, bc) tiles, x
// (x_rows, d) and y (y_rows, d) row-major, h rows of kw columns h_ld
// floats apart, out rows of kw columns out_ld floats apart
// (n_brows * br rows), all on the current device. The shared memory the
// launch needs, 4 * (32 round_up(d, 32) + 36 bc + max(36 bc,
// 32 * 128 ceil(kw / 128))) bytes, must fit the 227 KB of a Hopper
// block, else cudaErrorInvalidValue.
extern "C" int fusedmm_f32(const int* row_ptr, const int* blk_col,
                           const float* blocks, const float* x,
                           const float* y, const float* h, float* out,
                           int n_brows, int br, int bc, int x_rows,
                           int y_rows, int d, int h_rows, long long h_ld,
                           int kw, long long out_ld, int edge_op,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br <= 0 || br % kRows != 0 || d < 0 || kw < 1 || kw > 512 ||
      edge_op < kSoftmax || edge_op > kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bc) {
    case 128: return launch_k<4>(row_ptr, blk_col, blocks, x, y, h, out,
                                 n_brows, br, x_rows, y_rows, d, h_rows,
                                 h_ld, kw, out_ld, edge_op, s);
    case 256: return launch_k<8>(row_ptr, blk_col, blocks, x, y, h, out,
                                 n_brows, br, x_rows, y_rows, d, h_rows,
                                 h_ld, kw, out_ld, edge_op, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
