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
// the mask) and, per stored edge, x_i . y_j and p h_j: at the fill of a
// real graph (0.69 % of a 128 x 128 tile at ogbn-proteins 1/4) that is a
// bytes bound, the tiles once plus a y row and an h row (2 KB at D = K =
// 256, from L2) per edge. Dense tile products, the reference's design and
// this kernel's first, do 2 br bc (D + K) flops per stored tile whatever
// its fill: ~100x the per-edge work at that fill.
//
// Design: no CTA carries state to another, so one CTA owns a slice of 32
// rows of one block row and walks that block row's tiles [row_ptr[r],
// row_ptr[r+1]) itself, in their stored order; the slice's x rows stay in
// shared memory for the whole walk. A warp owns four rows of the slice:
// their running max m (from -1e30), denominator z and accumulator acc
// (KW columns, 4 * NQ a lane) stay in its registers from the first tile
// to the last, and only this warp ever updates them, so the order of
// every sum is fixed (no atomics, no cross-warp sums): deterministic.
// Each tile is streamed once: a warp reads its four rows as 16-byte
// vectors (evict-first; the next tile's rows are prefetched into L2) and
// keeps one bit a nonzero. The warps' counts meet in shared memory (one
// barrier a tile, for the route), then per tile:
//   - edge route (a slice with at most 1 / kDenseDiv of its positions
//     nonzero): the warp lists its nonzeros in (row, column) order and
//     takes them batch() at a time, the batch carried over to the next
//     tiles until it is full, so a warp's per-tile work is about one
//     batch and no other barrier is taken. For a batch every lane issues
//     the loads of the h_j rows (its 4 * NQ columns) and the y_j rows (D
//     in steps of 128, 4 a lane) of all its entries, sums x_i . y_j in
//     order with fma over its columns, then over the warp (xor 16 .. 1:
//     every lane holds the same score), and applies the edge op row by
//     row: for softmax m_new = max(m, the batch's scores of the row),
//     acc and z rescaled by exp(m - m_new) once, then z += p and acc +=
//     p h_j per entry in order, p = exp(s - m_new);
//   - tile route (a denser slice): the dense tile products of the first
//     design, within the same launch. tile_scores.
//     cuh leaves a 32 x bc score tile in registers, four whole rows a
//     warp, so the row max and sum are warp shuffles; p goes to shared
//     memory (transposed, so a float4 broadcast gives a warp its four
//     rows' weights) and p @ h_tile is taken with h staged 32 rows at a
//     time:  m_new = max(m, max_j s_ij (masked: -1e30)), alpha = exp(m -
//     m_new), p_ij = A_ij != 0 ? exp(s_ij - m_new) : 0, z = z alpha +
//     sum_j p_ij, acc = acc alpha + p @ h_tile.
// Both routes update the same registers, so a block row may mix them. A
// row is stored once as acc / max(z, 1e-30): a row with no unmasked entry
// stores 0, every row of every block row is written. Thread 0 writes the
// CTA's tile count of each route to `tally` (one slot a CTA, no atomics).
// One launch covers up to KW = 512 columns of h (NQ = KW / 128 register
// groups); the wrapper launches once per 512 columns of a wider h. Rows of
// x, y and h past x_rows, y_rows and h_rows read as zero. Offsets into
// blocks, x, y, h and out are 64-bit.
#include <cstdint>

#include "tile_scores.cuh"

namespace {

using tile::kRows;
using tile::kThreads;
using tile::kYStride;

constexpr int kWarps = kThreads / 32;
constexpr int kJc = 32;          // h tile rows staged per step (tile route)
constexpr int kPStride = kRows + 4;  // Ps row: 36 floats, 16-byte aligned
constexpr float kNegInf = -1e30f;
// a 32-row slice of a tile with more than 1 / kDenseDiv of its positions
// nonzero takes the tile route (kernels/fusedmm.FUSED_DENSE_DIV). The
// fill sweep of tools/compare_kernels.py (D = K = 256, 61,901 tiles of
// 128 x 128; H100 80GB HBM3, 700 W) timed the edge route alone at 6.0 /
// 11.7 / 20.3 / 36.5 / 67.8 / 191 ms at 0.7 / 2 / 4 / 8 / 16 / 50 % fill
// and the tile route alone at ~57.5 ms at any fill: they cross near 13 %.
constexpr int kDenseDiv = 8;
enum EdgeOp { kSoftmax = 0, kSigmoid = 1, kNone = 2 };

// edge-route entries taken at once (kernels/fusedmm.fused_batch): each
// holds 4 * NQ + 4 floats of loads a lane in flight. On ogbn-proteins
// 1/4 (D = K = 256; H100 80GB HBM3, 700 W) batches of 2 and 8 ran 7 %
// and 32 % slower than 4; 8 with the registers of one CTA an SM, 30 %
template <int NQ>
__host__ __device__ constexpr int batch() { return NQ <= 2 ? 4 : 2; }

template <int NC, int NQ>
__host__ __device__ constexpr int buf_floats() {
  return (NC * 32 * kYStride > kJc * NQ * 128) ? NC * 32 * kYStride
                                               : kJc * NQ * 128;
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, int n,
                                        bool vec) {
  // p[0 .. 3], zero past n; as one 16-byte load where vec
  if (vec) return n >= 4 ? __ldg(reinterpret_cast<const float4*>(p))
                         : zero4();
  return make_float4(n > 0 ? __ldg(p) : 0.f, n > 1 ? __ldg(p + 1) : 0.f,
                     n > 2 ? __ldg(p + 2) : 0.f, n > 3 ? __ldg(p + 3) : 0.f);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// a warp's four rows: running max, denominator and accumulator (row r,
// columns q * 128 + 4 lane + i)
template <int NQ>
struct Rows {
  float acc[4][NQ][4];
  float m[4], z[4];
};

// Apply the first n (<= U) pending edge-route entries of the warp: lane
// u holds entry u's column j (of y and h) in pj and its row (0..3) in pr.
template <int NQ, int U>
__device__ __forceinline__ void apply_edges(
    Rows<NQ>& st, int pj, int pr, int n, const float* Xs,
    const float* __restrict__ y, const float* __restrict__ h, int y_rows,
    int d, int dp, int h_rows, long long h_ld, int kw, int edge_op,
    int vec) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int jj[U], rr[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    jj[u] = __shfl_sync(0xffffffffu, pj, u);
    rr[u] = __shfl_sync(0xffffffffu, pr, u);
  }
  // the h rows first: they do not wait on the scores
  float4 hv[U][NQ];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool live = u < n && jj[u] < h_rows;
    const float* hr = h + (long long)jj[u] * h_ld;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = q * 128 + 4 * lane;
      hv[u][q] = live ? load4(hr + col, kw - col, vec) : zero4();
    }
  }
  // x_i . y_j: lane sums d = d0 + 4 lane + e in order, then the warp
  float s[U];
#pragma unroll
  for (int u = 0; u < U; ++u) s[u] = 0.f;
#pragma unroll 2
  for (int d0 = 0; d0 < dp; d0 += 128) {
    const int dd = d0 + 4 * lane;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = u < n && jj[u] < y_rows && dd < dp;
      const float4 yv =
          live ? load4(y + (long long)jj[u] * d + dd, d - dd, vec) : zero4();
      const float4 xv =
          dd < dp ? *reinterpret_cast<const float4*>(
                        Xs + (4 * w + rr[u]) * dp + dd)
                  : zero4();
      s[u] = fmaf(xv.x, yv.x, s[u]);
      s[u] = fmaf(xv.y, yv.y, s[u]);
      s[u] = fmaf(xv.z, yv.z, s[u]);
      s[u] = fmaf(xv.w, yv.w, s[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) s[u] = tile::warp_sum(s[u]);  // same on all
                                                            // lanes
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (edge_op == kSoftmax) {
      float m_new = st.m[r];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < n && rr[u] == r) m_new = fmaxf(m_new, s[u]);
      if (m_new > st.m[r]) {              // warp-uniform
        const float alpha = expf(st.m[r] - m_new);
        st.z[r] *= alpha;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
#pragma unroll
          for (int i = 0; i < 4; ++i) st.acc[r][q][i] *= alpha;
        }
        st.m[r] = m_new;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n && rr[u] == r) {          // warp-uniform
        const float p = edge_op == kSoftmax ? expf(s[u] - st.m[r])
                        : edge_op == kSigmoid ? 1.f / (1.f + expf(-s[u]))
                                              : s[u];
        if (edge_op == kSoftmax) st.z[r] += p;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          st.acc[r][q][0] = fmaf(p, hv[u][q].x, st.acc[r][q][0]);
          st.acc[r][q][1] = fmaf(p, hv[u][q].y, st.acc[r][q][1]);
          st.acc[r][q][2] = fmaf(p, hv[u][q].z, st.acc[r][q][2]);
          st.acc[r][q][3] = fmaf(p, hv[u][q].w, st.acc[r][q][3]);
        }
      }
    }
  }
}

template <int NC, int NQ>
__global__ void __launch_bounds__(kThreads, 2)
fusedmm_edge_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ blk_col,
                    const float* __restrict__ blocks,
                    const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ h, float* __restrict__ out,
                    int* __restrict__ tally, int slices, int br, int x_rows,
                    int y_rows, int d, int dp, int h_rows, long long h_ld,
                    int kw, long long out_ld, int edge_op, int vec) {
  constexpr int BC = NC * 32;
  constexpr int KW = NQ * 128;
  constexpr int V = BC / 128;            // 16-byte vectors of a row a lane
  constexpr int U = batch<NQ>();
  extern __shared__ __align__(16) float smem[];
  __shared__ int counts[2][kWarps];
  float* Xs = smem;                   // kRows * dp
  float* Ps = Xs + kRows * dp;        // BC * kPStride, Ps[j][row]
  float* buf = Ps + BC * kPStride;    // Ys (scores) or Hs[kJc][KW]
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r_blk = blockIdx.x / slices;
  const int slice = blockIdx.x % slices;
  const long long row0 = (long long)r_blk * br + slice * kRows;
  // published by the first tile's barrier
  tile::stage_x(x, Xs, row0, x_rows, d, dp);
  Rows<NQ> st;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) st.acc[r][q][i] = 0.f;
    }
    st.m[r] = kNegInf;
    st.z[r] = 0.f;
  }
  // the edge route's pending entries (lanes 0 .. npend - 1)
  int pj = 0, pr = 0, npend = 0;

  int tiles_edge = 0, tiles_dense = 0;
  const int b0 = __ldg(row_ptr + r_blk);
  const int b1 = __ldg(row_ptr + r_blk + 1);
  for (int b = b0; b < b1; ++b) {
    const long long col0 = (long long)__ldg(blk_col + b) * BC;
    const float* a_tile =
        blocks + (long long)b * br * BC + (long long)slice * kRows * BC;
    // the next tile's rows of this warp into L2: 4 rows of BC / 32 lines
    if (b + 1 < b1 && lane < 4 * (BC / 32))
      prefetch_l2(a_tile + (long long)br * BC +
                  (4 * w + lane / (BC / 32)) * BC + 32 * (lane % (BC / 32)));
    // this warp's four rows, once: bit (r V + v) 4 + e is column
    // 128 v + 4 lane + e of row 4 w + r
    unsigned bits = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 a = __ldcs(reinterpret_cast<const float4*>(
                                    a_tile + (4 * w + r) * BC) + lane + 32 * v);
        const int at = (r * V + v) * 4;
        bits |= (unsigned)(a.x != 0.f) << at |
                (unsigned)(a.y != 0.f) << (at + 1) |
                (unsigned)(a.z != 0.f) << (at + 2) |
                (unsigned)(a.w != 0.f) << (at + 3);
      }
    }
    const int nz = __reduce_add_sync(0xffffffffu, __popc(bits));
    if (lane == 0) counts[b & 1][w] = nz;
    // the one barrier of a tile; counts is double-buffered: a warp writes
    // the next tile's slot only after every warp has passed this barrier
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += counts[b & 1][i];

    if (total * kDenseDiv > kRows * BC) {
      // ---- tile route: the dense tile products --------------------------
      ++tiles_dense;
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
          const float m_new = fmaxf(st.m[r], tile::warp_max(tmax));
          const float alpha = expf(st.m[r] - m_new);
          float psum = 0.f;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            p[r][c] = mk[r][c] ? expf(p[r][c] - m_new) : 0.f;
            psum += p[r][c];
          }
          st.z[r] = st.z[r] * alpha + tile::warp_sum(psum);
          st.m[r] = m_new;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
#pragma unroll
            for (int i = 0; i < 4; ++i) st.acc[r][q][i] *= alpha;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float sc = p[r][c];
            p[r][c] = !mk[r][c] ? 0.f
                      : edge_op == kSigmoid ? 1.f / (1.f + expf(-sc)) : sc;
          }
        }
      }
      // scores() closed with a barrier: nobody reads Ps from the last
      // dense tile
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
          const float4 pv = *reinterpret_cast<const float4*>(
              Ps + (j0 + jj) * kPStride + 4 * w);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float4 hv = *reinterpret_cast<const float4*>(
                buf + jj * KW + q * 128 + lane * 4);
            const float pr4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              st.acc[r][q][0] = fmaf(pr4[r], hv.x, st.acc[r][q][0]);
              st.acc[r][q][1] = fmaf(pr4[r], hv.y, st.acc[r][q][1]);
              st.acc[r][q][2] = fmaf(pr4[r], hv.z, st.acc[r][q][2]);
              st.acc[r][q][3] = fmaf(pr4[r], hv.w, st.acc[r][q][3]);
            }
          }
        }
      }
      // the next tile's first use of buf (a dense tile's scores) opens
      // with a barrier
    } else {
      // ---- edge route: this warp's nonzeros, batch() at a time ------------
      ++tiles_edge;
#pragma unroll 1
      for (int at = 0; at < 16 * V; ++at) {
        unsigned mask = __ballot_sync(0xffffffffu, (bits >> at) & 1u);
        while (mask) {                    // warp-uniform
          const int l = __ffs(mask) - 1;
          mask &= mask - 1;
          if (lane == npend) {
            pj = static_cast<int>(col0) + 128 * (at / 4 % V) + 4 * l + at % 4;
            pr = at / (4 * V);
          }
          if (++npend == U) {
            apply_edges<NQ, U>(st, pj, pr, U, Xs, y, h, y_rows, d, dp,
                               h_rows, h_ld, kw, edge_op, vec);
            npend = 0;
          }
        }
      }
    }
  }
  if (npend)
    apply_edges<NQ, U>(st, pj, pr, npend, Xs, y, h, y_rows, d, dp, h_rows,
                       h_ld, kw, edge_op, vec);

  if (threadIdx.x == 0) {
    tally[2 * (long long)blockIdx.x] = tiles_edge;
    tally[2 * (long long)blockIdx.x + 1] = tiles_dense;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float zc = edge_op == kSoftmax ? fmaxf(st.z[r], 1e-30f) : 1.f;
    float* orow = out + (row0 + 4 * w + r) * out_ld;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = q * 128 + lane * 4 + i;
        if (col < kw) orow[col] = edge_op == kSoftmax ? st.acc[r][q][i] / zc
                                                      : st.acc[r][q][i];
      }
    }
  }
}

template <int NC, int NQ>
int launch(const int* row_ptr, const int* blk_col, const float* blocks,
           const float* x, const float* y, const float* h, float* out,
           int* tally, int n_brows, int br, int x_rows, int y_rows, int d,
           int h_rows, long long h_ld, int kw, long long out_ld, int edge_op,
           cudaStream_t stream) {
  const int dp = tile::round_depth(d);
  const size_t smem =
      sizeof(float) * ((size_t)kRows * dp + NC * 32 * kPStride +
                       buf_floats<NC, NQ>());
  const int slices = br / kRows;
  const long long ctas = (long long)n_brows * slices;
  if (ctas > 0x7fffffffLL || smem > 232448 - 2 * kWarps * sizeof(int))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads of y and h rows where every row start is aligned
  const int vec = d % 4 == 0 && h_ld % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(h) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      fusedmm_edge_kernel<NC, NQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fusedmm_edge_kernel<NC, NQ>
      <<<static_cast<unsigned>(ctas), kThreads, smem, stream>>>(
          row_ptr, blk_col, blocks, x, y, h, out, tally, slices, br, x_rows,
          y_rows, d, dp, h_rows, h_ld, kw, out_ld, edge_op, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_k(const int* row_ptr, const int* blk_col, const float* blocks,
             const float* x, const float* y, const float* h, float* out,
             int* tally, int n_brows, int br, int x_rows, int y_rows, int d,
             int h_rows, long long h_ld, int kw, long long out_ld,
             int edge_op, cudaStream_t s) {
  switch ((kw + 127) / 128) {
    case 1: return launch<NC, 1>(row_ptr, blk_col, blocks, x, y, h, out,
                                 tally, n_brows, br, x_rows, y_rows, d,
                                 h_rows, h_ld, kw, out_ld, edge_op, s);
    case 2: return launch<NC, 2>(row_ptr, blk_col, blocks, x, y, h, out,
                                 tally, n_brows, br, x_rows, y_rows, d,
                                 h_rows, h_ld, kw, out_ld, edge_op, s);
    case 3: return launch<NC, 3>(row_ptr, blk_col, blocks, x, y, h, out,
                                 tally, n_brows, br, x_rows, y_rows, d,
                                 h_rows, h_ld, kw, out_ld, edge_op, s);
    case 4: return launch<NC, 4>(row_ptr, blk_col, blocks, x, y, h, out,
                                 tally, n_brows, br, x_rows, y_rows, d,
                                 h_rows, h_ld, kw, out_ld, edge_op, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// guarantees: n_brows >= 1, br a positive multiple of 32, bc 128 or 256
// (the tile widths the tuner picks), d >= 0, 1 <= kw <= 512, edge_op 0
// (softmax), 1 (sigmoid) or 2 (none), row_ptr has n_brows + 1 monotone
// entries from 0 to nblocks indexing blk_col and the (nblocks, br, bc)
// tiles (16-byte aligned), x (x_rows, d) and y (y_rows, d) row-major, h
// rows of kw columns h_ld floats apart, out rows of kw columns out_ld
// floats apart (n_brows * br rows), tally 2 * n_brows * br / 32 ints
// (each CTA's tiles on the edge route, then on the tile route), all on
// the current device. The shared memory the launch needs, 4 * (32
// round_up(d, 32) + 36 bc + max(36 bc, 32 * 128 ceil(kw / 128))) bytes,
// must fit a Hopper block's 227 KB beside the kernel's 64 bytes of
// static shared memory, else cudaErrorInvalidValue.
extern "C" int fusedmm_f32(const int* row_ptr, const int* blk_col,
                           const float* blocks, const float* x,
                           const float* y, const float* h, float* out,
                           int* tally, int n_brows, int br, int bc,
                           int x_rows, int y_rows, int d, int h_rows,
                           long long h_ld, int kw, long long out_ld,
                           int edge_op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (br <= 0 || br % kRows != 0 || d < 0 || kw < 1 || kw > 512 ||
      edge_op < kSoftmax || edge_op > kNone)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bc) {
    case 128: return launch_k<4>(row_ptr, blk_col, blocks, x, y, h, out,
                                 tally, n_brows, br, x_rows, y_rows, d,
                                 h_rows, h_ld, kw, out_ld, edge_op, s);
    case 256: return launch_k<8>(row_ptr, blk_col, blocks, x, y, h, out,
                                 tally, n_brows, br, x_rows, y_rows, d,
                                 h_rows, h_ld, kw, out_ld, edge_op, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
