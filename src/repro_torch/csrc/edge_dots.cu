// Per-edge SDDMM for Hopper, fp32, over a COO edge list:
//
//     s[e]  = sum_d x[row[e], d]  * y[col[e], d]     (d < D)
//     s2[e] = sum_k x2[row[e], k] * y2[col[e], k]    (k < K, optional)
//
// for the first n edges. The second product is the same launch over the
// same (row, col) stream: the FusedMM backward needs both the recomputed
// scores s_e = x_row . y_col and dw_e = dout_row . h_col, and reads the
// edge list once for the two. D and K may differ (gat's layer 2 has
// D = K = 112, layer 1 256). Ids outside [0, rows) read zero rows.
//
// It has no Pallas counterpart: the reference computes these dot
// products in XLA (src/repro/core/fusedmm.py's _bwd, and sddmm_coo_ref),
// and this kernel is the port's replacement of the plain gathers,
// products and row sums (kernels/ref.edge_dots) that ran on the card.
//
// What bounds it: bytes. One x and one y row gathered per edge (2 D * 4
// bytes, twice that with the second product), one 4-byte score written;
// the ids are 8 bytes an edge. The COO edges are sorted by row, so
// consecutive edges share x[row] (and x2[row]): those reads hit L1 / L2,
// and only y[col] / y2[col] are real gathers.
//
// Design, from the per-nonzero scaled block SDDMM (csrc/sddmm.cu's
// sddmm_nnz_kernel, where an 8-lane group a nonzero won): an 8-lane
// group owns one edge. Lane t of the group sums d = 32 c + 4 t + e
// (c = 0, 1, ..; e = 0..3) in that order with fma, as 16-byte loads where
// D % 4 == 0 and both matrices are 16-byte aligned (else four scalar
// loads, the same products in the same order), then the group adds its
// eight partial sums over xor 4, 2, 1: a fixed order, so every run gives
// the same bits, with no atomics and no shared memory. A warp holds four
// consecutive edges, a CTA 32. The work is per edge, so a hub row (R-MAT
// graphs have rows of 18,045 entries) spreads over as many groups as it
// has edges and never holds a warp, as a row owner would in FusedMM.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                       // warps a CTA
constexpr int kGroup = 8;                       // lanes an edge
constexpr int kEdges = kWarps * 32 / kGroup;    // edges a CTA
constexpr unsigned kFull = 0xffffffffu;

// Lane t's partial sum of a . b over d = 32 c + 4 t + e, e = 0..3, in
// that order; a or b null reads zero.
template <bool VEC>
__device__ __forceinline__ float lane_dot(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int d, int t) {
  float p = 0.f;
  if (a == nullptr || b == nullptr) return p;
  if (VEC) {                              // d % 4 == 0, rows 16-byte aligned
#pragma unroll 4
    for (int c = 4 * t; c < d; c += 4 * kGroup) {
      const float4 av = __ldg(reinterpret_cast<const float4*>(a + c));
      const float4 bv = __ldg(reinterpret_cast<const float4*>(b + c));
      p = fmaf(av.x, bv.x, p);
      p = fmaf(av.y, bv.y, p);
      p = fmaf(av.z, bv.z, p);
      p = fmaf(av.w, bv.w, p);
    }
  } else {
#pragma unroll 2
    for (int c = 4 * t; c < d; c += 4 * kGroup) {
#pragma unroll
      for (int e = c; e < c + 4; ++e)
        if (e < d) p = fmaf(__ldg(a + e), __ldg(b + e), p);
    }
  }
  return p;
}

// The group's sum of its eight lanes' partial sums, in a fixed tree.
__device__ __forceinline__ float group_sum(float p) {
  p += __shfl_xor_sync(kFull, p, 4);
  p += __shfl_xor_sync(kFull, p, 2);
  p += __shfl_xor_sync(kFull, p, 1);
  return p;
}

__device__ __forceinline__ const float* row_ptr(const float* m, long long n,
                                                int width, long long i) {
  return i >= 0 && i < n ? m + i * width : nullptr;
}

template <bool VEC, bool DUAL, bool VEC2>
__global__ void __launch_bounds__(kWarps * 32)
edge_dots_kernel(const float* __restrict__ x, long long nx,
                 const float* __restrict__ y, long long ny, int d,
                 const float* __restrict__ x2, long long nx2,
                 const float* __restrict__ y2, long long ny2, int k,
                 const int* __restrict__ row, const int* __restrict__ col,
                 long long n, float* __restrict__ s,
                 float* __restrict__ s2) {
  const int t = threadIdx.x % kGroup;
  const long long e = static_cast<long long>(blockIdx.x) * kEdges +
                      threadIdx.x / kGroup;
  long long r = -1, c = -1;
  if (e < n) {
    r = __ldg(row + e);
    c = __ldg(col + e);
  }
  // every lane of the warp takes part in the shuffles, past n too
  const float p = group_sum(lane_dot<VEC>(row_ptr(x, nx, d, r),
                                          row_ptr(y, ny, d, c), d, t));
  float p2 = 0.f;
  if (DUAL)
    p2 = group_sum(lane_dot<VEC2>(row_ptr(x2, nx2, k, r),
                                  row_ptr(y2, ny2, k, c), k, t));
  if (t == 0 && e < n) {
    s[e] = p;
    if (DUAL) s2[e] = p2;
  }
}

template <bool VEC, bool DUAL, bool VEC2>
void launch(const float* x, long long nx, const float* y, long long ny,
            int d, const float* x2, long long nx2, const float* y2,
            long long ny2, int k, const int* row, const int* col,
            long long n, float* s, float* s2, cudaStream_t st) {
  const long long blocks = (n + kEdges - 1) / kEdges;
  edge_dots_kernel<VEC, DUAL, VEC2>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, st>>>(
          x, nx, y, ny, d, x2, nx2, y2, ny2, k, row, col, n, s, s2);
}

}  // namespace

// x (nx, d), y (ny, d) fp32; x2 (nx2, k), y2 (ny2, k) fp32 or null (no
// second product; s2 unused); row, col (n,) int32; s, s2 (n,) fp32.
// vec / vec2 != 0: d / k is a multiple of 4 and x, y / x2, y2 are
// 16-byte aligned. n < 2^31 * 32. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int edge_dots_f32(const float* x, long long nx, const float* y,
                             long long ny, int d, const float* x2,
                             long long nx2, const float* y2, long long ny2,
                             int k, const int* row, const int* col,
                             long long n, float* s, float* s2, int vec,
                             int vec2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool dual = x2 != nullptr;
  if (!dual) {
    if (vec)
      launch<true, false, false>(x, nx, y, ny, d, x2, nx2, y2, ny2, k, row,
                                 col, n, s, s2, st);
    else
      launch<false, false, false>(x, nx, y, ny, d, x2, nx2, y2, ny2, k, row,
                                  col, n, s, s2, st);
  } else if (vec && vec2) {
    launch<true, true, true>(x, nx, y, ny, d, x2, nx2, y2, ny2, k, row, col,
                             n, s, s2, st);
  } else if (vec) {
    launch<true, true, false>(x, nx, y, ny, d, x2, nx2, y2, ny2, k, row, col,
                              n, s, s2, st);
  } else if (vec2) {
    launch<false, true, true>(x, nx, y, ny, d, x2, nx2, y2, ny2, k, row, col,
                              n, s, s2, st);
  } else {
    launch<false, true, false>(x, nx, y, ny, d, x2, nx2, y2, ny2, k, row,
                               col, n, s, s2, st);
  }
  return static_cast<int>(cudaGetLastError());
}
