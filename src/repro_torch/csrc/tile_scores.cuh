// Shared score-tile routine of the BSR edge-score kernels (sddmm.cu,
// fusedmm.cu).
//
// A CTA of kThreads = 256 threads (8 warps) owns kRows = 32 consecutive
// output rows of one block row (a "slice"). Their x rows stay in shared
// memory for the whole block row: Xs[kRows][dp], dp = D rounded up to the
// depth step kDc, zero-filled past D and past the rows x has. For one BSR
// tile of BC = 32 * NC columns starting at y row col0, scores() stages
// the tile's y rows kDc columns of D at a time (Ys[BC][kDc + kYPad]) and
// accumulates in registers
//     s[r][c] = x[row0 + 4 w + r] . y[col0 + lane + 32 c]
// for warp w and lane `lane`: a warp owns four whole rows of the score
// tile, so a row's max and sum are warp reductions. Products are fp32 fma
// on CUDA cores, in the order of D.
#pragma once

#include <cuda_runtime.h>

namespace tile {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 32;      // output rows per CTA: 4 per warp
constexpr int kDc = 32;        // depth (D) staged per step
constexpr int kYPad = 4;       // Ys row stride 36 floats: 16-byte aligned,
                               // float4 reads of 8 lanes hit distinct banks
constexpr int kYStride = kDc + kYPad;

__host__ __device__ constexpr int round_depth(int d) {
  return (d + kDc - 1) / kDc * kDc;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Xs[r][c] = x[row0 + r][c] for r < kRows, c < dp; zero past x_rows and D.
__device__ __forceinline__ void stage_x(const float* __restrict__ x,
                                        float* Xs, long long row0,
                                        int x_rows, int d, int dp) {
  for (int e = threadIdx.x; e < kRows * dp; e += kThreads) {
    const int r = e / dp;
    const int c = e % dp;
    const long long gr = row0 + r;
    Xs[e] = (gr < x_rows && c < d) ? __ldg(x + gr * d + c) : 0.f;
  }
}

// The score tile of the columns [col0, col0 + 32 NC) against the staged
// Xs. Ys is scratch of BC * kYStride floats. A barrier opens every depth
// step and one closes the call, so the caller may use Ys's storage (and
// anything every thread read before the call) freely before and after;
// with dp == 0 the scores are zeros.
template <int NC>
__device__ __forceinline__ void scores(const float* Xs, float* Ys,
                                       const float* __restrict__ y,
                                       long long col0, int y_rows, int d,
                                       int dp, float (&s)[4][NC]) {
  constexpr int BC = NC * 32;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < NC; ++c) s[r][c] = 0.f;
  }
  for (int d0 = 0; d0 < dp; d0 += kDc) {
    __syncthreads();  // the previous step (or the caller) is done with Ys
    for (int e = threadIdx.x; e < BC * kDc; e += kThreads) {
      const int j = e / kDc;
      const int dd = e % kDc;
      const long long gr = col0 + j;
      const int gc = d0 + dd;
      Ys[j * kYStride + dd] =
          (gr < y_rows && gc < d) ? __ldg(y + gr * d + gc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kDc; dd += 4) {
      float4 xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xv[r] = *reinterpret_cast<const float4*>(
            Xs + (4 * w + r) * dp + d0 + dd);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 yv = *reinterpret_cast<const float4*>(
            Ys + (lane + 32 * c) * kYStride + dd);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float t = s[r][c];
          t = fmaf(xv[r].x, yv.x, t);
          t = fmaf(xv[r].y, yv.y, t);
          t = fmaf(xv[r].z, yv.z, t);
          t = fmaf(xv[r].w, yv.w, t);
          s[r][c] = t;
        }
      }
    }
  }
  __syncthreads();  // every warp is done with Ys
}

}  // namespace tile
