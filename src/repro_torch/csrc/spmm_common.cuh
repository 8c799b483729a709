// Shared pieces of the gather SpMM kernels (ell_spmm.cu, sell_spmm.cu).
//
// A warp owns one output row. Its 32 lanes stride over the row's K
// columns in vectors of V floats (V = 4, 2 or 1, picked by the wrapper so
// that V divides K and every row start is V*4-byte aligned), CH vectors a
// lane per K tile; the tile index is blockIdx.y. The neighbor loop walks
// the row's slots in order, 32 at a time: each lane loads one slot's
// (index, weight) pair, a ballot marks the real (non-sentinel) ones, and
// __shfl_sync broadcasts them, so the slot table is read once per warp
// and coalesced where the layout allows. With U > 1 a lane issues the
// loads of U live slots' h vectors before their fma's (U gathered rows in
// flight instead of one); the fma's still run in slot order, so the sum
// is the same for every U.
#pragma once

#include <cuda_runtime.h>

namespace spmm {

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int V>
__device__ __forceinline__ void fma_vec(float* acc, typename Vec<V>::T x,
                                        float w) {
  const float* p = reinterpret_cast<const float*>(&x);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = fmaf(w, p[i], acc[i]);
}

template <int V>
__device__ __forceinline__ void store_vec(typename Vec<V>::T* dst,
                                          const float* acc) {
  typename Vec<V>::T x;
  float* p = reinterpret_cast<float*>(&x);
#pragma unroll
  for (int i = 0; i < V; ++i) p[i] = acc[i];
  *dst = x;
}

// Accumulate the slots {slot_idx[s * stride], slot_val[s * stride]} for
// s in [0, n_slots) into acc[CH * V], in slot order: acc[q*V + i] holds
// column (vbase + q*32 + lane) * V + i. Slots whose index is outside
// [0, ncols) (the sentinel) are skipped; the ballot makes the skip
// warp-uniform. U live slots are taken at a time: their (index, weight)
// pairs are broadcast, every lane issues all U x CH vector loads, then
// adds them in slot order.
template <int V, int CH, int U = 1>
__device__ __forceinline__ void gather_row(
    const int* __restrict__ slot_idx, const float* __restrict__ slot_val,
    long long stride, int n_slots, const float* __restrict__ h, int ncols,
    int k, int vbase, int lane, float* acc) {
  using VT = typename Vec<V>::T;
  const int nvec = k / V;
  for (int d0 = 0; d0 < n_slots; d0 += 32) {
    int my_c = ncols;
    float my_w = 0.f;
    if (d0 + lane < n_slots) {
      my_c = __ldg(slot_idx + (long long)(d0 + lane) * stride);
      my_w = __ldg(slot_val + (long long)(d0 + lane) * stride);
    }
    // one vote per 32 slots: sentinel slots (and lanes past n_slots) are
    // never visited, so bucket padding costs a load, not a loop trip
    unsigned live = __ballot_sync(0xffffffffu, my_c >= 0 && my_c < ncols);
    while (live) {
      int c[U];
      float w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {    // the next U live slots, in order
        const int j = live ? __ffs(live) - 1 : 0;
        c[u] = live ? __shfl_sync(0xffffffffu, my_c, j) : -1;
        w[u] = __shfl_sync(0xffffffffu, my_w, j);
        live &= live - 1;
      }
      VT hv[U][CH];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const VT* hrow = reinterpret_cast<const VT*>(h + (long long)c[u] * k);
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int v = vbase + q * 32 + lane;
          if (c[u] >= 0 && v < nvec) hv[u][q] = __ldg(hrow + v);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < CH; ++q) {
          const int v = vbase + q * 32 + lane;
          if (c[u] >= 0 && v < nvec) fma_vec<V>(acc + q * V, hv[u][q], w[u]);
        }
      }
    }
  }
}

template <int V, int CH>
__device__ __forceinline__ void store_row(float* __restrict__ out_row, int k,
                                          int vbase, int lane,
                                          const float* acc) {
  using VT = typename Vec<V>::T;
  const int nvec = k / V;
  VT* orow = reinterpret_cast<VT*>(out_row);
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int v = vbase + q * 32 + lane;
    if (v < nvec) store_vec<V>(orow + v, acc + q * V);
  }
}

}  // namespace spmm
