// SELL-C-sigma SpMM (sum semiring) for Hopper, fp32:
//     out[perm[s*C + c], :] = sum_{t in slice s} val[t, c] * h[idx[t, c], :]
//
// Replaces the TPU kernel sell_spmm_pallas (src/repro/kernels/sell_spmm.py).
// That kernel relies on the TPU's sequential grid: a (C, K) accumulator
// stays resident across the packed steps of a slice, zero-initialised on
// first_step, and a separate out[inv_perm] gather un-sorts the rows
// afterwards (plus the same K-pad and zero-row copies of h as the ELL
// kernel).
//
// What bounds it here: bytes, as for ELL -- one K-wide fp32 row of h per
// stored slot, 2K flops against 4K bytes.
//
// Design: GPU blocks run in no order, so nothing is carried between
// blocks. One warp owns one sorted row (s, c) and loops over all of its
// slice's steps [slice_ptr[s], slice_ptr[s+1]) in order, so a block of
// C warps owns a whole slice (times one K tile) for C <= 32. The sum
// stays in fp32 registers and is stored once, straight to its original
// row perm[s*C + c]: the un-sort is fused into the store, and pad rows
// (perm >= nrows) store nothing. Sentinel slots (idx == ncols), including
// the padding steps appended to the last slice, are skipped. No atomics:
// results are deterministic.
#include "spmm_common.cuh"

namespace {

constexpr int kChunks = 2;  // vectors per lane per K tile

template <int V>
__global__ void __launch_bounds__(1024)
sell_spmm_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                 const int* __restrict__ slice_ptr,
                 const int* __restrict__ perm, const float* __restrict__ h,
                 float* __restrict__ out, int nslices, int c, int nrows,
                 int ncols, int k) {
  const int lane = threadIdx.x & 31;
  const long long gw =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (gw >= (long long)nslices * c) return;  // warp-uniform
  const int dst = __ldg(perm + gw);
  if (dst < 0 || dst >= nrows) return;       // degree-0 pad row
  const int s = static_cast<int>(gw / c);
  const int r = static_cast<int>(gw % c);
  const int t0 = __ldg(slice_ptr + s);
  const int t1 = __ldg(slice_ptr + s + 1);
  const int vbase = blockIdx.y * 32 * kChunks;
  float acc[kChunks * V];
#pragma unroll
  for (int i = 0; i < kChunks * V; ++i) acc[i] = 0.f;
  spmm::gather_row<V, kChunks>(idx + (long long)t0 * c + r,
                               val + (long long)t0 * c + r, c, t1 - t0, h,
                               ncols, k, vbase, lane, acc);
  spmm::store_row<V, kChunks>(out + (long long)dst * k, k, vbase, lane, acc);
}

template <int V>
void launch(const int* idx, const float* val, const int* slice_ptr,
            const int* perm, const float* h, float* out, int nslices, int c,
            int nrows, int ncols, int k, cudaStream_t stream) {
  const int warps = c < 32 ? c : 32;
  const long long rows = (long long)nslices * c;
  const int nvec = k / V;
  dim3 grid(static_cast<unsigned>((rows + warps - 1) / warps),
            (nvec + 32 * kChunks - 1) / (32 * kChunks));
  sell_spmm_kernel<V><<<grid, warps * 32, 0, stream>>>(
      idx, val, slice_ptr, perm, h, out, nslices, c, nrows, ncols, k);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// guarantees: nslices >= 1, c >= 1, k >= 1, k % vec == 0, slice_ptr has
// nslices + 1 monotone entries ending at n_steps, h and out aligned to
// vec * 4 bytes, all arrays contiguous on the current device.
extern "C" int sell_spmm_f32(const int* idx, const float* val,
                             const int* slice_ptr, const int* perm,
                             const float* h, float* out, int nslices, int c,
                             int nrows, int ncols, int k, int vec,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: launch<4>(idx, val, slice_ptr, perm, h, out, nslices, c, nrows,
                      ncols, k, s); break;
    case 2: launch<2>(idx, val, slice_ptr, perm, h, out, nslices, c, nrows,
                      ncols, k, s); break;
    case 1: launch<1>(idx, val, slice_ptr, perm, h, out, nslices, c, nrows,
                      ncols, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
