// ELLPACK SpMM (sum semiring) for Hopper, fp32:
//     out[r, :] = sum_d val[r, d] * h[idx[r, d], :]    (idx == ncols: pad)
//
// Replaces the TPU kernel ell_spmm_pallas (src/repro/kernels/ell_spmm.py).
// That kernel walks a (nrows, max_deg) grid in order, DMAs one h row per
// step into a resident (1, K) accumulator, and first pads h to a multiple
// of 128 lanes and appends a zero row for the sentinel -- two copies of
// all of h on every call.
//
// What bounds it here: bytes. Each slot reads one K-wide fp32 row of h
// (4K bytes) for 2K flops, far below the card's flop/byte balance, so the
// kernel is a gather whose time is the rows it fetches from device memory
// (h rows shared between output rows hit in L2).
//
// Design: one warp per output row, lanes across K in 16-byte (float4) or
// 8-byte (float2) vectors, the row's slots in order, the sum kept in fp32
// registers and stored once. Sentinel slots are skipped, so h is read in
// place with no padding copy, whatever K is (K = 602 takes the float2
// path) and whatever ncols is (rectangular blocks are the normal case).
// No atomics and a fixed slot order: results are deterministic.
#include "spmm_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunks = 2;  // vectors per lane per K tile

template <int V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const float* __restrict__ h, float* __restrict__ out,
                int nrows, int max_deg, int ncols, int k) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= nrows) return;  // warp-uniform
  const int vbase = blockIdx.y * 32 * kChunks;
  float acc[kChunks * V];
#pragma unroll
  for (int i = 0; i < kChunks * V; ++i) acc[i] = 0.f;
  spmm::gather_row<V, kChunks>(idx + row * max_deg, val + row * max_deg, 1,
                               max_deg, h, ncols, k, vbase, lane, acc);
  spmm::store_row<V, kChunks>(out + row * k, k, vbase, lane, acc);
}

template <int V>
void launch(const int* idx, const float* val, const float* h, float* out,
            int nrows, int max_deg, int ncols, int k, cudaStream_t stream) {
  const int nvec = k / V;
  dim3 grid((nrows + kWarpsPerBlock - 1) / kWarpsPerBlock,
            (nvec + 32 * kChunks - 1) / (32 * kChunks));
  ell_spmm_kernel<V><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      idx, val, h, out, nrows, max_deg, ncols, k);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). The caller
// guarantees: nrows >= 1, max_deg >= 1, k >= 1, k % vec == 0, h and out
// aligned to vec * 4 bytes, all arrays contiguous on the current device.
extern "C" int ell_spmm_f32(const int* idx, const float* val, const float* h,
                            float* out, int nrows, int max_deg, int ncols,
                            int k, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: launch<4>(idx, val, h, out, nrows, max_deg, ncols, k, s); break;
    case 2: launch<2>(idx, val, h, out, nrows, max_deg, ncols, k, s); break;
    case 1: launch<1>(idx, val, h, out, nrows, max_deg, ncols, k, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
