// The three device sampling primitives of one k-hop sampling hop, for
// Hopper. Each replaces a TPU kernel of src/repro/kernels/sample.py:
//
//   segment_sample   _segment_sample_pallas  per frontier row, `width`
//                    neighbour ranks from the counter-based RNG
//   expand_indptr    _expand_indptr_pallas   start[row] + rank, or sentinel
//   flat_gather      _flat_gather_pallas     arr[pos] over a position table
//
// The TPU kernels work in 8-row sublane tiles (segment_sample,
// expand_indptr) and route one 128-lane row of the array per grid step by
// scalar prefetch (flat_gather). Here every primitive is one thread per
// row or per slot; nothing is staged, since each value is used once.
//
// What bounds them: segment_sample is integer work, O(width^2) operations
// per row without replacement (each step scans the row's override table
// twice) against a handful of bytes, so it is bound by the SMs' int32 rate;
// one thread owns a row and keeps its table in registers / local memory for
// width <= 32 and in shared memory beyond, interleaved by thread so that a
// warp's accesses hit 32 banks. expand_indptr and flat_gather are bytes:
// one coalesced read of each slot's inputs and one write, plus for
// flat_gather a scattered 4-byte read of the gathered array.
//
// Bitwise contract: the draws equal the reference's XLA and Pallas paths
// bit for bit. uint32 multiplies wrap natively; the bits-to-uniform scale
// and u * span are single-rounded fp32 multiplies (__fmul_rn, so no FMA is
// contracted into them; the build keeps --use_fast_math off); the override
// lookup takes the LATEST slot whose key matches, as the reference's max
// over slot indices does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// exact [0, 1) float from the top 24 bits: a 24-bit integer converts
// exactly and the power-of-two scale is exact
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
}

// One row's override table: slot s of this thread's row.
struct LocalTable {
  int keys[32];
  int vals[32];
  __device__ __forceinline__ int& key(int s) { return keys[s]; }
  __device__ __forceinline__ int& val(int s) { return vals[s]; }
};

struct SharedTable {
  int* keys;  // [width][blockDim.x], this thread's column
  int* vals;
  int stride;
  __device__ __forceinline__ int& key(int s) { return keys[s * stride]; }
  __device__ __forceinline__ int& val(int s) { return vals[s * stride]; }
};

// Partial virtual Fisher-Yates over [0, d): step j draws r in [j, d) and
// swaps positions j and r of a permutation that exists only as the
// overrides written so far (key = position, val = its value).
template <class Table>
__device__ __forceinline__ void fisher_yates(Table& t, uint32_t hrow, int d,
                                             int width, int* __restrict__ out) {
  const float degf = static_cast<float>(d);
  for (int j = 0; j < width; ++j) {
    const float u = bits_to_uniform(mix32(hrow ^ static_cast<uint32_t>(j)));
    const float span = __fsub_rn(degf, static_cast<float>(j));
    const int r = j + min(static_cast<int>(floorf(__fmul_rn(u, span))),
                          max(d - j - 1, 0));
    int v_r = r, v_j = j;
    for (int s = 0; s < j; ++s) {  // forward: the latest match wins
      const int k = t.key(s);
      if (k == r) v_r = t.val(s);
      if (k == j) v_j = t.val(s);
    }
    t.key(j) = r;
    t.val(j) = v_j;
    out[j] = v_r;
  }
}

template <bool kShared>
__global__ void segment_sample_kernel(const int* __restrict__ deg,
                                      const int* __restrict__ gid,
                                      int* __restrict__ out, int f, int width,
                                      uint32_t seed, uint32_t rnd,
                                      uint32_t hop, int replace) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= f) return;
  const int d = deg[row];
  int* orow = out + static_cast<long long>(row) * width;
  uint32_t h = mix32(seed ^ 0x9E3779B9u);
  h = mix32(h ^ rnd);
  h = mix32(h ^ hop);
  h = mix32(h ^ static_cast<uint32_t>(gid[row]));
  if (replace) {
    const float degf = static_cast<float>(d);
    const int top = max(d - 1, 0);
    for (int s = 0; s < width; ++s) {
      const float u = bits_to_uniform(mix32(h ^ static_cast<uint32_t>(s)));
      orow[s] = min(static_cast<int>(floorf(__fmul_rn(u, degf))), top);
    }
    return;
  }
  if (d <= width) {  // every edge kept: identity ranks
    for (int s = 0; s < width; ++s) orow[s] = s;
    return;
  }
  if constexpr (kShared) {
    extern __shared__ int smem[];
    SharedTable t{smem + threadIdx.x, smem + width * blockDim.x + threadIdx.x,
                  static_cast<int>(blockDim.x)};
    fisher_yates(t, h, d, width, orow);
  } else {
    LocalTable t;
    fisher_yates(t, h, d, width, orow);
  }
}

__global__ void expand_indptr_kernel(const int* __restrict__ start,
                                     const int* __restrict__ ranks,
                                     const unsigned char* __restrict__ valid,
                                     int* __restrict__ out, long long n,
                                     int width, int sentinel) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  out[i] = valid[i] ? start[i / width] + ranks[i] : sentinel;
}

__global__ void flat_gather_kernel(const uint32_t* __restrict__ arr,
                                   long long n_arr,
                                   const int* __restrict__ pos,
                                   uint32_t* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  long long p = pos[i];
  p = p < 0 ? 0 : (p >= n_arr ? n_arr - 1 : p);  // mode="clip"
  out[i] = __ldg(arr + p);
}

constexpr int kThreads = 256;
constexpr int kSampleThreads = 128;
constexpr int kMaxSmem = 232448;

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 on
// success). The caller guarantees contiguous arrays on the current device,
// f >= 1, width >= 1 and f * width < 2^31.
extern "C" int segment_sample_i32(const int* deg, const int* gid, int* out,
                                  int f, int width, unsigned seed,
                                  unsigned rnd, unsigned hop, int replace,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (replace || width <= 32) {
    const int blocks = (f + kSampleThreads - 1) / kSampleThreads;
    segment_sample_kernel<false><<<blocks, kSampleThreads, 0, s>>>(
        deg, gid, out, f, width, seed, rnd, hop, replace);
    return static_cast<int>(cudaGetLastError());
  }
  // width > 32: two int tables of `width` per thread in shared memory;
  // as many whole warps as fit, at most kSampleThreads
  const long long per_thread = 2LL * width * sizeof(int);
  int threads = static_cast<int>(kMaxSmem / per_thread) / 32 * 32;
  if (threads > kSampleThreads) threads = kSampleThreads;
  if (threads < 32) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(threads * per_thread);
  cudaError_t err = cudaFuncSetAttribute(
      segment_sample_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (f + threads - 1) / threads;
  segment_sample_kernel<true><<<blocks, threads, smem, s>>>(
      deg, gid, out, f, width, seed, rnd, hop, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int expand_indptr_i32(const int* start, const int* ranks,
                                 const unsigned char* valid, int* out, int f,
                                 int width, int sentinel, void* stream) {
  const long long n = static_cast<long long>(f) * width;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  expand_indptr_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      start, ranks, valid, out, n, width, sentinel);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flat_gather_b32(const uint32_t* arr, long long n_arr,
                               const int* pos, uint32_t* out, long long n,
                               void* stream) {
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  flat_gather_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(arr, n_arr, pos,
                                                             out, n);
  return static_cast<int>(cudaGetLastError());
}
