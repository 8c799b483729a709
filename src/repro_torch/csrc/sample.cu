// The device sampling primitives of one k-hop sampling hop, for Hopper.
// Each standalone kernel replaces a TPU kernel of
// src/repro/kernels/sample.py:
//
//   segment_sample   _segment_sample_pallas  per frontier row, `width`
//                    neighbour ranks from the counter-based RNG
//   expand_indptr    _expand_indptr_pallas   start[row] + rank, or sentinel
//   flat_gather      _flat_gather_pallas     arr[pos] over a position table
//
// and sample_hop_kernel fuses the whole hop into one launch: per frontier
// row it reads indptr at the clipped id (degree 0 for the num_nodes
// sentinel), draws the ranks, forms the valid mask, the positions
// start + rank (or the nse sentinel) and gathers indices[pos] and
// val[pos]. The device graph does one launch a hop instead of about ten
// launches and PyTorch ops (two indptr gathers, a subtraction, the rank
// kernel, the mask ops, expand_indptr, two flat_gathers); the positions
// never reach device memory.
//
// The draws (one routine, warp_draw / warp_rank, for both kernels). One
// warp owns a frontier row; lane s holds slots s, s + 32, ... With
// replacement every slot's draw is independent. Without replacement the
// partial virtual Fisher-Yates over [0, deg) keeps an override table
// (keys, vals) of `width` slots: step j draws r_j in [j, deg) and reads
// the permutation's values at r_j and at j through the latest slot below j
// whose key matches. Every r_j depends only on (hash, j, deg), so the
// lanes draw all of them at once and the keys (keys[j] = r_j) are known
// before the first step; only vals chains from step to step. For width
// <= 32 every lookup is one warp vote (__match_any_sync, __ballot_sync)
// plus the highest set bit, and the vals chain resolves by pointer
// jumping (warp_fisher_yates_32). Wider rows take the steps in order,
// each lookup a __ballot_sync over 32 slots below j at a time from the
// top: O(width / 32) a step, where the TPU kernel takes a masked max over
// the row's lanes. The warp's table lives in shared memory (3 x width
// ints: keys, vals, ranks).
//
// expand_indptr and flat_gather stay one thread a slot: bytes, one
// coalesced read of each slot's inputs and one write, plus for flat_gather
// a scattered 4-byte read.
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

constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ uint32_t row_hash(uint32_t seed, uint32_t rnd,
                                             uint32_t hop, int gid) {
  uint32_t h = mix32(seed ^ 0x9E3779B9u);
  h = mix32(h ^ rnd);
  h = mix32(h ^ hop);
  return mix32(h ^ static_cast<uint32_t>(gid));
}

// Fisher-Yates step s's draw r_s in [s, d)
__device__ __forceinline__ int fy_draw(uint32_t h, int s, int d) {
  const float u = bits_to_uniform(mix32(h ^ static_cast<uint32_t>(s)));
  const float span = __fsub_rn(static_cast<float>(d), static_cast<float>(s));
  return s + min(static_cast<int>(floorf(__fmul_rn(u, span))),
                 max(d - s - 1, 0));
}

// With-replacement draw of slot s in [0, d)
__device__ __forceinline__ int replace_draw(uint32_t h, int s, int d) {
  const float u = bits_to_uniform(mix32(h ^ static_cast<uint32_t>(s)));
  return min(static_cast<int>(floorf(__fmul_rn(u, static_cast<float>(d)))),
             max(d - 1, 0));
}

__device__ __forceinline__ bool runs_fisher_yates(int d, int width,
                                                  bool replace) {
  return !replace && d > width;
}

// width <= 32: lane j holds slot j in registers, and no step waits for
// the one before. sr(j), the latest slot below j whose key is r_j, is the
// highest lane below j in __match_any_sync(key); sj(j), the latest slot
// below j whose key is j, the highest lane below j in the ballot of
// key == j (one ballot a slot value). vals then chains only through sj:
// v_j = v_{sj(j)} where sj(j) exists, else j, so v_j is the root of j's
// chain of sj links, found by pointer jumping (five shuffles for 32
// lanes); slot j's rank is v_{sr(j)}, or r_j where sr(j) does not exist.
__device__ __forceinline__ int warp_fisher_yates_32(uint32_t h, int d,
                                                    int width, int lane) {
  const int key = lane < width ? fy_draw(h, lane, d) : -1;
  const unsigned below = (1u << lane) - 1u;
  const unsigned mr = __match_any_sync(kFull, key) & below;
  unsigned mj = 0;
  for (int v = 0; v < width; ++v) {
    const unsigned m = __ballot_sync(kFull, key == v);
    if (lane == v) mj = m;
  }
  mj &= below;
  int root = mj ? 31 - __clz(mj) : lane;
#pragma unroll
  for (int i = 0; i < 5; ++i) root = __shfl_sync(kFull, root, root);
  const int sr = mr ? 31 - __clz(mr) : 0;
  const int vr = __shfl_sync(kFull, root, sr);
  return mr ? vr : key;
}

// A row's draws, by the whole warp (every lane calls it). Without
// replacement and deg > width it fills table[2 * width + s] with slot s's
// rank (table: keys [0, width), vals [width, 2 width), ranks after); the
// other cases need no table (warp_rank computes them).
__device__ __forceinline__ void warp_draw(uint32_t h, int d, int width,
                                          bool replace, int lane,
                                          int* __restrict__ table) {
  if (!runs_fisher_yates(d, width, replace)) return;
  int* keys = table;
  int* vals = table + width;
  int* ranks = table + 2 * width;
  if (width <= 32) {
    const int rank = warp_fisher_yates_32(h, d, width, lane);
    if (lane < width) ranks[lane] = rank;
    __syncwarp();
    return;
  }
  // wider rows: slots s, s + 32, ... a lane, the table in shared memory,
  // one step at a time: a step's two lookups scan 32 slots a ballot from
  // the top
  for (int s = lane; s < width; s += 32) keys[s] = fy_draw(h, s, d);
  __syncwarp();
  for (int j = 0; j < width; ++j) {
    const int rj = keys[j];
    int sr = -1, sj = -1;   // latest slot below j whose key is r_j / j
    for (int g = j > 0 ? (j - 1) >> 5 : -1; g >= 0 && (sr < 0 || sj < 0);
         --g) {
      const int s = (g << 5) + lane;
      const int key = s < j ? keys[s] : -1;
      const unsigned mr = __ballot_sync(kFull, s < j && key == rj);
      const unsigned mj = __ballot_sync(kFull, s < j && key == j);
      if (sr < 0 && mr) sr = (g << 5) + 31 - __clz(mr);
      if (sj < 0 && mj) sj = (g << 5) + 31 - __clz(mj);
    }
    const int vr = sr >= 0 ? vals[sr] : rj;
    const int vj = sj >= 0 ? vals[sj] : j;
    if (lane == 0) {
      vals[j] = vj;
      ranks[j] = vr;
    }
    __syncwarp();
  }
}

// Slot s's rank after warp_draw (any lane, any slot).
__device__ __forceinline__ int warp_rank(uint32_t h, int d, int width,
                                         bool replace, int s,
                                         const int* __restrict__ table) {
  if (replace) return replace_draw(h, s, d);
  if (d <= width) return s;   // every edge kept: identity ranks
  return table[2 * width + s];
}

__global__ void segment_sample_kernel(const int* __restrict__ deg,
                                      const int* __restrict__ gid,
                                      int* __restrict__ out, int f, int width,
                                      uint32_t seed, uint32_t rnd,
                                      uint32_t hop, int replace) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= f) return;   // the whole warp
  int* table = smem + (replace ? 0 : warp * 3 * width);
  const int d = deg[row];
  const uint32_t h = row_hash(seed, rnd, hop, gid[row]);
  warp_draw(h, d, width, replace, lane, table);
  int* orow = out + static_cast<long long>(row) * width;
  for (int s = lane; s < width; s += 32)
    orow[s] = warp_rank(h, d, width, replace, s, table);
}

// One hop for frontier rows [0, f): nbr / evals / valid (f, width).
// full: the whole neighbourhood (fanout None: identity ranks, no draws).
__global__ void sample_hop_kernel(const int* __restrict__ indptr,
                                  int num_nodes,
                                  const int* __restrict__ indices,
                                  const float* __restrict__ val, int nse,
                                  const int* __restrict__ frontier, int f,
                                  int width, int full, uint32_t seed,
                                  uint32_t rnd, uint32_t hop, int replace,
                                  int* __restrict__ nbr,
                                  float* __restrict__ evals,
                                  unsigned char* __restrict__ valid) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= f) return;
  const bool table_free = full || replace;
  int* table = smem + (table_free ? 0 : warp * 3 * width);
  const int g = frontier[row];
  const long long g0 = min(max(static_cast<long long>(g), 0LL),
                           static_cast<long long>(num_nodes));
  const long long g1 = min(max(static_cast<long long>(g) + 1, 0LL),
                           static_cast<long long>(num_nodes));
  const int start = __ldg(indptr + g0);
  const int d = __ldg(indptr + g1) - start;
  uint32_t h = 0;
  if (!full) {
    h = row_hash(seed, rnd, hop, g);
    warp_draw(h, d, width, replace, lane, table);
  }
  const int lim = full ? d : (replace ? (d > 0 ? width : 0) : min(d, width));
  const long long base = static_cast<long long>(row) * width;
  for (int s = lane; s < width; s += 32) {
    const bool ok = s < lim;
    int pos = nse;
    if (ok) pos = start + (full ? s : warp_rank(h, d, width, replace, s, table));
    pos = pos < 0 ? 0 : (pos > nse ? nse : pos);   // mode="clip"
    nbr[base + s] = __ldg(indices + pos);
    evals[base + s] = __ldg(val + pos);
    valid[base + s] = ok;
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
constexpr int kRowWarps = 8;          // warps (rows) a block at most
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;

// Warps a block and dynamic shared memory for rows of `width` slots that
// keep a table (3 x width ints a warp): as many warps as fit the default
// 48 KB, at most kRowWarps; wider tables take one warp a block and opt in
// to the large carve-out. False if one warp's table does not fit.
template <class Kernel>
bool row_config(Kernel kernel, int width, bool table, int* warps,
                int* smem) {
  if (!table) {
    *warps = kRowWarps;
    *smem = 0;
    return true;
  }
  const long long per_warp = 3LL * width * sizeof(int);
  if (per_warp > kMaxSmem) return false;
  long long w = kDefaultSmem / per_warp;
  w = w < 1 ? 1 : (w > kRowWarps ? kRowWarps : w);
  *warps = static_cast<int>(w);
  *smem = static_cast<int>(w * per_warp);
  if (*smem > kDefaultSmem &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem) != cudaSuccess)
    return false;
  return true;
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 on
// success; cudaErrorInvalidValue if a row's table exceeds shared memory).
// The caller guarantees contiguous arrays on the current device, f >= 1,
// width >= 1 and f * width < 2^31.
extern "C" int segment_sample_i32(const int* deg, const int* gid, int* out,
                                  int f, int width, unsigned seed,
                                  unsigned rnd, unsigned hop, int replace,
                                  void* stream) {
  int warps, smem;
  if (!row_config(segment_sample_kernel, width, !replace, &warps, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (f + warps - 1) / warps;
  segment_sample_kernel<<<blocks, warps * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      deg, gid, out, f, width, seed, rnd, hop, replace);
  return static_cast<int>(cudaGetLastError());
}

// indptr (num_nodes + 1,), indices / val (nse + 1,) with the inert
// sentinel edge at nse, frontier (f,); outputs (f, width).
extern "C" int sample_hop_i32(const int* indptr, int num_nodes,
                              const int* indices, const float* val, int nse,
                              const int* frontier, int f, int width, int full,
                              unsigned seed, unsigned rnd, unsigned hop,
                              int replace, int* nbr, float* evals,
                              unsigned char* valid, void* stream) {
  int warps, smem;
  if (!row_config(sample_hop_kernel, width, !(full || replace), &warps,
                  &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (f + warps - 1) / warps;
  sample_hop_kernel<<<blocks, warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      indptr, num_nodes, indices, val, nse, frontier, f, width, full, seed,
      rnd, hop, replace, nbr, evals, valid);
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
