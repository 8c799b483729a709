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
// stored slot, 2K flops against 4K bytes. What held the first design back
// was not the bytes but the skew of real graphs: one warp walked all of a
// row's slots, each load waiting for the one before, so the hub row of
// reddit (30,614 slots) alone set the time of a launch (~0.5 us a slot,
// one memory round trip).
//
// Design: GPU blocks run in no order, so nothing is carried between
// blocks. A warp owns one sorted row (s, c) of one piece of its slice's
// steps, at most `chunk` (S) steps long, so a block of min(C, 32) warps
// owns a piece of a slice (times one K tile). Within the piece the lanes
// gather kInFlight live slots at a time (spmm_common.cuh): their loads are
// issued together and their fma's run in slot order. Sentinel slots
// (idx == ncols), including the padding steps appended to the last slice,
// are skipped; pad rows (perm >= nrows) store nothing.
//
// The pieces. A slice of at most S steps is one piece: its warps store
// the sum straight to the original row perm[s*C + c] (the un-sort fused
// into the store). A longer slice is cut into chunks of S steps from its
// first step; each chunk's warps store a partial row into a workspace,
// and a second kernel (sell_spmm_kernel_reduce) sums a row's partials in
// chunk order and stores the sum to perm[s*C + c]. The cut needs no scan
// and no host sync: with windows of S steps over the packed step axis,
// at most one chunk other than a slice's first starts in each window (the
// S steps before it belong to its own slice), and it belongs to the
// slice holding the window's first step. So the launch has one work item
// per window (the chunk starting in it, if any) and one per slice (the
// slice's first chunk), both found from the slice pointers and slice_of
// in O(1); the workspace holds two partial rows a window: slot 2w for the
// chunk starting in window w, 2w + 1 for the first chunk of a long slice
// starting in it (at most one: the next slice starts more than S steps
// later). The reducer of a long slice is the item of the window in which
// its last chunk starts. Window items come first in the grid, so the hub
// chunks start first; the K tile is the fastest grid index.
//
// No atomics and a fixed order (slots in order within a chunk, chunks in
// order), so the result depends only on the operand: bitwise repeatable.
// Offsets into idx/val, h, out and the workspace are 64-bit.
#include "spmm_common.cuh"

namespace {

constexpr int kChunks = 2;    // vectors per lane per K tile
// live slots whose h rows a lane loads at once. On a reddit-shaped
// operand (K = 602, C = 8; H100 80GB HBM3, 700 W) 1 and 4 time the same
// once long slices are split (the other warps of the SM hide the
// latency); 8 is slower, 1.14x at K = 602 and 5.8x at K = 256 (not
// examined; a 1024-thread block allows 64 registers a thread)
constexpr int kInFlight = 4;

struct Piece {
  int s;           // slice
  long long t0;    // steps [t0, t1)
  long long t1;
  long long slot;  // workspace slot of the partial row, -1: store to out
};

// The piece of work item `item`: items [0, nwin) are windows, the rest
// slices. False for a window in which no later chunk starts.
__device__ __forceinline__ bool piece_of(long long item,
                                         const int* __restrict__ ptr,
                                         const int* __restrict__ slice_of,
                                         int n_steps, int chunk, int nwin,
                                         Piece& p) {
  if (item < nwin) {
    const long long tw = item * chunk;
    if (tw >= n_steps) return false;
    p.s = __ldg(slice_of + tw);
    const long long p0 = __ldg(ptr + p.s);
    const long long p1 = __ldg(ptr + p.s + 1);
    if (p0 >= tw) return false;          // the slice's first chunk
    const long long j = (tw - p0 + chunk - 1) / chunk;
    p.t0 = p0 + j * chunk;
    if (p.t0 >= tw + chunk || p.t0 >= p1) return false;
    p.t1 = p.t0 + chunk < p1 ? p.t0 + chunk : p1;
    p.slot = 2 * item;
    return true;
  }
  p.s = static_cast<int>(item - nwin);
  p.t0 = __ldg(ptr + p.s);
  const long long p1 = __ldg(ptr + p.s + 1);
  p.t1 = p.t0 + chunk < p1 ? p.t0 + chunk : p1;
  p.slot = p1 - p.t0 > chunk ? 2 * (p.t0 / chunk) + 1 : -1;
  return true;
}

// grid.x = items * groups * ktiles, the K tile fastest; a block holds
// min(C, 32) warps, group g the rows [32 g, 32 g + 32) of the slice
template <int V>
__global__ void __launch_bounds__(1024)
sell_spmm_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                 const int* __restrict__ slice_ptr,
                 const int* __restrict__ slice_of,
                 const int* __restrict__ perm, const float* __restrict__ h,
                 float* __restrict__ out, float* __restrict__ ws, int c,
                 int nrows, int ncols, int k, int n_steps, int chunk,
                 int nwin, int groups, int ktiles) {
  const int lane = threadIdx.x & 31;
  const int kt = static_cast<int>(blockIdx.x % ktiles);
  const long long ig = blockIdx.x / ktiles;
  const int r = static_cast<int>(ig % groups) * 32 + (threadIdx.x >> 5);
  if (r >= c) return;                    // warp-uniform
  Piece p;
  if (!piece_of(ig / groups, slice_ptr, slice_of, n_steps, chunk, nwin, p))
    return;
  const int dst = __ldg(perm + (long long)p.s * c + r);
  if (dst < 0 || dst >= nrows) return;   // degree-0 pad row
  const int vbase = kt * 32 * kChunks;
  float acc[kChunks * V];
#pragma unroll
  for (int i = 0; i < kChunks * V; ++i) acc[i] = 0.f;
  spmm::gather_row<V, kChunks, kInFlight>(
      idx + p.t0 * c + r, val + p.t0 * c + r, c,
      static_cast<int>(p.t1 - p.t0), h, ncols, k, vbase, lane, acc);
  float* row = p.slot < 0 ? out + (long long)dst * k
                          : ws + (p.slot * c + r) * k;
  spmm::store_row<V, kChunks>(row, k, vbase, lane, acc);
}

// grid.x = nwin * groups * ktiles: window w's item reduces the slice
// whose last chunk starts in it, partials in chunk order
template <int V>
__global__ void __launch_bounds__(1024)
sell_spmm_kernel_reduce(const int* __restrict__ slice_ptr,
                        const int* __restrict__ slice_of,
                        const int* __restrict__ perm,
                        const float* __restrict__ ws, float* __restrict__ out,
                        int c, int nrows, int k, int n_steps, int chunk,
                        int nwin, int groups, int ktiles) {
  using VT = typename spmm::Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const int kt = static_cast<int>(blockIdx.x % ktiles);
  const long long ig = blockIdx.x / ktiles;
  const int r = static_cast<int>(ig % groups) * 32 + (threadIdx.x >> 5);
  if (r >= c) return;
  Piece p;
  if (!piece_of(ig / groups, slice_ptr, slice_of, n_steps, chunk, nwin, p))
    return;
  if (p.t1 < __ldg(slice_ptr + p.s + 1)) return;  // not the last chunk
  const int dst = __ldg(perm + (long long)p.s * c + r);
  if (dst < 0 || dst >= nrows) return;
  const long long p0 = __ldg(slice_ptr + p.s);
  const int nvec = k / V;
  const int vbase = kt * 32 * kChunks;
  float acc[kChunks * V];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int v = vbase + q * 32 + lane;
    const VT* first = reinterpret_cast<const VT*>(
        ws + ((2 * (p0 / chunk) + 1) * c + r) * k);
    VT x{};
    if (v < nvec) x = first[v];
    const float* xs = reinterpret_cast<const float*>(&x);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[q * V + i] = xs[i];
  }
  for (long long t = p0 + chunk; t <= p.t0; t += chunk) {
    const VT* part =
        reinterpret_cast<const VT*>(ws + (2 * (t / chunk) * c + r) * k);
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int v = vbase + q * 32 + lane;
      if (v < nvec) {
        const VT x = part[v];
        const float* xs = reinterpret_cast<const float*>(&x);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[q * V + i] += xs[i];
      }
    }
  }
  spmm::store_row<V, kChunks>(out + (long long)dst * k, k, vbase, lane, acc);
}

template <int V>
int launch(const int* idx, const float* val, const int* slice_ptr,
           const int* slice_of, const int* perm, const float* h, float* out,
           float* ws, int nslices, int c, int nrows, int ncols, int k,
           int n_steps, int chunk, int nwin, cudaStream_t stream) {
  const int warps = c < 32 ? c : 32;
  const int groups = (c + 31) / 32;
  const int ktiles = (k / V + 32 * kChunks - 1) / (32 * kChunks);
  const long long blocks =
      ((long long)nwin + nslices) * groups * ktiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sell_spmm_kernel<V><<<static_cast<unsigned>(blocks), warps * 32, 0,
                        stream>>>(idx, val, slice_ptr, slice_of, perm, h, out,
                                  ws, c, nrows, ncols, k, n_steps, chunk,
                                  nwin, groups, ktiles);
  if (nwin > 0) {
    sell_spmm_kernel_reduce<V>
        <<<static_cast<unsigned>((long long)nwin * groups * ktiles),
           warps * 32, 0, stream>>>(slice_ptr, slice_of, perm, ws, out, c,
                                    nrows, k, n_steps, chunk, nwin, groups,
                                    ktiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch(es) (0 on success). The
// caller guarantees: nslices >= 1, c >= 1, k >= 1, k % vec == 0, chunk >=
// 1; slice_ptr has nslices + 1 monotone entries from 0 to n_steps and
// slice_of (n_steps,) the slice of every step (monotone, consistent with
// slice_ptr); nwin == 0 only if no slice has more than chunk steps (the
// row route: every slice is one piece and ws may be null), else nwin =
// ceil(n_steps / chunk) and ws holds 2 * nwin * c rows of k floats (the
// split route: a second kernel sums the partial rows); h, out and ws
// aligned to vec * 4 bytes, all arrays contiguous on the current device.
extern "C" int sell_spmm_f32(const int* idx, const float* val,
                             const int* slice_ptr, const int* slice_of,
                             const int* perm, const float* h, float* out,
                             float* ws, int nslices, int c, int nrows,
                             int ncols, int k, int vec, int n_steps,
                             int chunk, int nwin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || nwin < 0 || (nwin > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (vec) {
    case 4: return launch<4>(idx, val, slice_ptr, slice_of, perm, h, out, ws,
                             nslices, c, nrows, ncols, k, n_steps, chunk,
                             nwin, s);
    case 2: return launch<2>(idx, val, slice_ptr, slice_of, perm, h, out, ws,
                             nslices, c, nrows, ncols, k, n_steps, chunk,
                             nwin, s);
    case 1: return launch<1>(idx, val, slice_ptr, slice_of, perm, h, out, ws,
                             nslices, c, nrows, ncols, k, n_steps, chunk,
                             nwin, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
