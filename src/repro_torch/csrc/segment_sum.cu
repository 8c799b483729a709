// Ordered segment sum for Hopper, fp32:
//
//     out[t, :] (+)= sum_{p in [off[t], off[t+1])} w[p] * src[idx[p], :]
//
// The deterministic replacement of the float index_add_ scatters in the
// port's backwards (the block SpMM transpose, FusedMM's recompute
// backward, the pattern transpose and the max/min subgradient), which
// sum in a different order on every run on the card (atomics). The
// caller sorts the slots by target once (stably, so a target's slots keep
// their order) and passes the segment offsets; this kernel then sums each
// target's slots in slot order with no atomics, so the result depends
// only on the inputs: bitwise repeatable. It has no TPU counterpart (the
// reference's backwards are XLA segment sums).
//
// What bounds it: bytes. One K-wide src row gathered per slot (plus its
// 4-byte index and weight), one output row written per target.
//
// Design. A warp owns a piece of one target's slots: at most S (kChunk)
// slots, so a hub target (R-MAT graphs have rows of 18,045 entries) does
// not hold a launch on one warp. Its lanes stride over K in vectors of V
// floats (V = 4, 2 or 1, picked by the wrapper: 16-byte loads where K %
// 4 == 0 and the rows are aligned), kCh vectors a lane per pass. Each
// lane loads one of 32 slots' (index, weight) pairs and __shfl_sync
// broadcasts them; the rows of kInFlight slots are loaded together
// before their products are added in slot order, so the next slots'
// rows are in flight while the current one is summed. Products and sums
// are single-rounded (__fmul_rn, __fadd_rn) to match the plain version
// (a product tensor, then index_add_) bit for bit wherever a target's
// slots fit one piece. Slots whose index is outside [0, n_src) add
// nothing.
//
// The pieces, as in sell_spmm.cu: a target's first S slots are one
// piece, stored straight to out[t] (added to it when accumulating); a
// longer target is cut into chunks of S slots from its first slot. With
// windows of S slots over the sorted slot axis, at most one chunk other
// than a target's first starts in each window, and it belongs to the
// target that holds the window's first slot (found by bisection over
// the offsets), so a launch has one work item per window and one per
// target, window items first (hub chunks start early). Those chunks store
// partial rows to a workspace row per window; a second kernel adds a
// long target's partials to out[t] in chunk order. No host sync: the
// workspace is sized by the slot count.
//
// K == 1 (the scalar sums: softmax denominators, row sums) takes its own
// kernel: a warp's lanes stride over the piece's slots and a fixed
// shuffle tree adds their partial sums, still one fixed order.
//
// Offsets and positions are 64-bit.
#include "spmm_common.cuh"

namespace {

constexpr int kChunk = 256;   // S: slots a work item sums
constexpr int kWarps = 8;     // warps a block
constexpr int kCh = 2;        // vectors a lane a pass over K
constexpr int kInFlight = 4;  // slots whose rows are loaded together
constexpr unsigned kFull = 0xffffffffu;

struct Piece {
  int t;           // target
  long long p0;    // slots [p0, p1)
  long long p1;
  long long slot;  // workspace row of the partial sum, -1: out[t]
};

__device__ __forceinline__ long long offset_at(const long long* off, int i,
                                              long long n_slots) {
  const long long o = __ldg(off + i);
  return o < 0 ? 0 : (o > n_slots ? n_slots : o);
}

// The piece of work item `item`: items [0, nwin) are windows of S slots,
// the rest targets. False for a window in which no later chunk starts.
__device__ __forceinline__ bool piece_of(long long item,
                                         const long long* __restrict__ off,
                                         int n_targets, long long n_slots,
                                         long long nwin, Piece& pc) {
  if (item < nwin) {
    const long long w0 = item * kChunk;
    if (offset_at(off, 0, n_slots) > w0) return false;
    int lo = 0, hi = n_targets;   // the last t with off[t] <= w0
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (offset_at(off, mid, n_slots) <= w0) lo = mid; else hi = mid - 1;
    }
    if (lo >= n_targets) return false;
    const long long o0 = offset_at(off, lo, n_slots);
    const long long o1 = offset_at(off, lo + 1, n_slots);
    const long long j = (w0 - o0 + kChunk - 1) / kChunk;
    const long long c = o0 + j * kChunk;
    if (j < 1 || c >= o1 || c >= w0 + kChunk) return false;
    pc.t = lo;
    pc.p0 = c;
    pc.p1 = min(c + kChunk, o1);
    pc.slot = item;
    return true;
  }
  const long long t = item - nwin;
  if (t >= n_targets) return false;
  pc.t = static_cast<int>(t);
  pc.p0 = offset_at(off, pc.t, n_slots);
  const long long o1 = offset_at(off, pc.t + 1, n_slots);
  pc.p1 = max(pc.p0, min(pc.p0 + kChunk, o1));
  pc.slot = -1;
  return true;
}

template <int V>
__device__ __forceinline__ void add_vec(float* acc, typename spmm::Vec<V>::T x,
                                        float w) {
  const float* p = reinterpret_cast<const float*>(&x);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(w, p[i]));
}

template <int V>
__device__ __forceinline__ void load_vec(float* acc,
                                         const typename spmm::Vec<V>::T* p) {
  const typename spmm::Vec<V>::T x = *p;
  const float* q = reinterpret_cast<const float*>(&x);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = q[i];
}

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const float* __restrict__ src, long long n_src,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   const long long* __restrict__ off, float* __restrict__ out,
                   float* __restrict__ ws, int n_targets, int k,
                   long long n_slots, long long nwin, int accumulate) {
  using VT = typename spmm::Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps +
                         (threadIdx.x >> 5);
  Piece pc;
  if (!piece_of(item, off, n_targets, n_slots, nwin, pc)) return;
  const bool first = pc.slot < 0;
  if (first && accumulate && pc.p0 == pc.p1) return;   // adds nothing
  float* dst = first ? out + static_cast<long long>(pc.t) * k
                     : ws + pc.slot * k;
  const bool from_dst = first && accumulate;
  const int nvec = k / V;
  for (int vbase = 0; vbase < nvec; vbase += 32 * kCh) {
    float acc[kCh * V];
#pragma unroll
    for (int q = 0; q < kCh; ++q) {
      const int v = vbase + q * 32 + lane;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[q * V + i] = 0.f;
      if (from_dst && v < nvec)
        load_vec<V>(acc + q * V, reinterpret_cast<const VT*>(dst) + v);
    }
    for (long long d0 = pc.p0; d0 < pc.p1; d0 += 32) {
      long long my_i = -1;
      float my_w = 1.f;
      if (d0 + lane < pc.p1) {
        my_i = idx ? static_cast<long long>(__ldg(idx + d0 + lane)) : d0 + lane;
        if (w) my_w = __ldg(w + d0 + lane);
      }
      unsigned live = __ballot_sync(kFull, my_i >= 0 && my_i < n_src);
      while (live) {
        long long c[kInFlight];
        float cw[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {   // the next live slots
          const int j = live ? __ffs(live) - 1 : 0;
          c[u] = live ? __shfl_sync(kFull, my_i, j) : -1;
          cw[u] = __shfl_sync(kFull, my_w, j);
          live &= live - 1;
        }
        VT x[kInFlight][kCh];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const VT* row = reinterpret_cast<const VT*>(src + c[u] * k);
#pragma unroll
          for (int q = 0; q < kCh; ++q) {
            const int v = vbase + q * 32 + lane;
            if (c[u] >= 0 && v < nvec) x[u][q] = __ldg(row + v);
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
          for (int q = 0; q < kCh; ++q) {
            const int v = vbase + q * 32 + lane;
            if (c[u] >= 0 && v < nvec) add_vec<V>(acc + q * V, x[u][q], cw[u]);
          }
        }
      }
    }
    spmm::store_row<V, kCh>(dst, k, vbase, lane, acc);
  }
}

// K == 1: the lanes stride over the piece's slots, then a fixed tree.
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel_scalar(const float* __restrict__ src, long long n_src,
                          const int* __restrict__ idx,
                          const float* __restrict__ w,
                          const long long* __restrict__ off,
                          float* __restrict__ out, float* __restrict__ ws,
                          int n_targets, long long n_slots, long long nwin,
                          int accumulate) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps +
                         (threadIdx.x >> 5);
  Piece pc;
  if (!piece_of(item, off, n_targets, n_slots, nwin, pc)) return;
  const bool first = pc.slot < 0;
  if (first && accumulate && pc.p0 == pc.p1) return;
  float acc = 0.f;
  for (long long p = pc.p0 + lane; p < pc.p1; p += 32) {
    const long long c = idx ? static_cast<long long>(__ldg(idx + p)) : p;
    if (c >= 0 && c < n_src)
      acc = __fadd_rn(acc, __fmul_rn(w ? __ldg(w + p) : 1.f, __ldg(src + c)));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(kFull, acc, o));
  if (lane != 0) return;
  if (!first) {
    ws[pc.slot] = acc;
  } else {
    out[pc.t] = accumulate ? __fadd_rn(out[pc.t], acc) : acc;
  }
}

// out[t] += the partial rows of target t's later chunks, in chunk order.
template <int V>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel_reduce(const long long* __restrict__ off,
                          float* __restrict__ out,
                          const float* __restrict__ ws, int n_targets, int k,
                          long long n_slots) {
  using VT = typename spmm::Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const long long t = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  if (t >= n_targets) return;
  const long long o0 = offset_at(off, static_cast<int>(t), n_slots);
  const long long o1 = offset_at(off, static_cast<int>(t) + 1, n_slots);
  if (o1 - o0 <= kChunk) return;
  float* dst = out + t * k;
  const int nvec = k / V;
  for (int v = lane; v < nvec; v += 32) {
    float acc[V];
    load_vec<V>(acc, reinterpret_cast<const VT*>(dst) + v);
    for (long long c = o0 + kChunk; c < o1; c += kChunk) {
      float part[V];
      load_vec<V>(part, reinterpret_cast<const VT*>(ws + (c / kChunk) * k) + v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
    spmm::store_vec<V>(reinterpret_cast<VT*>(dst) + v, acc);
  }
}

template <int V>
int launch(const float* src, long long n_src, const int* idx, const float* w,
           const long long* off, float* out, float* ws, int n_targets, int k,
           long long n_slots, int accumulate, cudaStream_t s) {
  const long long nwin = ws ? (n_slots + kChunk - 1) / kChunk : 0;
  const long long items = nwin + n_targets;
  if (items > 0) {
    const long long blocks = (items + kWarps - 1) / kWarps;
    if (k == 1) {
      segment_sum_kernel_scalar<<<static_cast<unsigned>(blocks), kWarps * 32,
                                  0, s>>>(src, n_src, idx, w, off, out, ws,
                                          n_targets, n_slots, nwin,
                                          accumulate);
    } else {
      segment_sum_kernel<V><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                              s>>>(src, n_src, idx, w, off, out, ws,
                                   n_targets, k, n_slots, nwin, accumulate);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (ws && n_targets > 0) {
    const long long blocks = (static_cast<long long>(n_targets) + kWarps - 1) /
                             kWarps;
    segment_sum_kernel_reduce<V><<<static_cast<unsigned>(blocks),
                                   kWarps * 32, 0, s>>>(off, out, ws,
                                                        n_targets, k, n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (n_targets, k) fp32; src (n_src, k) fp32; idx (n_slots,) int32 or
// null (slot p reads src row p); w (n_slots,) fp32 or null (weight 1);
// off (n_targets + 1,) int64, nondecreasing (read clamped into [0,
// n_slots]); ws (ceil(n_slots / 256), k) fp32, or null when n_slots <=
// 256. accumulate != 0 adds to out (targets without slots keep their
// row), else out is overwritten (0 where a target has no slot). vec is 4,
// 2 or 1 and divides k, and src, out and ws are 4 * vec-byte aligned.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int segment_sum_f32(const float* src, long long n_src,
                               const int* idx, const float* w,
                               const long long* off, float* out, float* ws,
                               int n_targets, int k, long long n_slots,
                               int vec, int accumulate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return launch<4>(src, n_src, idx, w, off, out, ws, n_targets, k, n_slots,
                     accumulate, s);
  if (vec == 2)
    return launch<2>(src, n_src, idx, w, off, out, ws, n_targets, k, n_slots,
                     accumulate, s);
  return launch<1>(src, n_src, idx, w, off, out, ws, n_targets, k, n_slots,
                   accumulate, s);
}
