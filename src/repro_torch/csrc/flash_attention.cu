// Causal / sliding-window flash attention with GQA for Hopper (LM prefill):
//     out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / rep, j]) v[b, h / rep, j]
// over the keys j kept by the masks, query i at absolute position
// q_offset + i with q_offset = T - S (queries aligned to the end of the KV
// axis): j <= q_offset + i when causal, j > q_offset + i - window when a
// window is given. q (B, Hq, S, D), k / v (B, Hkv, T, D), out in q's type.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py). There the grid's innermost KV
// axis runs in order, so the (bq, D) accumulator and the row max and sum
// stay resident in VMEM across it, and fully masked KV tiles are skipped
// by a pl.when on the tile-level test.
//
// What bounds it here: operations (4 D flops a kept (query, key) pair
// against 2 D elements read per key for a whole tile of queries), the
// tensor cores for bf16. The simple design below is far from that bound:
// wgmma, TMA staging and a warp-specialised pipeline come later.
//
// Design: blocks run in no order, so one CTA owns one (batch x query
// head, 64-query tile) pair and walks its KV tiles itself: only the tiles
// the causal and window tests keep (the Pallas kernel's skip), from the
// first key inside the window of its first query to the last key its last
// query sees. The KV head is h / rep: a KV tile is read once per query
// head and never repeated in memory. Q, K and V tiles sit in shared
// memory; the scores, row max, row sum and the accumulator are fp32. Four
// warps own 16 query rows each, two threads a row (32 score columns and
// D / 2 accumulator columns each, in registers), so the row max and sum
// are one shuffle and a warp touches only its own rows (__syncwarp
// between the steps of a tile). bf16: S = Q K^T and P V by WMMA
// (mma.sync 16 x 16 x 16, fp32 accumulation, P rounded to bf16 as the
// plain version rounds it); fp32: the same steps on the CUDA cores, the
// instance the card tests hold to ~1e-5. Masked scores are -1e30 and
// weigh exactly 0; the output is acc / max(z, 1e-30), so a row with no
// kept key is 0. Any S <= T (ragged last tiles zero-filled and masked),
// causal or not, any window, D in {32, 64, 128}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64;           // queries per CTA
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 128;     // 4 warps x 16 rows, 2 threads a row
constexpr float kNeg = -1e30f;

template <typename T, int D>
struct Layout {
  static constexpr bool kTc = std::is_same<T, bf16>::value;
  static constexpr int kVec = 16 / sizeof(T);    // elements per 16 bytes
  static constexpr int kLdX = D + kVec;          // Q, K, V rows (padded)
  static constexpr int kLdS = kBK + 4;           // fp32 scores / weights
  static constexpr int kLdO = D + 4;             // fp32 P V tile (bf16)
  static constexpr int kLdP = kBK + 8;           // bf16 weights
  // a warp's fp32 scratch: its 16 score rows, then (bf16) its P V rows
  static constexpr int kScratch = 16 * (kLdS > kLdO ? kLdS : kLdO);
  static constexpr size_t kBytes =
      3 * (size_t)kBQ * kLdX * sizeof(T) +
      (size_t)(kThreads / 32) * kScratch * sizeof(float) +
      (kTc ? (size_t)kBQ * kLdP * sizeof(bf16) : 0);
};

template <typename T>
__device__ __forceinline__ float to_f(T x) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(x);
  else return x;
}

template <typename T>
__device__ __forceinline__ T from_f(float x) {
  if constexpr (std::is_same<T, bf16>::value) return __float2bfloat16(x);
  else return x;
}

// rows [row0, row0 + kBQ) of a (rows, D) matrix into a padded tile; rows
// past n_rows read zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row0, long long n_rows) {
  using L = Layout<T, D>;
  constexpr int kPerRow = D / L::kVec;
  for (int c = threadIdx.x; c < kBQ * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * L::kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      v = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * D + col));
    *reinterpret_cast<uint4*>(dst + r * L::kLdX + col) = v;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int s, int t, int causal, int has_window,
                       long long window, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBQ * L::kLdX;
  T* Vs = Ks + kBK * L::kLdX;
  float* scratch = reinterpret_cast<float*>(Vs + kBK * L::kLdX);
  bf16* Ps = reinterpret_cast<bf16*>(scratch + (kThreads / 32) * L::kScratch);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r = tid >> 1;            // query row of the tile
  const int rl = lane >> 1;          // ... within the warp's 16
  const int half = tid & 1;          // score columns half*32.., acc half*D/2..
  float* ws = scratch + warp * L::kScratch;

  const int bh = blockIdx.x;
  const long long b = bh / hq;
  const long long kvh = (bh % hq) / (hq / hkv);
  const int i0 = blockIdx.y * kBQ;
  const long long q_offset = (long long)t - s;
  const T* qb = q + (long long)bh * s * D;
  const T* kb = k + (b * hkv + kvh) * t * D;
  const T* vb = v + (b * hkv + kvh) * t * D;

  load_tile<T, D>(Qs, qb, i0, s);

  // KV tiles kept by the tile-level causal and window tests
  const long long qlo = q_offset + i0;
  const long long qhi = q_offset + min(i0 + kBQ, s) - 1;
  long long klo = 0, khi = (long long)t - 1;
  if (causal) khi = min(khi, qhi);
  if (has_window) klo = max(klo, qlo - window + 1);
  const int kt0 = (int)(klo / kBK);
  const int kt1 = khi >= klo ? (int)(khi / kBK) : kt0 - 1;

  const long long qpos = q_offset + i0 + r;
  float m = kNeg, z = 0.f;
  float o[D / 2];
#pragma unroll
  for (int c = 0; c < D / 2; ++c) o[c] = 0.f;

  for (int kt = kt0; kt <= kt1; ++kt) {
    const long long kpos0 = (long long)kt * kBK;
    __syncthreads();                 // every warp is done with the last K, V
    load_tile<T, D>(Ks, kb, kpos0, t);
    load_tile<T, D>(Vs, vb, kpos0, t);
    __syncthreads();

    float sc[32];
    if constexpr (L::kTc) {
      // the warp's 16 rows of Q K^T into its scratch
      const bf16* qt = reinterpret_cast<const bf16*>(Qs) + warp * 16 * L::kLdX;
      const bf16* ktile = reinterpret_cast<const bf16*>(Ks);
#pragma unroll
      for (int n = 0; n < kBK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(a, qt + kk, L::kLdX);
          wmma::load_matrix_sync(bk, ktile + n * 16 * L::kLdX + kk, L::kLdX);
          wmma::mma_sync(acc, a, bk, acc);
        }
        wmma::store_matrix_sync(ws + n * 16, acc, L::kLdS,
                                wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = ws[rl * L::kLdS + half * 32 + j];
    } else {
      const T* qrow = Qs + r * L::kLdX;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const T* krow = Ks + (half * 32 + j) * L::kLdX;
        float acc = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc = fmaf(to_f(qrow[d]), to_f(krow[d]),
                                               acc);
        sc[j] = acc;
      }
    }

    // scale, mask, online softmax over this tile (two threads a row)
    unsigned keep = 0u;
    float tmax = kNeg;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const long long kpos = kpos0 + half * 32 + j;
      const bool ok = kpos < t && (!causal || kpos <= qpos) &&
                      (!has_window || kpos > qpos - window);
      sc[j] = ok ? sc[j] * scale : kNeg;
      keep |= (ok ? 1u : 0u) << j;
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = (keep >> j) & 1u ? expf(sc[j] - m_new) : 0.f;
      sum += p;
      if constexpr (L::kTc) Ps[r * L::kLdP + half * 32 + j] = __float2bfloat16(p);
      else ws[rl * L::kLdS + half * 32 + j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    z = z * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o[c] *= alpha;
    __syncwarp();

    // o += P V for the thread's D / 2 columns
    if constexpr (L::kTc) {
      const bf16* pt = Ps + warp * 16 * L::kLdP;
      const bf16* vt = reinterpret_cast<const bf16*>(Vs);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
          wmma::load_matrix_sync(a, pt + kk, L::kLdP);
          wmma::load_matrix_sync(bv, vt + kk * L::kLdX + n * 16, L::kLdX);
          wmma::mma_sync(acc, a, bv, acc);
        }
        wmma::store_matrix_sync(ws + n * 16, acc, L::kLdO,
                                wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] += ws[rl * L::kLdO + half * (D / 2) + c];
    } else {
      const float* prow = ws + rl * L::kLdS;
      for (int j = 0; j < kBK; ++j) {
        const float p = prow[j];
        const T* vrow = Vs + j * L::kLdX + half * (D / 2);
#pragma unroll
        for (int c = 0; c < D / 2; ++c) o[c] = fmaf(p, to_f(vrow[c]), o[c]);
      }
    }
    __syncwarp();
  }

  if (i0 + r < s) {
    const float zz = fmaxf(z, 1e-30f);
    T* orow = out + ((long long)bh * s + i0 + r) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = from_f<T>(o[c] / zz);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int hq, int hkv, int s, int t, int causal, int has_window,
           long long window, float scale, cudaStream_t stream) {
  constexpr size_t kBytes = Layout<T, D>::kBytes;
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)bh, (unsigned)((s + kBQ - 1) / kBQ));
  flash_attention_kernel<T, D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, s, t, causal,
      has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               int bh, int hq, int hkv, int s, int t, int d, int causal,
               int has_window, long long window, float scale,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, out, bh, hq, hkv, s, t, causal,
                           has_window, window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, bh, hq, hkv, s, t, causal,
                           has_window, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, bh, hq, hkv, s, t, causal,
                            has_window, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bh = B * Hq CTAs along x (the wrapper checks the limits), Hq % Hkv == 0,
// S <= T, 16-byte aligned contiguous operands.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int bh, int hq,
                                    int hkv, int s, int t, int d, int causal,
                                    int has_window, long long window,
                                    float scale, cudaStream_t stream) {
  return dispatch_d<bf16>(q, k, v, out, bh, hq, hkv, s, t, d, causal,
                          has_window, window, scale, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int bh, int hq,
                                   int hkv, int s, int t, int d, int causal,
                                   int has_window, long long window,
                                   float scale, cudaStream_t stream) {
  return dispatch_d<float>(q, k, v, out, bh, hq, hkv, s, t, d, causal,
                           has_window, window, scale, stream);
}
