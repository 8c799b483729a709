// Backward of causal / sliding-window flash attention with GQA for Hopper
// (LM training). With the forward's mask (query i at absolute position
// q_offset + i, q_offset = T - S; key j kept when j <= q_offset + i if
// causal and j > q_offset + i - window if windowed), the forward's row
// log-sum-exp lse_i of the scaled scores and s = scale * q . k:
//     P_ij  = exp(scale q_i . k_j - lse_i) on kept pairs, 0 elsewhere
//     D_i   = dO_i . O_i
//     dS_ij = P_ij (dO_i . v_j - D_i)
//     dV_j  = sum_i P_ij dO_i           dK_j = scale sum_i dS_ij q_i
//     dQ_i  = scale sum_j dS_ij k_j
// summed over the G = Hq / Hkv query heads that share a KV head for dK, dV.
// q, o, dO (B, Hq, S, D), k, v (B, Hkv, T, D), lse fp32 (B, Hq, S); dq, dk,
// dv in the inputs' type.
//
// Replaces no TPU kernel: the reference differentiates chunked_attention
// (src/repro/models/lm/attention.py:37) in XLA, and flash_attention_pallas
// has no custom_vjp. The port's training step runs its forward through
// flash_attention.cu, so its gradient is this kernel.
//
// What bounds it: operations. Five products of 2 D flops a kept (query,
// key) pair (S and dP recomputed, dV, dK, dQ) against one read of q, k, v,
// o, dO and one write of dq, dk, dv; the tensor cores for bf16.
//
// Design (simple and deterministic; wgmma, TMA and overlap are later work):
//   1. flash_bwd_delta_kernel: D_i = rowsum(dO o O) in fp32, a warp a row.
//   2. flash_bwd_dkdv_kernel: one CTA per (batch x KV head, 64-key tile).
//      K and V stay in shared memory; the CTA walks the G query heads of
//      its group and, in order, the 64-query tiles that can see its keys.
//      For each it recomputes S = Q K^T and dP = dO V^T, forms P and dS on
//      the tile, and accumulates dV += P^T dO and dK += dS^T Q in
//      registers; it writes dK (times scale) and dV once.
//   3. flash_bwd_dq_kernel: one CTA per (batch x query head, 64-query
//      tile) over its visible key tiles: S, dP, dS again, dQ += dS K.
// No atomics and fixed loop orders: two launches give the same bits.
// The bf16 instance runs the products on the tensor cores with WMMA
// (16 x 16 x 16, fp32 accumulation) from padded shared-memory tiles, P and
// dS rounded to bf16 as operands (as the plain version rounds them); the
// fp32 instance runs them on the CUDA cores (the fp32 smoke config and
// the card tests). The scale multiplies the fp32 product, as the forward
// kernel does. 256 threads, one CTA an SM for D = 128.
//
// Any S <= T, causal or not, any window, D in {32, 64, 128}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kB = 64;            // queries a query tile, keys a key tile
constexpr int kThreads = 256;     // 8 warps
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPad = 4;  // 16 bytes a padded row
  __device__ static float from(float x) { return x; }
  __device__ static float to_f(float x) { return x; }
};
template <> struct Elem<bf16> {
  static constexpr int kPad = 8;
  __device__ static bf16 from(float x) { return __float2bfloat16(x); }
  __device__ static float to_f(bf16 x) { return __bfloat162float(x); }
};

// shared memory: Q | dO | K | V (T, kB x kLdX), S | dP (fp32, kB x kLdS),
// P | dS (T, kB x kLdP), lse * log2 e | D (fp32, kB each). Every region is
// a multiple of 128 bytes, so every WMMA pointer is 32-byte aligned. The
// accumulators are staged through S | dP at the end (kB x (D + 4) fp32).
template <typename T, int D>
struct Smem {
  static constexpr int kLdX = D + Elem<T>::kPad;
  static constexpr int kLdS = kB + 4;
  static constexpr int kLdP = kB + Elem<T>::kPad;
  static constexpr int kLdSt = D + 4;
  static constexpr int kX = kB * kLdX;
  static constexpr size_t kBytes = 4 * (size_t)kX * sizeof(T) +
                                   2 * (size_t)kB * kLdS * sizeof(float) +
                                   2 * (size_t)kB * kLdP * sizeof(T) +
                                   2 * (size_t)kB * sizeof(float);
  static_assert(kB * kLdSt <= 2 * kB * kLdS, "staging exceeds S | dP");
};

// ---- the tile products -----------------------------------------------------

// bf16 on the tensor cores: a 64 x D accumulator over 8 warps, warp w owns
// rows 16 (w / 2) .. + 16 and columns 16 (kNF (w % 2) + f), f < kNF
template <int D>
struct TcMath {
  using T = bf16;
  using L = Smem<T, D>;
  static constexpr int kNF = D / 32;
  struct Acc {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[kNF];
  };
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

  __device__ static void zero(Acc& a) {
#pragma unroll
    for (int f = 0; f < kNF; ++f) wmma::fill_fragment(a.f[f], 0.f);
  }
  // out (64 x 64 fp32) = A B^T, A and B (64 x D)
  __device__ static void abt(float* out, const T* A, const T* B) {
    const int w = threadIdx.x >> 5, rb = w >> 1;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int cb = (w & 1) * 2 + f;
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + rb * 16 * L::kLdX + kk, L::kLdX);
        wmma::load_matrix_sync(b, B + cb * 16 * L::kLdX + kk, L::kLdX);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(out + rb * 16 * L::kLdS + cb * 16, c, L::kLdS,
                              wmma::mem_row_major);
    }
  }
  // acc (64 x D) += P^T X, P (64 x 64), X (64 x D)
  __device__ static void acc_tn(Acc& acc, const T* P, const T* X) {
    const int w = threadIdx.x >> 5, rb = w >> 1;
#pragma unroll
    for (int ii = 0; ii < kB; ii += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a;
      wmma::load_matrix_sync(a, P + ii * L::kLdP + rb * 16, L::kLdP);
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(
            b, X + ii * L::kLdX + ((w & 1) * kNF + f) * 16, L::kLdX);
        wmma::mma_sync(acc.f[f], a, b, acc.f[f]);
      }
    }
  }
  // acc (64 x D) += P X
  __device__ static void acc_nn(Acc& acc, const T* P, const T* X) {
    const int w = threadIdx.x >> 5, rb = w >> 1;
#pragma unroll
    for (int jj = 0; jj < kB; jj += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, P + rb * 16 * L::kLdP + jj, L::kLdP);
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(
            b, X + jj * L::kLdX + ((w & 1) * kNF + f) * 16, L::kLdX);
        wmma::mma_sync(acc.f[f], a, b, acc.f[f]);
      }
    }
  }
  // st (64 x D fp32, ld D + 4) = acc
  __device__ static void stage(float* st, const Acc& acc) {
    const int w = threadIdx.x >> 5, rb = w >> 1;
#pragma unroll
    for (int f = 0; f < kNF; ++f)
      wmma::store_matrix_sync(st + rb * 16 * L::kLdSt +
                                  ((w & 1) * kNF + f) * 16,
                              acc.f[f], L::kLdSt, wmma::mem_row_major);
  }
};

// fp32 on the CUDA cores: thread t owns accumulator row t / 4, columns
// t % 4 + 4 c (c < D / 4), and score row t / 4, columns t % 4 + 4 m
// (m < 16). With rows padded by 4 words, a warp's reads fall in distinct
// banks or broadcast.
template <int D>
struct CcMath {
  using T = float;
  using L = Smem<T, D>;
  static constexpr int kNC = D / 4;
  struct Acc {
    float v[kNC];
  };

  __device__ static void zero(Acc& a) {
#pragma unroll
    for (int c = 0; c < kNC; ++c) a.v[c] = 0.f;
  }
  __device__ static void abt(float* out, const T* A, const T* B) {
    const int i = threadIdx.x >> 2, j0 = threadIdx.x & 3;
    float s[16];
#pragma unroll
    for (int m = 0; m < 16; ++m) s[m] = 0.f;
    const T* arow = A + i * L::kLdX;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a = arow[d];
#pragma unroll
      for (int m = 0; m < 16; ++m)
        s[m] = fmaf(a, B[(j0 + 4 * m) * L::kLdX + d], s[m]);
    }
#pragma unroll
    for (int m = 0; m < 16; ++m) out[i * L::kLdS + j0 + 4 * m] = s[m];
  }
  __device__ static void acc_tn(Acc& acc, const T* P, const T* X) {
    const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;
#pragma unroll 4
    for (int i = 0; i < kB; ++i) {
      const float p = P[i * L::kLdP + r];
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        acc.v[c] = fmaf(p, X[i * L::kLdX + c0 + 4 * c], acc.v[c]);
    }
  }
  __device__ static void acc_nn(Acc& acc, const T* P, const T* X) {
    const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      const float p = P[r * L::kLdP + j];
#pragma unroll
      for (int c = 0; c < kNC; ++c)
        acc.v[c] = fmaf(p, X[j * L::kLdX + c0 + 4 * c], acc.v[c]);
    }
  }
  __device__ static void stage(float* st, const Acc& acc) {
    const int r = threadIdx.x >> 2, c0 = threadIdx.x & 3;
#pragma unroll
    for (int c = 0; c < kNC; ++c) st[r * L::kLdSt + c0 + 4 * c] = acc.v[c];
  }
};

// ---- shared pieces ---------------------------------------------------------

// rows [row0, row0 + kB) of a (rows, D) matrix into a padded tile, 16
// bytes a load; rows past n_rows read zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row0, long long n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < kB * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows)
      val = __ldg(reinterpret_cast<const uint4*>(src + (row0 + r) * D + col));
    *reinterpret_cast<uint4*>(dst + r * Smem<T, D>::kLdX + col) = val;
  }
}

// lse (times log2 e) and D of the query tile's rows; rows past s read 0
__device__ __forceinline__ void load_rows(float* lse2, float* dl,
                                          const float* lse, const float* delta,
                                          long long base, int i0, int s) {
  if (threadIdx.x < kB) {
    const int row = i0 + threadIdx.x;
    lse2[threadIdx.x] = row < s ? lse[base + row] * kLog2e : 0.f;
    dl[threadIdx.x] = row < s ? delta[base + row] : 0.f;
  }
}

// P (kWriteP) and dS of a 64 x 64 tile, in T, from the fp32 scores S and
// dP: zero where the pair is masked or past S or T
template <typename T, int D, bool kWriteP>
__device__ __forceinline__ void softmax_grad(
    const float* S, const float* dP, const float* lse2, const float* dl,
    T* P, T* dS, long long qpos0, int q_rows, long long kpos0, long long t,
    int causal, int has_window, long long window, float scale_log2) {
  using L = Smem<T, D>;
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int i = e / kB, j = e % kB;
    const long long qpos = qpos0 + i, kpos = kpos0 + j;
    const bool ok = i < q_rows && kpos < t && (!causal || kpos <= qpos) &&
                    (!has_window || kpos > qpos - window);
    float p = 0.f, ds = 0.f;
    if (ok) {
      p = exp2f(S[i * L::kLdS + j] * scale_log2 - lse2[i]);
      ds = p * (dP[i * L::kLdS + j] - dl[i]);
    }
    if constexpr (kWriteP) P[i * L::kLdP + j] = Elem<T>::from(p);
    dS[i * L::kLdP + j] = Elem<T>::from(ds);
  }
}

// rows [0, n_rows) of the staged 64 x D accumulator, times `scale`, to
// dst rows row0 ..
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* dst, const float* st,
                                           long long row0, int n_rows,
                                           float scale) {
  for (int e = threadIdx.x; e < n_rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[(row0 + r) * D + c] =
        Elem<T>::from(st[r * Smem<T, D>::kLdSt + c] * scale);
  }
}

// ---- kernels ---------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(Elem<T>::to_f(o[row * D + d]), Elem<T>::to_f(dout[row * D + d]),
               acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename Math, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const typename Math::T* __restrict__ q,
                      const typename Math::T* __restrict__ k,
                      const typename Math::T* __restrict__ v,
                      const typename Math::T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      typename Math::T* __restrict__ dk,
                      typename Math::T* __restrict__ dv, int hq, int hkv,
                      int s, int t, int causal, int has_window,
                      long long window, float scale) {
  using T = typename Math::T;
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + L::kX;
  T* Ks = dOs + L::kX;
  T* Vs = Ks + L::kX;
  float* Ss = reinterpret_cast<float*>(Vs + L::kX);
  float* dPs = Ss + kB * L::kLdS;
  T* Ps = reinterpret_cast<T*>(dPs + kB * L::kLdS);
  T* dSs = Ps + kB * L::kLdP;
  float* lse2 = reinterpret_cast<float*>(dSs + kB * L::kLdP);
  float* dl = lse2 + kB;

  const int bkv = blockIdx.x;                 // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int groups = hq / hkv;
  const long long k0 = (long long)blockIdx.y * kB;
  const long long q_offset = (long long)t - s;
  load_tile<T, D>(Ks, k + (long long)bkv * t * D, k0, t);
  load_tile<T, D>(Vs, v + (long long)bkv * t * D, k0, t);

  // the query rows that see a key of this tile
  const long long kmax = min(k0 + kB, (long long)t) - 1;
  long long ilo = 0, ihi = (long long)s - 1;
  if (causal) ilo = max(ilo, k0 - q_offset);
  if (has_window) ihi = min(ihi, kmax + window - 1 - q_offset);
  const int qt0 = (int)(ilo / kB);
  const int qt1 = ihi >= ilo ? (int)(ihi / kB) : qt0 - 1;
  const float scale_log2 = scale * kLog2e;

  typename Math::Acc adk, adv;
  Math::zero(adk);
  Math::zero(adv);
  for (int g = 0; g < groups; ++g) {
    const long long bh = (long long)b * hq + kvh * groups + g;
    for (int qt = qt0; qt <= qt1; ++qt) {
      const int i0 = qt * kB;
      __syncthreads();          // every warp is done with the last tile
      load_tile<T, D>(Qs, q + bh * s * D, i0, s);
      load_tile<T, D>(dOs, dout + bh * s * D, i0, s);
      load_rows(lse2, dl, lse, delta, bh * s, i0, s);
      __syncthreads();
      Math::abt(Ss, Qs, Ks);
      Math::abt(dPs, dOs, Vs);
      __syncthreads();
      softmax_grad<T, D, true>(Ss, dPs, lse2, dl, Ps, dSs, q_offset + i0,
                               min(kB, s - i0), k0, t, causal, has_window,
                               window, scale_log2);
      __syncthreads();
      Math::acc_tn(adv, Ps, dOs);
      Math::acc_tn(adk, dSs, Qs);
    }
  }
  const int n_rows = (int)(min(k0 + kB, (long long)t) - k0);
  const long long out0 = (long long)bkv * t + k0;
  __syncthreads();
  Math::stage(Ss, adk);
  __syncthreads();
  write_rows<T, D>(dk, Ss, out0, n_rows, scale);
  __syncthreads();
  Math::stage(Ss, adv);
  __syncthreads();
  write_rows<T, D>(dv, Ss, out0, n_rows, 1.f);
}

template <typename Math, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const typename Math::T* __restrict__ q,
                    const typename Math::T* __restrict__ k,
                    const typename Math::T* __restrict__ v,
                    const typename Math::T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    typename Math::T* __restrict__ dq, int hq, int hkv, int s,
                    int t, int causal, int has_window, long long window,
                    float scale) {
  using T = typename Math::T;
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + L::kX;
  T* Ks = dOs + L::kX;
  T* Vs = Ks + L::kX;
  float* Ss = reinterpret_cast<float*>(Vs + L::kX);
  float* dPs = Ss + kB * L::kLdS;
  T* dSs = reinterpret_cast<T*>(dPs + kB * L::kLdS) + kB * L::kLdP;
  float* lse2 = reinterpret_cast<float*>(dSs + kB * L::kLdP);
  float* dl = lse2 + kB;

  const long long bh = blockIdx.x;
  const long long b = bh / hq;
  const long long kvh = (bh % hq) / (hq / hkv);
  const int i0 = blockIdx.y * kB;
  const long long q_offset = (long long)t - s;
  const T* kb = k + (b * hkv + kvh) * t * D;
  const T* vb = v + (b * hkv + kvh) * t * D;
  load_tile<T, D>(Qs, q + bh * s * D, i0, s);
  load_tile<T, D>(dOs, dout + bh * s * D, i0, s);
  load_rows(lse2, dl, lse, delta, bh * s, i0, s);

  // the key tiles its queries see (the forward's tile-level tests)
  const long long qlo = q_offset + i0;
  const long long qhi = q_offset + min(i0 + kB, s) - 1;
  long long klo = 0, khi = (long long)t - 1;
  if (causal) khi = min(khi, qhi);
  if (has_window) klo = max(klo, qlo - window + 1);
  const int kt0 = (int)(klo / kB);
  const int kt1 = khi >= klo ? (int)(khi / kB) : kt0 - 1;
  const float scale_log2 = scale * kLog2e;

  typename Math::Acc adq;
  Math::zero(adq);
  for (int kt = kt0; kt <= kt1; ++kt) {
    const long long kpos0 = (long long)kt * kB;
    __syncthreads();            // every warp is done with the last K, V
    load_tile<T, D>(Ks, kb, kpos0, t);
    load_tile<T, D>(Vs, vb, kpos0, t);
    __syncthreads();
    Math::abt(Ss, Qs, Ks);
    Math::abt(dPs, dOs, Vs);
    __syncthreads();
    softmax_grad<T, D, false>(Ss, dPs, lse2, dl, nullptr, dSs, qlo,
                              min(kB, s - i0), kpos0, t, causal, has_window,
                              window, scale_log2);
    __syncthreads();
    Math::acc_nn(adq, dSs, Ks);
  }
  __syncthreads();
  Math::stage(Ss, adq);
  __syncthreads();
  write_rows<T, D>(dq, Ss, bh * s + i0, min(kB, s - i0), scale);
}

template <typename Math, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int hq, int hkv, int s, int t,
           int causal, int has_window, long long window, float scale,
           cudaStream_t stream) {
  using T = typename Math::T;
  constexpr size_t kBytes = Smem<T, D>::kBytes;
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<Math, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<Math, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)bh * s;
  const unsigned delta_blocks =
      (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_delta_kernel<T, D><<<delta_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int batch = bh / hq;
  const dim3 grid_kv((unsigned)(batch * hkv), (unsigned)((t + kB - 1) / kB));
  flash_bwd_dkdv_kernel<Math, D><<<grid_kv, kThreads, kBytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      hq, hkv, s, t, causal, has_window, window, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid_q((unsigned)bh, (unsigned)((s + kB - 1) / kB));
  flash_bwd_dq_kernel<Math, D><<<grid_q, kThreads, kBytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), hq, hkv, s, t,
      causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <template <int> class Math>
int dispatch_d(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int bh, int hq, int hkv, int s, int t,
               int d, int causal, int has_window, long long window,
               float scale, cudaStream_t stream) {
#define BWD_CASE(DIM)                                                        \
  case DIM:                                                                  \
    return launch<Math<DIM>, DIM>(q, k, v, o, dout,                          \
                                  static_cast<const float*>(lse),            \
                                  static_cast<float*>(delta), dq, dk, dv,    \
                                  bh, hq, hkv, s, t, causal, has_window,     \
                                  window, scale, stream);
  switch (d) {
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

}  // namespace

// bh = B * Hq, Hq % Hkv == 0, S <= T, 16-byte aligned contiguous operands
// (the wrapper checks them and the grid limits); delta is fp32 scratch of
// B * Hq * S. Three launches on `stream`: D, then dK and dV, then dQ.
// Returns cudaGetLastError() after the first launch that fails, else after
// the last.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bh, int hq, int hkv, int s, int t, int d, int causal,
    int has_window, long long window, float scale, cudaStream_t stream) {
  return dispatch_d<TcMath>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, hq,
                            hkv, s, t, d, causal, has_window, window, scale,
                            stream);
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bh, int hq, int hkv, int s, int t, int d, int causal,
    int has_window, long long window, float scale, cudaStream_t stream) {
  return dispatch_d<CcMath>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, hq,
                            hkv, s, t, d, causal, has_window, window, scale,
                            stream);
}
