// Backward of causal / sliding-window flash attention with GQA for Hopper
// (LM training). With the forward's mask (query i at absolute position
// q_offset + i, q_offset = T - S; key j kept when j <= q_offset + i if
// causal and, if windowed, j > q_offset + i - window or j < meta_len, the
// attention sinks; FlashMask in flash_mask.cuh), the forward's row
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
// o, dO and one write of dq, dk, dv; the tensor cores for bf16. The design
// below runs seven (S and dP once more in the dQ kernel): storing dS
// instead would write and read 2 bytes a kept pair, more time than the
// two products at the tensor cores' rate.
//
// Three kernels, no atomics and fixed loop orders (two launches give the
// same bits):
//   1. flash_bwd_delta_kernel: D_i = rowsum(dO o O) in fp32, a warp a row.
//   2. dK and dV: one CTA per (batch x KV head, key tile); the CTA walks
//      the G query heads of its group and, in order, the query tiles that
//      can see its keys (to S where it holds a sink key, unclamped by the
//      window), recomputes S and dP, forms P and dS, accumulates
//      dV += P^T dO and dK += dS^T Q and writes dK (times scale) and dV
//      once.
//   3. dQ: one CTA per (batch x query head, query tile) over its visible
//      key tiles (the sink tiles first, then the band, as the forward
//      walks them): S, dP, dS again, dQ += dS K.
//
// bf16, D in {64, 80, 128}: the Hopper design (flash_bwd_dkdv_wgmma_kernel,
// flash_bwd_dq_wgmma_kernel; the main path). Per CTA one producer warp
// and two consumer warpgroups (setmaxnreg 24 / 240). D = 80
// (hubert-xlarge) runs at its true width: the tiles are five 16-column
// atoms in the 32-byte swizzle (one TMA box an atom, the barriers'
// transactions each box's true bytes), S and dP run five k16 steps, an
// atom each, and dV, dK and dQ accumulate at N = 80 (wgmma m64n80k16, 40
// fp32 a thread each). Its tiles take 0.625x D 128's shared memory, which
// buys a 4-stage ring (Bw<80>::kStages) in 121 KB.
//   dK / dV: 128 keys a CTA, 64 a consumer warpgroup. The producer loads
//   the tile's K and V once by TMA, then streams Q and dO tiles of 64
//   queries (and their LSE and D rows, by its 32 lanes) through a 2-stage
//   ring (4 at D 80) of full / empty mbarriers. A warpgroup computes
//   S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands K-major
//   from shared memory), forms P^T and dS^T on the accumulator fragment (masking only
//   tiles that cross the diagonal, the window edge or T; query rows past S
//   carry an LSE of +inf, so their P is 0), rounds them to bf16 in
//   registers as the plain version rounds them and feeds them as the A
//   operand from registers of dV += P^T dO and dK += dS^T Q (m64nDk16, dO
//   and Q MN-major through the transpose bit). A warpgroup forms P^T
//   while its dP^T product is still in flight and dS^T while its dV
//   product is. dK and dV stay in fp32 registers over the whole walk and
//   are staged, as bf16, through the idle ring and K / V tiles into
//   16-byte stores.
//   dQ: 128 queries a CTA, 64 a warpgroup; Q and dO stay resident, K and
//   V stream through the ring in tiles of 64 keys; S = Q K^T and dP = dO
//   V^T (K-major; P formed while dP is in flight), dS in registers,
//   dQ += dS K (K MN-major). A warpgroup skips a tile its own rows cannot
//   see.
// bf16, D = 256: the Hopper design with the head dim split across the
// two consumer warpgroups (flash_bwd_dkdv_split_kernel,
// flash_bwd_dq_split_kernel; gemma-7b). A warpgroup owning 64 keys and
// all of D would hold dK and dV in 256 fp32 registers a thread; here
// each owns 128 of the 256 columns of the CTA's outputs instead.
//   dK / dV: 64 keys a CTA. K and V stay resident (64 KB); Q | dO stream
//   through a 2-stage ring of 64 queries (128 KB). Warpgroup wg computes
//   S^T and dP^T for queries 32 wg .. + 31 of the stage (wgmma m64n32k16,
//   depth 256, both operands K-major from shared memory), forms P^T and
//   dS^T there and writes them, rounded to bf16 as the plain version
//   rounds them, to two 64 x 64 tiles in shared memory (16 KB) in the
//   128-byte swizzle the K-major descriptor reads. Named barriers join
//   the two halves; then each warpgroup runs dV[:, half] += P^T dO[:,
//   half] (issued before it forms dS^T) and dK[:, half] += dS^T Q[:,
//   half] (m64n128k16, A from shared memory, dO and Q MN-major). dK and
//   dV: 2 x 64 x 128 fp32 over 128 threads, 128 registers a thread of the
//   240 setmaxnreg gives a consumer.
//   dQ: 64 queries a CTA, the last query tiles (the most keys under a
//   causal mask) launched first. Q and dO stay resident (64 KB); K | V
//   stream through the ring in 64-key tiles (128 KB); S and dP are split
//   by key halves as above, dS goes through shared memory (8 KB), and
//   warpgroup wg runs dQ[:, half] += dS K[:, half] (64 registers).
//   Shared memory: 64 + 128 + 16 KB and 1 KB of alignment, 209 KB of the
//   227 a block can use (a third ring stage would not fit); the outputs
//   are staged through the idle ring into 16-byte stores. Every tile of
//   both walks holds a kept pair (the walks' bounds are the visibility
//   bounds), so none is skipped, and the mask test is the CTA's (64 x
//   64): both warpgroups take the same branches.
//   What bounds it: at gemma-7b's shape 2.6x the 7-product time at the
//   tensor cores' peak. Taking the S / dP products out saves 27 % of
//   the time, the dV / dK / dQ products 15 %, the barrier before P / dS
//   are written again 2 % (tools/compare_kernels.py --variants): the
//   rest is each tile's chain of waits, the P / dS arithmetic and the
//   barriers, which the two warpgroups run in step. Hiding that chain
//   needs the next tile's scores in flight, and with two ring stages
//   (all that fits) issuing them a tile ahead left the loads exposed:
//   21 % slower.
// bf16, D = 32 (flash_bwd_dkdv_kernel / flash_bwd_dq_kernel with
// TcMath): the simple design, 64-key and 64-query tiles, WMMA 16 x 16 x 16
// from padded shared memory with a __syncthreads between products (only
// smoke configs run it). fp32, D in {32, 64, 128} (CcMath): the same
// design on the CUDA cores (the fp32 smoke config and the card tests); at
// D = 256 its four padded fp32 tiles would take 260 KB, above the 227 KB
// a block can use, so the wrapper raises there.
// The scale multiplies the fp32 product, as the forward kernel does.
//
// Any S <= T, causal or not, any window and sink prefix. With meta_len =
// 0 every instance walks the tiles it walked before sinks. Without the
// causal test (hubert's encoder) the dK / dV kernel walks every query
// tile and the dQ kernel every key tile; only tiles past S or T mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>

#include "flash_mask.cuh"
#include "hopper.cuh"

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

// ---- the simple design: WMMA (bf16) or CUDA cores (fp32) -----------------

// shared memory: Q | dO | K | V (T, kB x kLdX), S | dP (fp32, kB x kLdS),
// P | dS (T, kB x kLdP), lse * log2 e | D (fp32, kB each). Every region is
// a multiple of 128 bytes, so every WMMA pointer is 32-byte aligned. The
// accumulators are staged through Q | dO | K | V at the end (kB x (D + 4)
// fp32).
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
  static_assert(kB * kLdSt * sizeof(float) <= 4 * (size_t)kX * sizeof(T),
                "staging exceeds Q | dO | K | V");
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
    T* P, T* dS, long long qpos0, int q_rows, long long kpos0,
    const FlashMask& mk, float scale_log2) {
  using L = Smem<T, D>;
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int i = e / kB, j = e % kB;
    const bool ok = i < q_rows && mk.kept(qpos0 + i, kpos0 + j);
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
                      long long window, long long meta_len, float scale) {
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
  const FlashMask mk{t, causal, has_window, window, meta_len};
  const long long kmax = min(k0 + kB, (long long)t) - 1;
  int qt0, n_qt;
  mk.q_walk(k0, kmax, s, kB, &qt0, &n_qt);
  const float scale_log2 = scale * kLog2e;

  typename Math::Acc adk, adv;
  Math::zero(adk);
  Math::zero(adv);
  for (int g = 0; g < groups; ++g) {
    const long long bh = (long long)b * hq + kvh * groups + g;
    for (int qt = qt0; qt < qt0 + n_qt; ++qt) {
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
                               min(kB, s - i0), k0, mk, scale_log2);
      __syncthreads();
      Math::acc_tn(adv, Ps, dOs);
      Math::acc_tn(adk, dSs, Qs);
    }
  }
  const int n_rows = (int)(min(k0 + kB, (long long)t) - k0);
  const long long out0 = (long long)bkv * t + k0;
  float* st = reinterpret_cast<float*>(smem);     // over Q | dO | K | V
  __syncthreads();
  Math::stage(st, adk);
  __syncthreads();
  write_rows<T, D>(dk, st, out0, n_rows, scale);
  __syncthreads();
  Math::stage(st, adv);
  __syncthreads();
  write_rows<T, D>(dv, st, out0, n_rows, 1.f);
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
                    long long meta_len, float scale) {
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

  // the key tiles its queries see (the forward's walk: sinks, band)
  const FlashMask mk{t, causal, has_window, window, meta_len};
  const long long qlo = q_offset + i0;
  const long long qhi = q_offset + min(i0 + kB, s) - 1;
  const FlashMask::KvWalk walk = mk.kv_walk(qlo, qhi, kB);
  const float scale_log2 = scale * kLog2e;

  typename Math::Acc adq;
  Math::zero(adq);
  for (int it = 0; it < walk.n_tiles; ++it) {
    const long long kpos0 = (long long)walk.tile(it) * kB;
    __syncthreads();            // every warp is done with the last K, V
    load_tile<T, D>(Ks, kb, kpos0, t);
    load_tile<T, D>(Vs, vb, kpos0, t);
    __syncthreads();
    Math::abt(Ss, Qs, Ks);
    Math::abt(dPs, dOs, Vs);
    __syncthreads();
    softmax_grad<T, D, false>(Ss, dPs, lse2, dl, nullptr, dSs, qlo,
                              min(kB, s - i0), kpos0, mk, scale_log2);
    __syncthreads();
    Math::acc_nn(adq, dSs, Ks);
  }
  float* st = reinterpret_cast<float*>(smem);     // over Q | dO | K | V
  __syncthreads();
  Math::stage(st, adq);
  __syncthreads();
  write_rows<T, D>(dq, st, bh * s + i0, min(kB, s - i0), scale);
}

// D_i = rowsum(dO o O) of every row
template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int bh,
                 int s, cudaStream_t stream) {
  const long long rows = (long long)bh * s;
  const unsigned blocks =
      (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_delta_kernel<T, D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  return (int)cudaGetLastError();
}

template <typename Math, int D>
int launch_simple(const void* q, const void* k, const void* v,
                  const void* o, const void* dout, const float* lse,
                  float* delta, void* dq, void* dk, void* dv, int bh, int hq,
                  int hkv, int s, int t, int causal, int has_window,
                  long long window, long long meta_len, float scale,
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
  int rc = launch_delta<T, D>(o, dout, delta, bh, s, stream);
  if (rc) return rc;
  const int batch = bh / hq;
  const dim3 grid_kv((unsigned)(batch * hkv), (unsigned)((t + kB - 1) / kB));
  flash_bwd_dkdv_kernel<Math, D><<<grid_kv, kThreads, kBytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      hq, hkv, s, t, causal, has_window, window, meta_len, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid_q((unsigned)bh, (unsigned)((s + kB - 1) / kB));
  flash_bwd_dq_kernel<Math, D><<<grid_q, kThreads, kBytes, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), hq, hkv, s, t,
      causal, has_window, window, meta_len, scale);
  return (int)cudaGetLastError();
}

// ---- bf16, D in {64, 80, 128}: wgmma, TMA ring, register accumulators ----

template <int D>
struct Bw {
  // atoms of 64 columns in the 128-byte swizzle; at D 80 the true width,
  // five atoms of 16 columns in the 32-byte swizzle
  static constexpr int kAtomCols = D == 80 ? 16 : 64;
  static constexpr int kSw = 2 * kAtomCols;           // bytes an atom row
  static constexpr CUtensorMapSwizzle kSwizzle =
      D == 80 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr int kThreads = 3 * 128;  // 2 consumer + 1 producer WG
  static constexpr int kStages = D == 80 ? 4 : 2;
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kAtom128 = 128 * kSw;          // a 128-row atom
  static constexpr int kAtom64 = 64 * kSw;            // a 64-row atom
  static constexpr int kTile128 = kAtoms * kAtom128;  // 128 rows x D
  static constexpr int kTile64 = kAtoms * kAtom64;    // 64 rows x D
  static constexpr int kStage = 2 * kTile64;          // Q | dO, or K | V
  // 128-row K | V (dK / dV) or Q | dO (dQ), then the ring
  static constexpr int kSmem = 2 * kTile128 + kStages * kStage + 1024;
  static constexpr int kLdSt = D + 8;       // bf16 a staged output row
                                            // (the true columns)
  static_assert(2 * 64 * kLdSt * 2 <= kStages * kStage, "dK staging");
  static_assert(2 * 64 * kLdSt * 2 <= 2 * kTile128, "dV staging");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// P of one 64 x (N / 2) accumulator tile (row = this thread's rows,
// column = 8 j + 2 (lane % 4) + c), in place of the scores: p = exp2(s
// scale log2 e - lse2), 0 where `kept` says no (lse2 of element idx)
template <bool kMask, int N, typename Lse, typename Kept>
__device__ __forceinline__ void p_tile(float (&sc)[N], float scale_log2,
                                       Lse lse2, Kept kept) {
#pragma unroll
  for (int idx = 0; idx < N; ++idx) {
    const float pv = exp2f(sc[idx] * scale_log2 - lse2(idx));
    if constexpr (kMask)
      sc[idx] = kept(idx) ? pv : 0.f;
    else
      sc[idx] = pv;
  }
}

// a tile rounded to bf16 as wgmma A fragments (k16 chunk kk: columns
// 16 kk ..)
__device__ __forceinline__ void a_fragments(const float (&x)[32],
                                            uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = hopper::pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

// dS = p (dp - dl) of a tile (dl of element idx) as A fragments
template <typename Dl>
__device__ __forceinline__ void ds_fragments(const float (&p)[32],
                                             const float (&dp)[32], Dl dl,
                                             uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 8 * kk + 2 * e;
      a[kk][e] = hopper::pack_bf16(p[i] * (dp[i] - dl(i)),
                                   p[i + 1] * (dp[i + 1] - dl(i + 1)));
    }
}

// accumulator element idx of a thread: row 16 (warp % 4) + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + c with idx = 4 j + 2 h + c
__device__ __forceinline__ int frag_row(int idx) { return 8 * ((idx >> 1) & 1); }
__device__ __forceinline__ int frag_col(int idx) {
  return 8 * (idx >> 2) + (idx & 1);
}

template <int D>
__global__ void __launch_bounds__(Bw<D>::kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap dom,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int hq, int hkv, int s, int t, int causal,
                            int has_window, long long window,
                            long long meta_len, float scale) {
  using C = Bw<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[C::kStages],
      empty[C::kStages];
  __shared__ float lse2_s[C::kStages][64], dl_s[C::kStages][64];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + C::kTile128;
  unsigned char* ring = vs + C::kTile128;   // a stage: Q | dO, 64 queries

  const int bkv = blockIdx.x;               // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int groups = hq / hkv;
  const long long k0 = (long long)blockIdx.y * 128;
  const long long q_offset = (long long)t - s;
  // the 64-query tiles that see a key of this tile
  const FlashMask mk{t, causal, has_window, window, meta_len};
  const long long kmax = min(k0 + 128, (long long)t) - 1;
  int qt0, n_qt;
  mk.q_walk(k0, kmax, s, 64, &qt0, &n_qt);
  const int n_iter = groups * n_qt;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&full[i], 2);     // the loads and the LSE / D rows
      hopper::mbar_init(&empty[i], 8);    // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: warp 8 feeds the ring, the rest only give their
    // registers to the consumers
    hopper::setmaxnreg_dec<24>();
    if (warp == 8) {
      if (lane == 0) {
        hopper::prefetch_tensor_map(&qm);
        hopper::prefetch_tensor_map(&dom);
        hopper::prefetch_tensor_map(&km);
        hopper::prefetch_tensor_map(&vm);
        hopper::mbar_arrive_expect_tx(&kv_full, 2 * C::kTile128);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          hopper::tma_load_3d(ks + a * C::kAtom128, &km, &kv_full,
                              a * C::kAtomCols, (int)k0, bkv);
          hopper::tma_load_3d(vs + a * C::kAtom128, &vm, &kv_full,
                              a * C::kAtomCols, (int)k0, bkv);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_iter; ++it) {
        const int g = it / n_qt;
        const int i0 = (qt0 + it % n_qt) * 64;
        const int bh = b * hq + kvh * groups + g;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          unsigned char* st = ring + stage * C::kStage;
          hopper::mbar_arrive_expect_tx(&full[stage], C::kStage);
#pragma unroll
          for (int a = 0; a < C::kAtoms; ++a) {
            hopper::tma_load_3d(st + a * C::kAtom64, &qm, &full[stage],
                                a * C::kAtomCols, i0, bh);
            hopper::tma_load_3d(st + C::kTile64 + a * C::kAtom64, &dom,
                                &full[stage], a * C::kAtomCols, i0, bh);
          }
        }
        // rows past S: lse +inf, so P = exp2(-inf) = 0 there
        for (int r = lane; r < 64; r += 32) {
          const bool in = i0 + r < s;
          const long long at = (long long)bh * s + i0 + r;
          lse2_s[stage][r] = in ? lse[at] * kLog2e : INFINITY;
          dl_s[stage][r] = in ? delta[at] : 0.f;
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&full[stage]);
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroups: wg owns keys 64 wg .. 64 wg + 63 of the tile
  hopper::setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2);   // key row in the 64
  const int c0 = 2 * (lane & 3);                  // query column offset
  const long long kw0 = k0 + 64 * wg;
  const long long kw1 = min(kw0 + 63, (long long)t - 1);
  const float scale_log2 = scale * kLog2e;

  constexpr int kSw = C::kSw;
  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

  hopper::mbar_wait(&kv_full, 0);
  const uint32_t k_base = hopper::smem_u32(ks) + wg * 64 * kSw;
  const uint32_t v_base = hopper::smem_u32(vs) + wg * 64 * kSw;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_iter; ++it) {
    const int i0 = (qt0 + it % n_qt) * 64;
    const long long qlo = q_offset + i0;
    const long long qhi = q_offset + min(i0 + 63, s - 1);
    // tile-level tests on this warpgroup's keys
    const bool skip = mk.skip(kw0, kw1, qlo, qhi);
    const bool need_mask = mk.need_mask(kw0, 64, qlo, qhi);
    hopper::mbar_wait(&full[stage], phase);
    if (!skip) {
      const uint32_t q_st = hopper::smem_u32(ring + stage * C::kStage);
      const uint32_t do_st = q_st + C::kTile64;
      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, fp32)
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::WgmmaBf16SS<64>::mma(
            sc, hopper::desc_k_atoms<kSw>(k_base, 128, kk),
            hopper::desc_k_atoms<kSw>(q_st, 64, kk), 1);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::WgmmaBf16SS<64>::mma(
            dp, hopper::desc_k_atoms<kSw>(v_base, 128, kk),
            hopper::desc_k_atoms<kSw>(do_st, 64, kk), 1);
      hopper::wgmma_commit();

      // P^T (row key kw0 + r0 + 8 h, column query i0 + c0 + ...) while
      // dP^T is still in the tensor cores, then dV += P^T dO (the stage's
      // rows are the product's K)
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      const float* l2 = lse2_s[stage];
      const float* dl = dl_s[stage];
      auto lse_at = [&](int idx) { return l2[c0 + frag_col(idx)]; };
      auto dl_at = [&](int idx) { return dl[c0 + frag_col(idx)]; };
      auto kept = [&](int idx) {
        return mk.kept(qlo + c0 + frag_col(idx), kw0 + r0 + frag_row(idx));
      };
      if (need_mask)
        p_tile<true>(sc, scale_log2, lse_at, kept);
      else
        p_tile<false>(sc, scale_log2, lse_at, kept);
      uint32_t pa[4][4], da[4][4];
      a_fragments(sc, pa);
      hopper::fence_regs(adv);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::WgmmaBf16RS<D, 1>::mma(
            adv, pa[kk], hopper::desc_mn_atoms<kSw>(do_st, 64, kk), 1);
      hopper::wgmma_commit();

      // dS^T while dV's product runs, then dK += dS^T Q
      hopper::wgmma_wait<1>();
      hopper::fence_regs(dp);
      ds_fragments(sc, dp, dl_at, da);
      hopper::fence_regs(adk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::WgmmaBf16RS<D, 1>::mma(
            adk, da[kk], hopper::desc_mn_atoms<kSw>(q_st, 64, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(adv);
      hopper::fence_regs(adk);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) { stage = 0; phase ^= 1; }
  }

  // epilogue: both warpgroups are past their last wgmma and every load has
  // landed, so the ring holds the staged dK rows and the K | V tiles dV's
  hopper::named_barrier_sync(1, 256);
  bf16* stk = reinterpret_cast<bf16*>(ring) + wg * 64 * C::kLdSt;
  bf16* stv = reinterpret_cast<bf16*>(ks) + wg * 64 * C::kLdSt;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (r0 + 8 * h) * C::kLdSt + 8 * j + c0;
      *reinterpret_cast<uint32_t*>(stk + at) = hopper::pack_bf16(
          adk[4 * j + 2 * h] * scale, adk[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(stv + at) =
          hopper::pack_bf16(adv[4 * j + 2 * h], adv[4 * j + 2 * h + 1]);
    }
  }
  hopper::named_barrier_sync(2 + wg, 128);
  const int n_rows = (int)max(0LL, min(64LL, (long long)t - kw0));
  const long long out0 = (long long)bkv * t + kw0;
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x & 127; i < n_rows * kVecs; i += 128) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    *reinterpret_cast<uint4*>(dk + (out0 + r) * D + c) =
        *reinterpret_cast<const uint4*>(stk + r * C::kLdSt + c);
    *reinterpret_cast<uint4*>(dv + (out0 + r) * D + c) =
        *reinterpret_cast<const uint4*>(stv + r * C::kLdSt + c);
  }
}

template <int D>
__global__ void __launch_bounds__(Bw<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qm,
                          const __grid_constant__ CUtensorMap dom,
                          const __grid_constant__ CUtensorMap km,
                          const __grid_constant__ CUtensorMap vm,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int hq, int hkv, int s,
                          int t, int causal, int has_window, long long window,
                          long long meta_len, float scale) {
  using C = Bw<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[C::kStages],
      empty[C::kStages];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + C::kTile128;
  unsigned char* ring = dos + C::kTile128;  // a stage: K | V, 64 keys

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  const int i0 = blockIdx.y * 128;
  const long long q_offset = (long long)t - s;
  // the 64-key tiles the CTA's queries see (the forward's walk: the sink
  // tiles, then the band); the producer and the consumers walk it alike
  const FlashMask mk{t, causal, has_window, window, meta_len};
  const long long qlo = q_offset + i0;
  const long long qhi = q_offset + min(i0 + 128, s) - 1;
  const FlashMask::KvWalk walk = mk.kv_walk(qlo, qhi, 64);
  const int n_kt = walk.n_tiles;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::prefetch_tensor_map(&qm);
      hopper::prefetch_tensor_map(&dom);
      hopper::prefetch_tensor_map(&km);
      hopper::prefetch_tensor_map(&vm);
      hopper::mbar_arrive_expect_tx(&q_full, 2 * C::kTile128);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) {
        hopper::tma_load_3d(qs + a * C::kAtom128, &qm, &q_full,
                            a * C::kAtomCols, i0, bh);
        hopper::tma_load_3d(dos + a * C::kAtom128, &dom, &q_full,
                            a * C::kAtomCols, i0, bh);
      }
      const int kv_bh = b * hkv + kvh;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_kt; ++it) {
        const int kpos0 = walk.tile(it) * 64;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * C::kStage;
        hopper::mbar_arrive_expect_tx(&full[stage], C::kStage);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          hopper::tma_load_3d(st + a * C::kAtom64, &km, &full[stage],
                              a * C::kAtomCols, kpos0, kv_bh);
          hopper::tma_load_3d(st + C::kTile64 + a * C::kAtom64, &vm,
                              &full[stage], a * C::kAtomCols, kpos0, kv_bh);
        }
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroups: wg owns queries 64 wg .. 64 wg + 63 of the tile
  hopper::setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2);   // query row in the 64
  const int c0 = 2 * (lane & 3);                  // key column offset
  const int w0 = i0 + 64 * wg;                    // the warpgroup's rows
  const long long wq_lo = q_offset + w0;
  const long long wq_hi = q_offset + min(w0 + 63, s - 1);
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];                           // rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + r0 + 8 * h;
    const bool in = row < s;
    lse2[h] = in ? lse[(long long)bh * s + row] * kLog2e : INFINITY;
    dl[h] = in ? delta[(long long)bh * s + row] : 0.f;
  }

  constexpr int kSw = C::kSw;
  float adq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adq[i] = 0.f;

  hopper::mbar_wait(&q_full, 0);
  const uint32_t q_base = hopper::smem_u32(qs) + wg * 64 * kSw;
  const uint32_t do_base = hopper::smem_u32(dos) + wg * 64 * kSw;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_kt; ++it) {
    const long long kpos0 = (long long)walk.tile(it) * 64;
    const long long k_last = min(kpos0 + 63, (long long)t - 1);
    const bool skip = w0 >= s || mk.skip(kpos0, k_last, wq_lo, wq_hi);
    const bool need_mask = mk.need_mask(kpos0, 64, wq_lo, wq_hi);
    hopper::mbar_wait(&full[stage], phase);
    if (!skip) {
      const uint32_t k_st = hopper::smem_u32(ring + stage * C::kStage);
      const uint32_t v_st = k_st + C::kTile64;
      // S = Q K^T and dP = dO V^T (64 queries x 64 keys, fp32)
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::WgmmaBf16SS<64>::mma(
            sc, hopper::desc_k_atoms<kSw>(q_base, 128, kk),
            hopper::desc_k_atoms<kSw>(k_st, 64, kk), 1);
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::WgmmaBf16SS<64>::mma(
            dp, hopper::desc_k_atoms<kSw>(do_base, 128, kk),
            hopper::desc_k_atoms<kSw>(v_st, 64, kk), 1);
      hopper::wgmma_commit();

      // P while dP is still in the tensor cores, then dS
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      auto lse_at = [&](int idx) { return lse2[(idx >> 1) & 1]; };
      auto dl_at = [&](int idx) { return dl[(idx >> 1) & 1]; };
      auto kept = [&](int idx) {
        return mk.kept(wq_lo + r0 + frag_row(idx),
                       kpos0 + c0 + frag_col(idx));
      };
      if (need_mask)
        p_tile<true>(sc, scale_log2, lse_at, kept);
      else
        p_tile<false>(sc, scale_log2, lse_at, kept);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      uint32_t da[4][4];
      ds_fragments(sc, dp, dl_at, da);

      // dQ += dS K (the stage's key rows are the product's K)
      hopper::fence_regs(adq);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::WgmmaBf16RS<D, 1>::mma(
            adq, da[kk], hopper::desc_mn_atoms<kSw>(k_st, 64, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(adq);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) { stage = 0; phase ^= 1; }
  }

  // dQ times scale, rows below S, the true columns, a bf16 pair a store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + r0 + 8 * h;
    if (row >= s) continue;
    bf16* drow = dq + ((long long)bh * s + row) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(drow + 8 * j) = hopper::pack_bf16(
          adq[4 * j + 2 * h] * scale, adq[4 * j + 2 * h + 1] * scale);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int bh, int hq, int hkv, int s, int t,
                 int causal, int has_window, long long window,
                 long long meta_len, float scale, cudaStream_t stream) {
  using C = Bw<D>;
  const int batch = bh / hq;
  // 3-D maps over (D, rows, batch x head), a box an atom (C::kSwizzle):
  // 64- and 128-row boxes of Q and dO (S rows), of K and V (T rows)
  CUtensorMap q64, do64, q128, do128, k64, v64, k128, v128;
  const cuuint64_t qdims[3] = {D, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t qstr[2] = {D * 2, (cuuint64_t)s * D * 2};
  const cuuint64_t kdims[3] = {D, (cuuint64_t)t, (cuuint64_t)batch * hkv};
  const cuuint64_t kstr[2] = {D * 2, (cuuint64_t)t * D * 2};
  const cuuint32_t box64[3] = {C::kAtomCols, 64, 1};
  const cuuint32_t box128[3] = {C::kAtomCols, 128, 1};
  struct Map {
    CUtensorMap* map;
    const void* base;
    const cuuint64_t* dims;
    const cuuint64_t* strides;
    const cuuint32_t* box;
  } maps[8] = {{&q64, q, qdims, qstr, box64},
               {&do64, dout, qdims, qstr, box64},
               {&q128, q, qdims, qstr, box128},
               {&do128, dout, qdims, qstr, box128},
               {&k64, k, kdims, kstr, box64},
               {&v64, v, kdims, kstr, box64},
               {&k128, k, kdims, kstr, box128},
               {&v128, v, kdims, kstr, box128}};
  for (const Map& m : maps) {
    const int rc = hopper::make_tensor_map(
        m.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, m.base, m.dims,
        m.strides, m.box, C::kSwizzle);
    if (rc) return rc;
  }
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  int rc = launch_delta<bf16, D>(o, dout, delta, bh, s, stream);
  if (rc) return rc;
  const dim3 grid_kv((unsigned)(batch * hkv), (unsigned)((t + 127) / 128));
  flash_bwd_dkdv_wgmma_kernel<D><<<grid_kv, C::kThreads, C::kSmem, stream>>>(
      q64, do64, k128, v128, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hq, hkv, s, t, causal, has_window, window,
      meta_len, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid_q((unsigned)bh, (unsigned)((s + 127) / 128));
  flash_bwd_dq_wgmma_kernel<D><<<grid_q, C::kThreads, C::kSmem, stream>>>(
      q128, do128, k64, v64, lse, delta, static_cast<bf16*>(dq), hq, hkv, s,
      t, causal, has_window, window, meta_len, scale);
  return (int)cudaGetLastError();
}

// ---- bf16, D = 256: the head dim split across the two warpgroups --------

struct Bs {
  static constexpr int kD = 256;
  static constexpr int kThreads = 3 * 128;  // 2 consumer + 1 producer WG
  static constexpr int kStages = 2;
  static constexpr int kAtoms = kD / 64;    // 64 bf16 = one 128-byte row
  static constexpr int kAtom = 64 * 128;    // a 64-row atom
  static constexpr int kTile = kAtoms * kAtom;        // 64 rows x D, 32 KB
  static constexpr int kStage = 2 * kTile;            // Q | dO, or K | V
  static constexpr int kPTile = 64 * 128;   // a 64 x 64 bf16 tile, 8 KB
  // the resident pair (K | V, or Q | dO), the ring, then P^T and dS^T
  // (the dQ kernel uses the second for dS)
  static constexpr int kSmem = 2 * kTile + kStages * kStage + 2 * kPTile +
                               1024;
  static constexpr int kLdSt = kD + 8;      // bf16 a staged output row
  static_assert(2 * 64 * kLdSt * 2 <= kStages * kStage, "output staging");
};

// a bf16 pair (columns col, col + 1; col even) into a 64 x 64 bf16 tile in
// the 128-byte swizzle TMA writes and the K-major descriptor reads: the
// 16-byte chunk col / 8 of row `row` lies at chunk (col / 8) ^ (row % 8)
__device__ __forceinline__ void st_swizzled(unsigned char* tile, int row,
                                            int col, uint32_t pair) {
  *reinterpret_cast<uint32_t*>(
      tile + row * 128 + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2) =
      pair;
}

// rows of the staged 64 x D bf16 outputs (row stride kLdSt) to rows
// out0 .. of dst, 16 bytes a store, by the 256 consumer threads
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* st,
                                           long long out0, int n_rows) {
  constexpr int kVecs = Bs::kD / 8;
  for (int i = threadIdx.x; i < n_rows * kVecs; i += 256) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    *reinterpret_cast<uint4*>(dst + (out0 + r) * Bs::kD + c) =
        *reinterpret_cast<const uint4*>(st + r * Bs::kLdSt + c);
  }
}

// dK / dV at D = 256: one CTA a (batch x KV head, 64-key tile); warpgroup
// wg owns head-dim columns 128 wg .. 128 wg + 127 of dK and dV, and
// queries 32 wg .. 32 wg + 31 of each ring stage's S^T and dP^T
__global__ void __launch_bounds__(Bs::kThreads, 1)
flash_bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap qm,
                            const __grid_constant__ CUtensorMap dom,
                            const __grid_constant__ CUtensorMap km,
                            const __grid_constant__ CUtensorMap vm,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int hq, int hkv, int s, int t, int causal,
                            int has_window, long long window,
                            long long meta_len, float scale) {
  using C = Bs;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[C::kStages],
      empty[C::kStages];
  __shared__ float lse2_s[C::kStages][64], dl_s[C::kStages][64];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + C::kTile;
  unsigned char* ring = vs + C::kTile;      // a stage: Q | dO, 64 queries
  unsigned char* pts = ring + C::kStages * C::kStage;   // P^T
  unsigned char* dsts = pts + C::kPTile;                // dS^T

  const int bkv = blockIdx.x;               // b * hkv + kv head
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int groups = hq / hkv;
  const long long k0 = (long long)blockIdx.y * 64;
  const long long q_offset = (long long)t - s;
  // the 64-query tiles that see a key of this tile
  const FlashMask mk{t, causal, has_window, window, meta_len};
  const long long kmax = min(k0 + 64, (long long)t) - 1;
  int qt0, n_qt;
  mk.q_walk(k0, kmax, s, 64, &qt0, &n_qt);
  const int n_iter = groups * n_qt;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&kv_full, 1);
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&full[i], 2);     // the loads and the LSE / D rows
      hopper::mbar_init(&empty[i], 8);    // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: warp 8 feeds the ring, the rest only give their
    // registers to the consumers
    hopper::setmaxnreg_dec<24>();
    if (warp == 8) {
      if (lane == 0) {
        hopper::prefetch_tensor_map(&qm);
        hopper::prefetch_tensor_map(&dom);
        hopper::prefetch_tensor_map(&km);
        hopper::prefetch_tensor_map(&vm);
        hopper::mbar_arrive_expect_tx(&kv_full, 2 * C::kTile);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          hopper::tma_load_3d(ks + a * C::kAtom, &km, &kv_full, a * 64,
                              (int)k0, bkv);
          hopper::tma_load_3d(vs + a * C::kAtom, &vm, &kv_full, a * 64,
                              (int)k0, bkv);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_iter; ++it) {
        const int g = it / n_qt;
        const int i0 = (qt0 + it % n_qt) * 64;
        const int bh = b * hq + kvh * groups + g;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) {
          unsigned char* st = ring + stage * C::kStage;
          hopper::mbar_arrive_expect_tx(&full[stage], C::kStage);
#pragma unroll
          for (int a = 0; a < C::kAtoms; ++a) {
            hopper::tma_load_3d(st + a * C::kAtom, &qm, &full[stage],
                                a * 64, i0, bh);
            hopper::tma_load_3d(st + C::kTile + a * C::kAtom, &dom,
                                &full[stage], a * 64, i0, bh);
          }
        }
        // rows past S: lse +inf, so P = exp2(-inf) = 0 there
        for (int r = lane; r < 64; r += 32) {
          const bool in = i0 + r < s;
          const long long at = (long long)bh * s + i0 + r;
          lse2_s[stage][r] = in ? lse[at] * kLog2e : INFINITY;
          dl_s[stage][r] = in ? delta[at] : 0.f;
        }
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&full[stage]);
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroups
  hopper::setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2);   // key row in the 64
  const int c0 = 2 * (lane & 3);                  // query column offset
  const int qh = 32 * wg;                         // this WG's query columns
  const uint32_t dh = wg * 2 * C::kAtom;          // its head-dim atoms
  const float scale_log2 = scale * kLog2e;

  float adk[64], adv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) adk[i] = adv[i] = 0.f;

  hopper::mbar_wait(&kv_full, 0);
  const uint32_t k_base = hopper::smem_u32(ks);
  const uint32_t v_base = hopper::smem_u32(vs);
  const uint32_t pt_base = hopper::smem_u32(pts);
  const uint32_t dst_base = hopper::smem_u32(dsts);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_iter; ++it) {
    const int i0 = (qt0 + it % n_qt) * 64;
    const long long qlo = q_offset + i0;
    const long long qhi = q_offset + min(i0 + 63, s - 1);
    // the tile-level mask test on the CTA's keys, the same for both
    // warpgroups; every tile of the walk holds a kept pair (its bounds are
    // the keys' visibility bounds; a sink key sees every later query), so
    // none is skipped
    const bool need_mask = mk.need_mask(k0, 64, qlo, qhi);
    hopper::mbar_wait(&full[stage], phase);
    const uint32_t q_st = hopper::smem_u32(ring + stage * C::kStage);
    const uint32_t do_st = q_st + C::kTile;
    // S^T = K Q^T and dP^T = V dO^T on this WG's 32 queries (fp32)
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kD / 16; ++kk)
      hopper::WgmmaBf16SS<32>::mma(
          sc, hopper::desc_k_atoms<128>(k_base, 64, kk),
          hopper::desc_k_atoms<128>(q_st + qh * 128, 64, kk), 1);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::kD / 16; ++kk)
      hopper::WgmmaBf16SS<32>::mma(
          dp, hopper::desc_k_atoms<128>(v_base, 64, kk),
          hopper::desc_k_atoms<128>(do_st + qh * 128, 64, kk), 1);
    hopper::wgmma_commit();

    // P^T while dP^T is still in the tensor cores, to shared memory as
    // bf16 (the plain version's rounding of the operand)
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    const float* l2 = lse2_s[stage];
    const float* dl = dl_s[stage];
    auto lse_at = [&](int idx) { return l2[qh + c0 + frag_col(idx)]; };
    auto kept = [&](int idx) {
      return mk.kept(qlo + qh + c0 + frag_col(idx), k0 + r0 + frag_row(idx));
    };
    if (need_mask)
      p_tile<true>(sc, scale_log2, lse_at, kept);
    else
      p_tile<false>(sc, scale_log2, lse_at, kept);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st_swizzled(pts, r0 + 8 * h, qh + 8 * j + c0,
                    hopper::pack_bf16(sc[4 * j + 2 * h],
                                      sc[4 * j + 2 * h + 1]));
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, 256);     // P^T whole

    // dV[:, half] += P^T dO[:, half] while this WG forms dS^T
    hopper::fence_regs(adv);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaBf16SS<128, 1>::mma(
          adv, hopper::desc_k_atoms<128>(pt_base, 64, kk),
          hopper::desc_mn_atoms<128>(do_st + dh, 64, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();                // dP^T done
    hopper::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        const float d0 = dl[qh + c0 + frag_col(i)];
        const float d1 = dl[qh + c0 + frag_col(i + 1)];
        st_swizzled(dsts, r0 + 8 * h, qh + 8 * j + c0,
                    hopper::pack_bf16(sc[i] * (dp[i] - d0),
                                      sc[i + 1] * (dp[i + 1] - d1)));
      }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(2, 256);     // dS^T whole

    // dK[:, half] += dS^T Q[:, half]
    hopper::fence_regs(adk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaBf16SS<128, 1>::mma(
          adk, hopper::desc_k_atoms<128>(dst_base, 64, kk),
          hopper::desc_mn_atoms<128>(q_st + dh, 64, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(adv);
    hopper::fence_regs(adk);
    // both WGs done reading P^T and dS^T before either writes them again
    hopper::named_barrier_sync(3, 256);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) { stage = 0; phase ^= 1; }
  }

  // epilogue: every load has landed and every product is done (the last
  // barrier, or no tile at all), so the ring holds the staged dK and dV
  // rows
  bf16* stk = reinterpret_cast<bf16*>(ring);
  bf16* stv = stk + 64 * C::kLdSt;
  const int col = 128 * wg + c0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (r0 + 8 * h) * C::kLdSt + col + 8 * j;
      *reinterpret_cast<uint32_t*>(stk + at) = hopper::pack_bf16(
          adk[4 * j + 2 * h] * scale, adk[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<uint32_t*>(stv + at) =
          hopper::pack_bf16(adv[4 * j + 2 * h], adv[4 * j + 2 * h + 1]);
    }
  }
  hopper::named_barrier_sync(1, 256);
  const int n_rows = (int)(kmax - k0 + 1);
  const long long out0 = (long long)bkv * t + k0;
  store_rows(dk, stk, out0, n_rows);
  store_rows(dv, stv, out0, n_rows);
}

// dQ at D = 256: one CTA a (batch x query head, 64-query tile), the CTAs
// with the most keys to see first; warpgroup wg owns head-dim columns
// 128 wg .. 128 wg + 127 of dQ and keys 32 wg .. 32 wg + 31 of each ring
// stage's S and dP
__global__ void __launch_bounds__(Bs::kThreads, 1)
flash_bwd_dq_split_kernel(const __grid_constant__ CUtensorMap qm,
                          const __grid_constant__ CUtensorMap dom,
                          const __grid_constant__ CUtensorMap km,
                          const __grid_constant__ CUtensorMap vm,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int hq, int hkv, int s,
                          int t, int causal, int has_window, long long window,
                          long long meta_len, float scale) {
  using C = Bs;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[C::kStages],
      empty[C::kStages];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* dos = qs + C::kTile;
  unsigned char* ring = dos + C::kTile;     // a stage: K | V, 64 keys
  unsigned char* dss = ring + C::kStages * C::kStage + C::kPTile;   // dS

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  // the last query tiles see the most keys under a causal mask: first
  const int i0 = (gridDim.y - 1 - blockIdx.y) * 64;
  const long long q_offset = (long long)t - s;
  // the 64-key tiles the CTA's queries see (the forward's walk: the sink
  // tiles, then the band); the producer and the consumers walk it alike
  const FlashMask mk{t, causal, has_window, window, meta_len};
  const long long qlo = q_offset + i0;
  const long long qhi = q_offset + min(i0 + 64, s) - 1;
  const FlashMask::KvWalk walk = mk.kv_walk(qlo, qhi, 64);
  const int n_kt = walk.n_tiles;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      hopper::prefetch_tensor_map(&qm);
      hopper::prefetch_tensor_map(&dom);
      hopper::prefetch_tensor_map(&km);
      hopper::prefetch_tensor_map(&vm);
      hopper::mbar_arrive_expect_tx(&q_full, 2 * C::kTile);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a) {
        hopper::tma_load_3d(qs + a * C::kAtom, &qm, &q_full, a * 64, i0, bh);
        hopper::tma_load_3d(dos + a * C::kAtom, &dom, &q_full, a * 64, i0,
                            bh);
      }
      const int kv_bh = b * hkv + kvh;
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < n_kt; ++it) {
        const int kpos0 = walk.tile(it) * 64;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * C::kStage;
        hopper::mbar_arrive_expect_tx(&full[stage], C::kStage);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a) {
          hopper::tma_load_3d(st + a * C::kAtom, &km, &full[stage], a * 64,
                              kpos0, kv_bh);
          hopper::tma_load_3d(st + C::kTile + a * C::kAtom, &vm,
                              &full[stage], a * 64, kpos0, kv_bh);
        }
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroups
  hopper::setmaxnreg_inc<240>();
  const int wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2);   // query row in the 64
  const int c0 = 2 * (lane & 3);                  // key column offset
  const int kh = 32 * wg;                         // this WG's key columns
  const uint32_t dh = wg * 2 * C::kAtom;          // its head-dim atoms
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dl[2];                           // rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = i0 + r0 + 8 * h;
    const bool in = row < s;
    lse2[h] = in ? lse[(long long)bh * s + row] * kLog2e : INFINITY;
    dl[h] = in ? delta[(long long)bh * s + row] : 0.f;
  }

  float adq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) adq[i] = 0.f;

  hopper::mbar_wait(&q_full, 0);
  const uint32_t q_base = hopper::smem_u32(qs);
  const uint32_t do_base = hopper::smem_u32(dos);
  const uint32_t ds_base = hopper::smem_u32(dss);
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_kt; ++it) {
    const long long kpos0 = (long long)walk.tile(it) * 64;
    // the tile-level mask test on the CTA's queries, the same for both
    // warpgroups; every tile of the walk holds a kept pair
    const bool need_mask = mk.need_mask(kpos0, 64, qlo, qhi);
    hopper::mbar_wait(&full[stage], phase);
    const uint32_t k_st = hopper::smem_u32(ring + stage * C::kStage);
    const uint32_t v_st = k_st + C::kTile;
    // S = Q K^T and dP = dO V^T on this WG's 32 keys (fp32)
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kD / 16; ++kk)
      hopper::WgmmaBf16SS<32>::mma(
          sc, hopper::desc_k_atoms<128>(q_base, 64, kk),
          hopper::desc_k_atoms<128>(k_st + kh * 128, 64, kk), 1);
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < C::kD / 16; ++kk)
      hopper::WgmmaBf16SS<32>::mma(
          dp, hopper::desc_k_atoms<128>(do_base, 64, kk),
          hopper::desc_k_atoms<128>(v_st + kh * 128, 64, kk), 1);
    hopper::wgmma_commit();

    // P while dP is still in the tensor cores, then dS to shared memory
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);
    auto lse_at = [&](int idx) { return lse2[(idx >> 1) & 1]; };
    auto kept = [&](int idx) {
      return mk.kept(qlo + r0 + frag_row(idx),
                     kpos0 + kh + c0 + frag_col(idx));
    };
    if (need_mask)
      p_tile<true>(sc, scale_log2, lse_at, kept);
    else
      p_tile<false>(sc, scale_log2, lse_at, kept);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        st_swizzled(dss, r0 + 8 * h, kh + 8 * j + c0,
                    hopper::pack_bf16(sc[i] * (dp[i] - dl[h]),
                                      sc[i + 1] * (dp[i + 1] - dl[h])));
      }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1, 256);     // dS whole

    // dQ[:, half] += dS K[:, half] (the stage's key rows are the K)
    hopper::fence_regs(adq);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::WgmmaBf16SS<128, 1>::mma(
          adq, hopper::desc_k_atoms<128>(ds_base, 64, kk),
          hopper::desc_mn_atoms<128>(k_st + dh, 64, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(adq);
    // both WGs done reading dS before either writes it again
    hopper::named_barrier_sync(2, 256);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) { stage = 0; phase ^= 1; }
  }

  // epilogue: dQ times scale, staged through the idle ring as bf16
  bf16* stq = reinterpret_cast<bf16*>(ring);
  const int col = 128 * wg + c0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stq + (r0 + 8 * h) * C::kLdSt + col +
                                   8 * j) =
          hopper::pack_bf16(adq[4 * j + 2 * h] * scale,
                            adq[4 * j + 2 * h + 1] * scale);
  hopper::named_barrier_sync(1, 256);
  store_rows(dq, stq, (long long)bh * s + i0, min(64, s - i0));
}

// bf16 at D = 256: 64-row tiles in both kernels
int launch_split(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int bh, int hq, int hkv, int s, int t,
                 int causal, int has_window, long long window,
                 long long meta_len, float scale, cudaStream_t stream) {
  using C = Bs;
  constexpr int D = C::kD;
  const int batch = bh / hq;
  // 3-D maps over (D, rows, batch x head), 128-byte swizzle, 64-row boxes
  CUtensorMap qm, dom, km, vm;
  const cuuint64_t qdims[3] = {D, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t qstr[2] = {D * 2, (cuuint64_t)s * D * 2};
  const cuuint64_t kdims[3] = {D, (cuuint64_t)t, (cuuint64_t)batch * hkv};
  const cuuint64_t kstr[2] = {D * 2, (cuuint64_t)t * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  struct Map {
    CUtensorMap* map;
    const void* base;
    const cuuint64_t* dims;
    const cuuint64_t* strides;
  } maps[4] = {{&qm, q, qdims, qstr}, {&dom, dout, qdims, qstr},
               {&km, k, kdims, kstr}, {&vm, v, kdims, kstr}};
  for (const Map& m : maps) {
    const int rc = hopper::make_tensor_map(
        m.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, m.base, m.dims,
        m.strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_split_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dq_split_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  int rc = launch_delta<bf16, D>(o, dout, delta, bh, s, stream);
  if (rc) return rc;
  const dim3 grid_kv((unsigned)(batch * hkv), (unsigned)((t + 63) / 64));
  flash_bwd_dkdv_split_kernel<<<grid_kv, C::kThreads, C::kSmem, stream>>>(
      qm, dom, km, vm, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hq, hkv, s, t, causal, has_window, window,
      meta_len, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const dim3 grid_q((unsigned)bh, (unsigned)((s + 63) / 64));
  flash_bwd_dq_split_kernel<<<grid_q, C::kThreads, C::kSmem, stream>>>(
      qm, dom, km, vm, lse, delta, static_cast<bf16*>(dq), hq, hkv, s, t,
      causal, has_window, window, meta_len, scale);
  return (int)cudaGetLastError();
}

#define BWD_ARGS                                                             \
  q, k, v, o, dout, static_cast<const float*>(lse),                          \
      static_cast<float*>(delta), dq, dk, dv, bh, hq, hkv, s, t, causal,     \
      has_window, window, meta_len, scale, stream

}  // namespace

// bh = B * Hq, Hq % Hkv == 0, S <= T, 16-byte aligned contiguous operands
// (the wrapper checks them and the grid limits); delta is fp32 scratch of
// B * Hq * S. Three launches on `stream`: D, then dK and dV, then dQ.
// Returns cudaGetLastError() after the first launch that fails, else after
// the last (cudaErrorInvalidValue for a head dim the instance does not
// take; 1000 + cuTensorMapEncodeTiled's result if a tensor map cannot be
// encoded).
#define BWD_PARAMS                                                           \
  const void *q, const void *k, const void *v, const void *o,                \
      const void *dout, const void *lse, void *delta, void *dq, void *dk,    \
      void *dv, int bh, int hq, int hkv, int s, int t, int d, int causal,    \
      int has_window, long long window, long long meta_len, float scale,     \
      cudaStream_t stream

// bf16, the Hopper design: D in {64, 80, 128, 256}
extern "C" int flash_attention_bwd_bf16_wgmma(BWD_PARAMS) {
  switch (d) {
    case 64: return launch_wgmma<64>(BWD_ARGS);
    case 80: return launch_wgmma<80>(BWD_ARGS);
    case 128: return launch_wgmma<128>(BWD_ARGS);
    case 256: return launch_split(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16, the simple WMMA design: D = 32
extern "C" int flash_attention_bwd_bf16(BWD_PARAMS) {
  switch (d) {
    case 32: return launch_simple<TcMath<32>, 32>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// fp32 on the CUDA cores: D in {32, 64, 128}
extern "C" int flash_attention_bwd_f32(BWD_PARAMS) {
  switch (d) {
    case 32: return launch_simple<CcMath<32>, 32>(BWD_ARGS);
    case 64: return launch_simple<CcMath<64>, 64>(BWD_ARGS);
    case 128: return launch_simple<CcMath<128>, 128>(BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}
