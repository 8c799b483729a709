// Causal / sliding-window flash attention with GQA for Hopper (LM prefill):
//     out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / rep, j])
//                    v[b, h / rep, j]
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
// tensor cores for bf16.
//
// Design of the bf16 instance (flash_attention_wgmma_kernel): blocks run
// in no order, so one CTA owns one (batch x query head, 128-query tile)
// pair and walks only the KV tiles of 128 keys that the causal and window
// tests keep (the Pallas kernel's skip), from the first key inside the
// window of its first query to the last key its last query sees. The KV
// head is h / rep, read in place and never repeated in memory. A producer
// warp loads Q once and K and V tile by tile with TMA (3-D tensor maps
// over (D, rows, batch x head), 128- or 64-byte swizzle; rows past S or T
// read as zero) into a 2-stage ring of mbarriers. Two consumer warpgroups
// own 64 query rows each: S = Q K^T by wgmma m64n128k16 from shared
// memory (both K-major), the online softmax on the accumulator fragment
// (a row lives in a quad of threads: two shuffles for its max), P rounded
// to bf16 as the plain version rounds it and fed from registers as the A
// operand of O += P V (wgmma m64nDk16, V MN-major through the transpose
// bit). O, the row max and the row sum stay in registers across all KV
// tiles. The fp32 product is scaled (as the Pallas kernel does) and the
// softmax runs in base 2 with the scale folded in; masked scores are -inf
// and weigh exactly 0; the output is acc / max(z, 1e-30), so a row with
// no kept key is 0. The per-element mask runs only on tiles that cross
// the diagonal, the window edge or T.
//
// The fp32 instance (flash_attention_cuda_core_kernel, used by the fp32
// smoke config and the 1e-5 card tests) keeps the CUDA-core design: a CTA
// owns 64 queries, four warps of 16 rows, two threads a row, Q, K and V
// tiles of 64 in shared memory, scores and accumulator in fp32 registers.
//
// Any S <= T, causal or not, any window, D in {32, 64, 128}.
//
// For training, both instances also write the row log-sum-exp of the
// scaled scores, lse = m + log z (fp32, (B, Hq, S), natural log), when the
// caller passes an lse buffer; the backward (flash_attention_bwd.cu)
// recomputes P from it. Serving passes none and the store is skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16: wgmma, TMA ring, register accumulator --------------------------

template <int D>
struct Wg {
  static constexpr int kBQ = 128;            // queries a CTA (2 x 64)
  static constexpr int kBK = 128;            // keys a KV tile
  static constexpr int kThreads = 2 * 128 + 32;
  static constexpr int kStages = 2;
  static constexpr int kSw = D * 2 >= 128 ? 128 : D * 2;  // swizzle bytes
  static constexpr int kBoxCols = kSw / 2;   // bf16 a swizzled row
  static constexpr int kAtoms = D / kBoxCols;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKVBytes = kBK * D * 2;
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes + 1024;
  static constexpr CUtensorMapSwizzle kSwizzle =
      kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
};

template <int D>
__global__ void __launch_bounds__(Wg<D>::kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qm,
                             const __grid_constant__ CUtensorMap km,
                             const __grid_constant__ CUtensorMap vm,
                             bf16* __restrict__ out,
                             float* __restrict__ lse, int hq, int hkv, int s,
                             int t, int causal, int has_window,
                             long long window, float scale_log2) {
  using C = Wg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kSw = C::kSw;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[C::kStages],
      v_full[C::kStages], empty[C::kStages];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* ks = qs + C::kQBytes;
  unsigned char* vs = ks + C::kStages * C::kKVBytes;

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int kvh = (bh % hq) / (hq / hkv);
  const int i0 = blockIdx.y * kBQ;
  const long long q_offset = (long long)t - s;

  // KV tiles kept by the tile-level causal and window tests
  const long long qlo = q_offset + i0;
  const long long qhi = q_offset + min(i0 + kBQ, s) - 1;
  long long klo = 0, khi = (long long)t - 1;
  if (causal) khi = min(khi, qhi);
  if (has_window) klo = max(klo, qlo - window + 1);
  const int kt0 = (int)(klo / kBK);
  const int n_tiles = khi >= klo ? (int)(khi / kBK) - kt0 + 1 : 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int i = 0; i < C::kStages; ++i) {
      hopper::mbar_init(&k_full[i], 1);
      hopper::mbar_init(&v_full[i], 1);
      hopper::mbar_init(&empty[i], 8);      // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer warp: one thread issues every load
    if (lane == 0) {
      hopper::prefetch_tensor_map(&qm);
      hopper::prefetch_tensor_map(&km);
      hopper::prefetch_tensor_map(&vm);
      hopper::mbar_arrive_expect_tx(&q_full, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        hopper::tma_load_3d(qs + a * kBQ * kSw, &qm, &q_full,
                            a * C::kBoxCols, i0, bh);
      const int kv_bh = b * hkv + kvh;
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int kpos0 = (kt0 + i) * kBK;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* kst = ks + stage * C::kKVBytes;
        unsigned char* vst = vs + stage * C::kKVBytes;
        hopper::mbar_arrive_expect_tx(&k_full[stage], C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          hopper::tma_load_3d(kst + a * kBK * kSw, &km, &k_full[stage],
                              a * C::kBoxCols, kpos0, kv_bh);
        hopper::mbar_arrive_expect_tx(&v_full[stage], C::kKVBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          hopper::tma_load_3d(vst + a * kBK * kSw, &vm, &v_full[stage],
                              a * C::kBoxCols, kpos0, kv_bh);
        if (++stage == C::kStages) { stage = 0; phase ^= 1; }
      }
    }
    return;
  }

  // consumer warpgroups: wg owns query rows 64 wg .. 64 wg + 63 of the tile;
  // this thread holds rows r0 and r0 + 8, columns 8 j + 2 (lane % 4) + c
  const int wg = warp >> 2;
  const int q4 = lane & 3;
  const int r0 = warp * 16 + (lane >> 2);
  const long long qpos0 = q_offset + i0 + r0;
  const float kInf = INFINITY;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-kInf, -kInf};   // row max of the scaled (base-2) scores
  float z[2] = {0.f, 0.f};       // this thread's part of the row sum

  hopper::mbar_wait(&q_full, 0);
  const uint32_t q_base = hopper::smem_u32(qs) + wg * 64 * kSw;
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const long long kpos0 = (long long)(kt0 + i) * kBK;
    const uint32_t k_base = hopper::smem_u32(ks + stage * C::kKVBytes);
    const uint32_t v_base = hopper::smem_u32(vs + stage * C::kKVBytes);

    // S = Q K^T (64 x 128 a warpgroup, fp32)
    float sc[kBK / 2];
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) sc[j] = 0.f;
    hopper::mbar_wait(&k_full[stage], phase);
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int atom = kk * 16 / C::kBoxCols;
      const int within = (kk * 16 % C::kBoxCols) * 2;
      const uint64_t da = hopper::smem_desc(
          q_base + atom * kBQ * kSw + within, 16, 8 * kSw, kSw);
      const uint64_t db = hopper::smem_desc(
          k_base + atom * kBK * kSw + within, 16, 8 * kSw, kSw);
      hopper::WgmmaBf16SS<kBK>::mma(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale (base 2), mask, online softmax on the fragment
    const bool need_mask =
        kpos0 + kBK > t || (causal && kpos0 + kBK - 1 > qlo) ||
        (has_window && kpos0 <= q_offset + i0 + kBQ - 1 - window);
    float tmax[2] = {-kInf, -kInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * h + c;
          float x = sc[idx] * scale_log2;
          if (need_mask) {
            const long long kpos = kpos0 + 8 * j + 2 * q4 + c;
            const long long qpos = qpos0 + 8 * h;
            const bool ok = kpos < t && (!causal || kpos <= qpos) &&
                            (!has_window || kpos > qpos - window);
            x = ok ? x : -kInf;
          }
          sc[idx] = x;
          tmax[h] = fmaxf(tmax[h], x);
        }
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      m_use[h] = m_new == -kInf ? 0.f : m_new;   // no key kept yet
      alpha[h] = exp2f(m[h] - m_use[h]);
      m[h] = m_new;
      z[h] *= alpha[h];
    }
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int h = (e >> 1) & 1;
        p[e] = exp2f(sc[8 * kk + e] - m_use[h]);   // masked: exactly 0
        z[h] += p[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = hopper::pack_bf16(p[2 * e],
                                                                p[2 * e + 1]);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // O += P V (V MN-major: keys are its rows)
    hopper::mbar_wait(&v_full[stage], phase);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t dv = hopper::smem_desc(v_base + kk * 16 * kSw,
                                            kBK * kSw, 8 * kSw, kSw);
      hopper::WgmmaBf16RS<D, 1>::mma(o, pa[kk], dv, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    if (++stage == C::kStages) { stage = 0; phase ^= 1; }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    z[h] += __shfl_xor_sync(0xffffffffu, z[h], 1);
    z[h] += __shfl_xor_sync(0xffffffffu, z[h], 2);
    const int row = i0 + r0 + 8 * h;
    if (row >= s) continue;
    if (lse != nullptr && q4 == 0)   // m is in base 2: ln 2 (m + log2 z)
      lse[(long long)bh * s + row] =
          (m[h] + log2f(z[h])) * 0.69314718055994531f;
    const float inv = 1.f / fmaxf(z[h], 1e-30f);
    bf16* orow = out + ((long long)bh * s + row) * D + 2 * q4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t v = hopper::pack_bf16(o[4 * j + 2 * h] * inv,
                                           o[4 * j + 2 * h + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = v;
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int bh, int hq, int hkv, int s, int t, int causal,
                 int has_window, long long window, float scale,
                 cudaStream_t stream) {
  using C = Wg<D>;
  const int batch = bh / hq;
  CUtensorMap qm, km, vm;
  const cuuint32_t box[3] = {C::kBoxCols, 128, 1};
  const cuuint64_t qdims[3] = {D, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t qstr[2] = {D * 2, (cuuint64_t)s * D * 2};
  const cuuint64_t kdims[3] = {D, (cuuint64_t)t, (cuuint64_t)batch * hkv};
  const cuuint64_t kstr[2] = {D * 2, (cuuint64_t)t * D * 2};
  int rc = hopper::make_tensor_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                   q, qdims, qstr, box, C::kSwizzle);
  if (rc) return rc;
  rc = hopper::make_tensor_map(&km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, k,
                               kdims, kstr, box, C::kSwizzle);
  if (rc) return rc;
  rc = hopper::make_tensor_map(&vm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, v,
                               kdims, kstr, box, C::kSwizzle);
  if (rc) return rc;
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)bh, (unsigned)((s + C::kBQ - 1) / C::kBQ));
  flash_attention_wgmma_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      qm, km, vm, static_cast<bf16*>(out), lse, hq, hkv, s, t, causal,
      has_window, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ---- fp32: CUDA cores ------------------------------------------------------

constexpr int kBQ = 64;           // queries per CTA
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 128;     // 4 warps x 16 rows, 2 threads a row
constexpr float kNeg = -1e30f;

template <int D>
struct Layout {
  static constexpr int kLdX = D + 4;             // Q, K, V rows (padded)
  static constexpr int kLdS = kBK + 4;           // fp32 weights
  static constexpr int kScratch = 16 * kLdS;     // a warp's 16 weight rows
  static constexpr size_t kBytes =
      3 * (size_t)kBQ * kLdX * sizeof(float) +
      (size_t)(kThreads / 32) * kScratch * sizeof(float);
};

// rows [row0, row0 + kBQ) of a (rows, D) matrix into a padded tile; rows
// past n_rows read zero
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row0, long long n_rows) {
  constexpr int kPerRow = D / 4;
  for (int c = threadIdx.x; c < kBQ * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      v = __ldg(reinterpret_cast<const float4*>(src + (row0 + r) * D + col));
    *reinterpret_cast<float4*>(dst + r * Layout<D>::kLdX + col) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_cuda_core_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ out,
                                 float* __restrict__ lse, int hq, int hkv,
                                 int s, int t, int causal, int has_window,
                                 long long window, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * L::kLdX;
  float* Vs = Ks + kBK * L::kLdX;
  float* scratch = Vs + kBK * L::kLdX;

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
  const float* qb = q + (long long)bh * s * D;
  const float* kb = k + (b * hkv + kvh) * t * D;
  const float* vb = v + (b * hkv + kvh) * t * D;

  load_tile<D>(Qs, qb, i0, s);

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
    load_tile<D>(Ks, kb, kpos0, t);
    load_tile<D>(Vs, vb, kpos0, t);
    __syncthreads();

    float sc[32];
    const float* qrow = Qs + r * L::kLdX;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const float* krow = Ks + (half * 32 + j) * L::kLdX;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], krow[d], acc);
      sc[j] = acc;
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
      ws[rl * L::kLdS + half * 32 + j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    z = z * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o[c] *= alpha;
    __syncwarp();

    // o += P V for the thread's D / 2 columns
    const float* prow = ws + rl * L::kLdS;
    for (int j = 0; j < kBK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * L::kLdX + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] = fmaf(p, vrow[c], o[c]);
    }
    __syncwarp();
  }

  if (i0 + r < s) {
    if (lse != nullptr && half == 0)
      lse[(long long)bh * s + i0 + r] = m + logf(z);
    const float zz = fmaxf(z, 1e-30f);
    float* orow = out + ((long long)bh * s + i0 + r) * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) orow[c] = o[c] / zz;
  }
}

template <int D>
int launch_cuda_core(const void* q, const void* k, const void* v, void* out,
                     float* lse, int bh, int hq, int hkv, int s, int t,
                     int causal, int has_window, long long window, float scale,
                     cudaStream_t stream) {
  constexpr size_t kBytes = Layout<D>::kBytes;
  static bool opted_in = false;      // dynamic shared memory above 48 KB
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_cuda_core_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)bh, (unsigned)((s + kBQ - 1) / kBQ));
  flash_attention_cuda_core_kernel<D><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, hq, hkv, s,
      t, causal, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <bool kWgmma>
int dispatch_d(const void* q, const void* k, const void* v, void* out,
               float* lse, int bh, int hq, int hkv, int s, int t, int d,
               int causal, int has_window, long long window, float scale,
               cudaStream_t stream) {
#define FLASH_CASE(DIM)                                                      \
  case DIM:                                                                  \
    return kWgmma ? launch_wgmma<DIM>(q, k, v, out, lse, bh, hq, hkv, s, t,  \
                                      causal, has_window, window, scale,     \
                                      stream)                                \
                  : launch_cuda_core<DIM>(q, k, v, out, lse, bh, hq, hkv, s,  \
                                          t, causal, has_window, window,     \
                                          scale, stream);
  switch (d) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// bh = B * Hq CTAs along x (the wrapper checks the limits), Hq % Hkv == 0,
// S <= T, 16-byte aligned contiguous operands; lse (fp32, B * Hq * S) may
// be null, and then no log-sum-exp is written. Returns cudaGetLastError()
// after the launch, or 1000 + the driver's code if a tensor map cannot be
// encoded (bf16).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int bh, int hq, int hkv, int s, int t,
                                    int d, int causal, int has_window,
                                    long long window, float scale,
                                    cudaStream_t stream) {
  return dispatch_d<true>(q, k, v, out, static_cast<float*>(lse), bh, hq, hkv,
                          s, t, d, causal, has_window, window, scale, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int bh, int hq, int hkv, int s, int t,
                                   int d, int causal, int has_window,
                                   long long window, float scale,
                                   cudaStream_t stream) {
  return dispatch_d<false>(q, k, v, out, static_cast<float*>(lse), bh, hq,
                           hkv, s, t, d, causal, has_window, window, scale,
                           stream);
}
