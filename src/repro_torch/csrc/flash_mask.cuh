// The mask and the tile walks of the flash attention kernels, forward
// (flash_attention.cu) and backward (flash_attention_bwd.cu), in one place
// so that every instance, and the producer and consumers of each, walk
// the same tiles and keep the same pairs.
//
// Query i sits at absolute position q_offset + i (q_offset = T - S); key
// kpos is kept for the query at qpos when kpos < T, kpos <= qpos if
// causal, and, with a window, kpos > qpos - window or kpos < meta_len:
// the first meta_len keys are attention sinks (hymba's meta tokens),
// visible to every later query whatever the window says. Without a
// window every key is visible anyway and meta_len changes nothing. With
// meta_len = 0 every walk and test below is the one the kernels had
// before sinks: the same tiles in the same order.
#pragma once

struct FlashMask {
  long long t;
  int causal, has_window;
  long long window, meta_len;

  __host__ __device__ bool kept(long long qpos, long long kpos) const {
    return kpos < t && (!causal || kpos <= qpos) &&
           (!has_window || kpos > qpos - window || kpos < meta_len);
  }

  // The KV tiles of bk keys that queries qlo .. qhi see, in walk order:
  // the sink tiles first (those below the band that hold a sink key the
  // last query may see), then the band the causal and window tests keep.
  // No tile is walked twice.
  struct KvWalk {
    int n_sink, kt0, n_tiles;
    __host__ __device__ int tile(int i) const {
      return i < n_sink ? i : kt0 + (i - n_sink);
    }
  };
  __host__ __device__ KvWalk kv_walk(long long qlo, long long qhi,
                                     int bk) const {
    long long klo = 0, khi = t - 1;
    if (causal) khi = khi < qhi ? khi : qhi;
    if (has_window && qlo - window + 1 > klo) klo = qlo - window + 1;
    KvWalk w;
    w.kt0 = (int)(klo / bk);
    const int n_band = khi >= klo ? (int)(khi / bk) - w.kt0 + 1 : 0;
    w.n_sink = 0;
    if (has_window && meta_len > 0 && khi >= 0) {
      const long long last = meta_len < khi + 1 ? meta_len : khi + 1;
      w.n_sink = (int)((last + bk - 1) / bk);
      if (n_band > 0 && w.n_sink > w.kt0) w.n_sink = w.kt0;
    }
    w.n_tiles = w.n_sink + n_band;
    return w;
  }

  // The query tiles of `step` rows that see a key of k0 .. kmax (the dK /
  // dV walk): from the diagonal, to S where the keys hold a sink, else
  // to the window's edge. Sets the first tile and the count.
  __host__ __device__ void q_walk(long long k0, long long kmax, int s,
                                  int step, int* qt0, int* n_qt) const {
    const long long q_offset = t - s;
    long long ilo = 0, ihi = (long long)s - 1;
    if (causal && k0 - q_offset > ilo) ilo = k0 - q_offset;
    if (has_window && k0 >= meta_len && kmax + window - 1 - q_offset < ihi)
      ihi = kmax + window - 1 - q_offset;
    *qt0 = (int)(ilo / step);
    *n_qt = ihi >= ilo ? (int)(ihi / step) - *qt0 + 1 : 0;
  }

  // Tile-level tests on keys k_lo .. k_lo + span - 1 (k_last: the last
  // below T) against queries q_lo .. q_hi. skip: no pair is kept.
  __host__ __device__ bool skip(long long k_lo, long long k_last,
                                long long q_lo, long long q_hi) const {
    return k_lo >= t || (causal && k_lo > q_hi) ||
           (has_window && k_last <= q_lo - window && k_lo >= meta_len);
  }
  // need_mask: a pair is masked, or a key lies past T
  __host__ __device__ bool need_mask(long long k_lo, int span, long long q_lo,
                                     long long q_hi) const {
    const long long k_hi = k_lo + span - 1;
    const long long lo = k_lo > meta_len ? k_lo : meta_len;
    const long long hi = k_hi < q_hi - window ? k_hi : q_hi - window;
    return k_lo + span > t || (causal && k_hi > q_lo) ||
           (has_window && lo <= hi);
  }
};
