// K4: the pooled seed extension of the candidate core, one warp a lane.
//
// Replaces abismal_tpu/map/pipeline.py:679-787, the per-lane body of
// _make_core's pooled seed extension: the k-ary lower/upper-bound search
// that the JAX core runs as one jax.lax.fori_loop over bis_body (:701-745),
// the LCP window around the match range (:746-772) and the stop depth,
// rollback and final range (:767-787).  It is not a pl.pallas_call (XLA
// compiles that loop); the port ran it as a Python loop of ~150 torch ops a
// trip.  The compaction into the pool and the scatter back stay in torch
// (abismal_tpu_torch/map/pipeline.py, extension).
//
// Per pooled lane (lane_id; 2 B o_spec marks an empty slot, whose id is
// clamped to the last lane as the plain version does):
//   - setup: table (two- or three-letter), unit pb, offset poff, key weight
//     kw, list base idx_b, bucket [lo0, hi0), depth Dl = clip(len - poff -
//     kw, 0, dqmax), the deep flag (len - poff > n_sort), and the query's
//     qw class words (8 nibbles a u32 word) from the unit's packed nibbles;
//   - kary_iters trips of (ways - 1) probes per bound at a + k (w / ways) +
//     (k (w % ways)) / ways (64-bit; w > 0 wherever a probe counts), each a
//     lexicographic compare of the genome's class string at index_all[idx_b
//     + p] + kw with the query to depth Dl; the bounds move by max / min;
//   - the LCPs of the 2 ext_w window positions around [Lb, Ub) inside
//     [lo0, hi0) (-1 elsewhere), and from them the stop depth: kth is the
//     (mc - (Ub - Lb))-th largest window LCP, ties counted, as topk then
//     gather picks it, which is the largest v with count(lcp >= v) > that
//     index; then t*, the rollback, the depth and the range.
// Every value is an integer: the output equals seed_extend_plain exactly.
//
// Bound on the H100: latency, not bytes or operations.  A 512-lane pool
// reads ~11 MB at most (4-9 trips of 2 (ways - 1) probes and 258 window
// positions, each an 8-byte index entry and up to 15 genome words), ~3 us
// at 3.35 TB/s, and its integer work is smaller still; but each trip is a
// dependent chain: an index_all gather, then the genome words it names,
// then a warp reduction that the next trip's probes need.  So the design
// keeps that chain short and everything else beside it:
//   - one warp a lane, so the bounds, the early stop and every reduction
//     are warp-uniform and nothing waits on another lane's warp;
//   - the 2 (ways - 1) probes of a trip run on their own threads at once;
//     the four bounds move in four 64-bit shuffle reductions;
//   - a compare walks the class words two at a time with the genome words
//     of both loaded together, and stops at the first differing word (most
//     probes differ within the first word or two);
//   - a lane whose two bounds have closed stops its trips (the later trips
//     are no-ops in the plain version's a < b guards);
//   - the window's positions are spread over the warp's 32 threads, each
//     LCP kept in the warp's slice of shared memory, and the stop depth is
//     a binary search over the LCP's value range with one __reduce_add_sync
//     a step (no sort, no histogram bins to clear);
//   - the query's class words are built once into shared memory and read
//     there by every compare (a broadcast when the threads agree on the
//     word).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;  // lanes of the pool a block
constexpr int BIGI = 0x3FFFFFFF;

struct Lane {
  const uint32_t* genome;
  int64_t n_gw;
  const int64_t* index_all;
  int64_t n_idx;
  const uint32_t* qs;  // the query's class words, in shared memory
  int64_t idx_b;
  int kw, D;
  bool t3, ga;
};

__device__ __forceinline__ int64_t imax64(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t shfl_xor64(int64_t v, int m) {
  const uint64_t u = static_cast<uint64_t>(v);
  const int lo = __shfl_xor_sync(FULL, static_cast<int>(u & 0xFFFFFFFFu), m);
  const int hi = __shfl_xor_sync(FULL, static_cast<int>(u >> 32), m);
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
      static_cast<uint32_t>(lo));
}

__device__ __forceinline__ int64_t warp_max64(int64_t v) {
  for (int m = 16; m; m >>= 1) v = imax64(v, shfl_xor64(v, m));
  return v;
}
__device__ __forceinline__ int64_t warp_min64(int64_t v) {
  for (int m = 16; m; m >>= 1) v = imin64(v, shfl_xor64(v, m));
  return v;
}

// The u32 genome word i; words past the end read 0 (genome_words).
__device__ __forceinline__ uint32_t gword(const uint32_t* __restrict__ g,
                                          int64_t n_gw, int64_t i) {
  return i < n_gw ? __ldg(g + (i < 0 ? 0 : i)) : 0u;
}

// Eight genome nibbles (one aligned word run) to their class nibbles.
__device__ __forceinline__ uint32_t class_word(uint32_t wal, bool t3,
                                               bool ga) {
  const uint32_t m1 = 0x11111111u;
  const uint32_t b0 = wal & m1, b1 = (wal >> 1) & m1;
  const uint32_t b2 = (wal >> 2) & m1, b3 = (wal >> 3) & m1;
  if (!t3) return (b0 | b2) ^ m1;
  const uint32_t hi3 = ga ? b3 : b2;
  const uint32_t lo3 = (ga ? b1 : b0) | hi3;
  return (hi3 << 1) | (lo3 & ~hi3);
}

// One query nibble to its class (nib_cls).
__device__ __forceinline__ uint32_t nib_class(uint32_t nib, bool t3,
                                              bool ga) {
  const uint32_t b0 = nib & 1, b1 = (nib >> 1) & 1;
  const uint32_t b2 = (nib >> 2) & 1, b3 = (nib >> 3) & 1;
  if (!t3) return 1u - (b0 | b2);
  const uint32_t hi3 = ga ? b3 : b2;
  const uint32_t lo3 = (ga ? b1 : b0) | hi3;
  return 2u * hi3 + (lo3 & (1u - hi3));
}

// Class word j of the genome (wal) against the query to depth D: true at
// the first differing nibble, with lcp and cmp set (lex).
__device__ __forceinline__ bool word_differs(const Lane& L, int j,
                                             uint32_t wal, int& lcp,
                                             int& cmp) {
  const uint32_t g = class_word(wal, L.t3, L.ga);
  const uint32_t q = L.qs[j];
  const int nrem = min(L.D - 8 * j, 8);
  const uint32_t mask = nrem >= 8 ? FULL : (1u << (4 * nrem)) - 1u;
  const uint32_t diff = (g ^ q) & mask;
  if (!diff) return false;
  const int nib = (__ffs(diff) - 1) >> 2;
  const uint32_t gv = (g >> (4 * nib)) & 0xFu;
  const uint32_t qv = (q >> (4 * nib)) & 0xFu;
  lcp = 8 * j + nib;
  cmp = gv < qv ? -1 : 1;
  return true;
}

// (lcp, cmp) of the genome's class string at index_all[clamp(idx)] + kw
// against the query, to depth D.
__device__ void compare_at(const Lane& L, int64_t idx, int& lcp, int& cmp) {
  idx = imin64(imax64(idx, 0), L.n_idx - 1);
  const int64_t g0 = L.index_all[idx] + L.kw;
  const int64_t w0 = g0 >> 3;
  const unsigned sh = static_cast<unsigned>(g0 & 7) * 4u;
  uint32_t a = gword(L.genome, L.n_gw, w0);
  for (int j = 0; 8 * j < L.D; j += 2) {
    const uint32_t b = gword(L.genome, L.n_gw, w0 + j + 1);
    const uint32_t c = gword(L.genome, L.n_gw, w0 + j + 2);
    if (word_differs(L, j, __funnelshift_r(a, b, sh), lcp, cmp)) return;
    if (8 * (j + 1) >= L.D) break;
    if (word_differs(L, j + 1, __funnelshift_r(b, c, sh), lcp, cmp)) return;
    a = c;
  }
  lcp = L.D;
  cmp = 0;
}

__global__ void seed_extend_kernel(
    const uint32_t* __restrict__ genome32, int64_t n_gw,
    const int64_t* __restrict__ index_all, int64_t n_idx,
    const uint8_t* __restrict__ pnib, int W,
    const int64_t* __restrict__ lens, const uint8_t* __restrict__ is_ga,
    const int64_t* __restrict__ base3, const int64_t* __restrict__ s2,
    const int64_t* __restrict__ e2, const int64_t* __restrict__ s3,
    const int64_t* __restrict__ e3, int B, int o_spec,
    const int64_t* __restrict__ lane_id, int P, int dqmax, int qw, int kw2,
    int kw3, int mc, int ways, int kary_iters, int ext_w, int n_sort,
    int64_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int t = threadIdx.x & 31;
  const int wb = threadIdx.x >> 5;
  const int lane = blockIdx.x * WARPS + wb;
  if (lane >= P) return;  // the whole warp
  const int n_w = 2 * ext_w;
  uint32_t* const qs = smem + wb * (qw + n_w);
  int* const lcps = reinterpret_cast<int*>(qs + qw);

  // --- setup
  const int64_t n_lanes = static_cast<int64_t>(B) * o_spec;
  const int64_t lid0 = lane_id[lane];
  const bool pvv = lid0 < 2 * n_lanes;
  const int64_t lid = imin64(lid0, 2 * n_lanes - 1);
  const bool t3 = lid >= n_lanes;
  const int64_t rem = lid % n_lanes;
  const int64_t pb = rem / o_spec;
  const int poff = static_cast<int>(rem % o_spec);
  Lane L;
  L.genome = genome32;
  L.n_gw = n_gw;
  L.index_all = index_all;
  L.n_idx = n_idx;
  L.qs = qs;
  L.t3 = t3;
  L.ga = t3 && is_ga[pb] != 0;
  L.kw = t3 ? kw3 : kw2;
  L.idx_b = t3 ? base3[pb] : 0;
  const int64_t lo0 = t3 ? s3[rem] : s2[rem];
  const int64_t hi0 = t3 ? e3[rem] : e2[rem];
  const int64_t rl = lens[pb] - poff;
  L.D = static_cast<int>(imin64(imax64(rl - L.kw, 0), dqmax));

  // the query's class words, nibbles from offset poff + kw (0 past the
  // unit's row)
  const int stride = 2 * W;
  const uint8_t* row = pnib + pb * W;
  for (int w = t; w < qw; w += 32) {
    uint32_t word = 0;
    for (int k = 0; k < 8; ++k) {
      const int jx = poff + L.kw + 8 * w + k;
      const uint32_t nib =
          jx < stride ? (row[jx >> 1] >> (4 * (jx & 1))) & 0xFu : 0u;
      word |= nib_class(nib, L.t3, L.ga) << (4 * k);
    }
    qs[w] = word;
  }
  __syncwarp();

  // --- the k-ary lower / upper-bound search
  const int nprb = ways - 1;
  int64_t aL = lo0, bL = hi0, aU = lo0, bU = hi0;
  for (int it = 0; it < kary_iters; ++it) {
    if (aL >= bL && aU >= bU) break;  // every later trip is a no-op
    int64_t naL = aL, nbL = bL, naU = aU, nbU = bU;
    for (int p = t; p < 2 * nprb; p += 32) {
      const bool upper = p >= nprb;
      const int64_t k = (upper ? p - nprb : p) + 1;
      const int64_t a = upper ? aU : aL, b = upper ? bU : bL;
      if (a >= b) continue;  // this bound has closed: no update
      const int64_t w = b - a;
      const int64_t pr = a + k * (w / ways) + (k * (w % ways)) / ways;
      int lcp, cmp;
      compare_at(L, L.idx_b + pr, lcp, cmp);
      if (!upper) {
        if (cmp < 0) naL = imax64(naL, pr + 1);
        else nbL = imin64(nbL, pr);
      } else {
        if (cmp <= 0) naU = imax64(naU, pr + 1);
        else nbU = imin64(nbU, pr);
      }
    }
    aL = warp_max64(naL);
    bL = warp_min64(nbL);
    aU = warp_max64(naU);
    bU = warp_min64(nbU);
  }
  const int64_t Lb = aL, Ub = aU;

  // --- the LCP window: ext_w positions on each side of [Lb, Ub)
  for (int i = t; i < n_w; i += 32) {
    const int64_t wofs = i < ext_w ? Lb - 1 - i : Ub + (i - ext_w);
    int lcp = -1, cmp;
    if (pvv && wofs >= lo0 && wofs < hi0)
      compare_at(L, L.idx_b + wofs, lcp, cmp);
    lcps[i] = lcp;
  }

  // --- stop depth, rollback and final range
  const int64_t c0 = Ub - Lb;
  int kth = 0;
  if (c0 <= mc) {
    // the j-th largest LCP, j = min(mc - c0, mc) (c0 < 0 where a bucket is
    // not sorted): the largest v in [-1, dqmax] with count(lcp >= v) >=
    // j + 1 (count(lcp >= -1) is n_w > mc >= j)
    const int need = static_cast<int>(imin64(mc - c0, mc)) + 1;
    int lo = -1, hi = dqmax + 1;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      int n = 0;
      for (int i = t; i < n_w; i += 32) n += lcps[i] >= mid;
      if (__reduce_add_sync(FULL, n) >= need) lo = mid;
      else hi = mid;
    }
    kth = lo;
  }
  const int tstar = c0 > mc ? BIGI : max(kth + 1, 1);
  const int tfin = min(tstar, L.D);
  int n = 0;
  for (int i = t; i < n_w; i += 32) n += lcps[i] >= tfin;
  const int64_t cnt_fin = c0 + __reduce_add_sync(FULL, n);
  const int t_use = (cnt_fin == 0 && tfin >= 1) ? tfin - 1 : tfin;
  const int thr = max(t_use, 1);
  n = 0;  // left-side count in the low 16 bits, right side above
  for (int i = t; i < n_w; i += 32)
    n += (lcps[i] >= thr) << (i < ext_w ? 0 : 16);
  n = __reduce_add_sync(FULL, n);
  if (t == 0) {
    const bool fullr = t_use == 0;
    out[lane] = L.kw + t_use;
    out[P + lane] = fullr ? lo0 : Lb - (n & 0xFFFF);
    out[2 * P + lane] = fullr ? hi0 : Ub + (n >> 16);
    out[3 * P + lane] = pvv && rl > n_sort;
  }
}

}  // namespace

extern "C" int seed_extend_launch(
    const void* genome32, int64_t n_gw, const void* index_all, int64_t n_idx,
    const void* pnib, int W, const void* lens, const void* is_ga,
    const void* base3, const void* s2, const void* e2, const void* s3,
    const void* e3, int B, int o_spec, const void* lane_id, int P, int dqmax,
    int qw, int kw2, int kw3, int mc, int ways, int kary_iters, int ext_w,
    int n_sort, void* out, void* stream) {
  if (ways < 2 || 2 * ext_w >= 1 << 16 || mc + 1 > 2 * ext_w || P <= 0 ||
      static_cast<int64_t>(B) * o_spec <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (P + WARPS - 1) / WARPS;
  const size_t smem = sizeof(uint32_t) * WARPS * (qw + 2 * ext_w);
  seed_extend_kernel<<<blocks, 32 * WARPS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(genome32), n_gw,
      static_cast<const int64_t*>(index_all), n_idx,
      static_cast<const uint8_t*>(pnib), W, static_cast<const int64_t*>(lens),
      static_cast<const uint8_t*>(is_ga), static_cast<const int64_t*>(base3),
      static_cast<const int64_t*>(s2), static_cast<const int64_t*>(e2),
      static_cast<const int64_t*>(s3), static_cast<const int64_t*>(e3), B,
      o_spec, static_cast<const int64_t*>(lane_id), P, dqmax, qw, kw2, kw3,
      mc, ways, kary_iters, ext_w, n_sort, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
