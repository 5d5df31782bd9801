// K4: the pooled seed extension of the candidate core, from the pool's
// prefix count to the extended cells, in one launch.
//
// Replaces abismal_tpu/map/pipeline.py:523-806 of _make_core's pooled seed
// extension but its prefix count: the pool's lane ids (jnp.nonzero,
// :556-557), the per-lane body (:579-787: the k-ary lower/upper-bound
// search that the JAX core runs as one jax.lax.fori_loop over bis_body,
// :701-745, the LCP window around the match range, :746-772, the stop
// depth, rollback and final range, :767-787), the pool-overflow and deep
// flags (:558-574) and the scatter back into the cells (:789-806).  It is
// not a pl.pallas_call (XLA compiles that loop).  The caller keeps the
// prefix count of the active cells (cum_act, a cumsum) as a plain op: a
// pool slot's cell is the slot-th active one, which a warp finds in
// cum_act but could not count itself without waiting on other blocks.
//
// Two kinds of warp, one grid:
//   - a lane warp per pool slot k (blocks [0, ceil(P / WARPS))): its cell
//     is the first c with cum_act[c] > k, found by a 129-ary search over
//     cum_act (three steps at 2 x 2048 x 64 cells); slots at or past the
//     count of active cells are empty and leave.  Then the lane's setup
//     (table, unit, offset, key weight, list base, bucket [lo0, hi0),
//     depth D = clip(len - poff - kw, 0, dqmax), the query's class words),
//     the search, the window, the stop depth, and its cell's (l, s, e);
//   - a fill warp per unit (the blocks after): every cell of the unit that
//     no lane holds gets its inputs (KEY_WEIGHT or KEY_WEIGHT_THREE, s, e),
//     and ext_fb[unit] is whether any of its active cells spilled from the
//     pool or is a pooled lane longer than the sort depth.
// Every cell is written exactly once, no block waits on another, and every
// value is an integer: the output equals seed_extend_plain exactly.
//
// Bound on the H100: a lane's latency, beside the fill's bytes.  The fill
// moves ~48 bytes a cell (12.9 MB at 2048 units of 64 offsets, ~3.9 us at
// 3.35 TB/s) and ends in ~3.5-4 us on the card, while the longest lane
// still runs.  A lane's work is tiny, but one warp carries it alone, so
// its time is the chain of its dependent steps: a gather into index_all,
// the genome words that entry names, and the integer work between them,
// every instruction of which waits on the one before (on the card,
// globaltimer stamps of the longest 1 Gb lane: ~0.8 us the slot search's
// step, ~2 us the search's round, ~3 us the window).  So the lane warp
// keeps that chain short:
//   - look-ahead: a round probes trip t's (ways - 1) positions of each
//     bound and, beside them, the positions of trips t + 1 ... t + d - 1
//     for every sub-interval that the earlier trips can leave when their
//     compares are monotone: ways^d - 1 probes a bound, with d the
//     largest depth at which both bounds fit a warp (ways 4: d = 2, 30
//     probes; ways 2: d = 4; ways 8: d = 1).  A trip whose compares are
//     monotone leaves exactly one of those sub-intervals; one whose
//     compares are not (a bucket that is not sorted in the compare: IUPAC
//     genomes, three-letter keys taken mod 3^16) leaves its new a above
//     its new b (a false probe before a true one bounds b below a), so
//     that bound is closed and every later trip of it is a no-op, as in
//     the plain version's a < b guards.  Either way the bounds after every
//     trip are the plain version's, with the probe positions unchanged;
//   - the search runs in 32-bit offsets from the bucket's start, a / ways
//     as a multiply and a shift, and every thread decodes a round's
//     ballot itself: no 64-bit division (a ~170-cycle call), no shuffle
//     reduction and no branch in a round's arithmetic;
//   - a compare issues its index_all load, then all of the D / 8 + 1
//     genome words it needs at once, as 16-byte loads (a divergent load
//     costs the L1 a lookup a thread, whatever its width), and tests them
//     LEX class words at a time: two loads deep, whatever depth it
//     matches to;
//   - the window's 2 ext_w positions, 9 a thread at ext_w = 129, go PB at
//     a time: their list entries, then their genome words, then a class
//     word of every position at a time until each has differed (PB = 3
//     at lmax 128: more rows at once spill registers or lengthen the
//     compare, both measured slower);
//   - the stop depth is a binary search over the LCP's value range with
//     one __reduce_add_sync a step over the window's LCPs in shared
//     memory; the query's class words are built there once, a word a
//     thread, and then held in every thread's registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;  // warps a block, lane or fill
constexpr int BIGI = 0x3FFFFFFF;
constexpr int MAX_DEPTH = 4;  // trips a round at most (ways 2)
constexpr int SEARCH = 128;   // cum_act positions a step of the slot search
constexpr int FILL = 4;       // cells a fill thread loads at once
constexpr int LEX = 4;        // class words a probe's compare tests at once

struct Args {
  const uint32_t* genome;
  int64_t n_gw;
  const int64_t* index_all;
  int64_t n_idx;
  const uint8_t* pnib;
  int W;
  const int64_t* lens;
  const uint8_t* is_ga;
  const int64_t* base3;
  const int64_t* s2;
  const int64_t* e2;
  const int64_t* s3;
  const int64_t* e3;
  const uint8_t* flat_act;
  const int64_t* cum_act;
  int B, o_spec, P, dqmax, qw, kw2, kw3, mc, ways, kary_iters, ext_w,
      n_sort;
  uint32_t ways_m;  // a / ways = (a ways_m) >> ways_sh (Ways)
  int ways_sh;
  int64_t* cells;  // (6, B, o_spec): l2, s2x, e2x, l3, s3x, e3x
  uint8_t* ext_fb;
};

struct Lane {
  const uint32_t* genome;
  int64_t n_gw;
  const int64_t* index_all;
  int64_t n_idx;
  int64_t idx_b;  // the lane's list in index_all
  int kw, D;
  bool t3, vec;  // vec: the genome starts on 16 bytes
  unsigned sa, sb;  // the three-letter classes' bits: 3 and 1 (G->A), or 2, 0
};

__device__ __forceinline__ int64_t imax64(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The search's arithmetic, in 32-bit offsets from the bucket's start (the
// JAX core carries it in int32, pipeline.py:709-716: a bucket holds fewer
// than 2^31 entries).  a / ways is a multiply and a shift for every ways
// (Granlund and Montgomery: m = ceil(2^(31 + l) / ways), l = ceil(log2
// ways), exact for 0 <= a < 2^31), so that no branch or division call
// sits in the chain of a round's decode.
struct Ways {
  int n;
  uint32_t m;
  int sh;  // 31 + l
  __device__ __forceinline__ int div(int a) const {
    return static_cast<int>((static_cast<uint64_t>(a) * m) >> sh);
  }
  __device__ __forceinline__ int mod(int a) const { return a - div(a) * n; }
  // probe k of [a, b), a < b: a + k (w / ways) + (k (w % ways)) / ways
  __device__ __forceinline__ int probe(int a, int b, int k) const {
    const int w = b - a;
    return a + k * div(w) + div(k * mod(w));
  }
  // the sub-interval s of [a, b) that a monotone trip leaves
  __device__ __forceinline__ void child(int& a, int& b, int s) const {
    const int lo = s == 0 ? a : probe(a, b, s) + 1;
    const int hi = s == n - 1 ? b : probe(a, b, s + 1);
    a = lo;
    b = hi;
  }
};

// Trips a round: the largest d <= MAX_DEPTH with 2 (ways^d - 1) <= 32
// probes, or 1.
__device__ int lookahead(int ways) {
  int d = 1, p = ways;
  while (d < MAX_DEPTH && 2 * (p * ways - 1) <= 32) {
    p *= ways;
    ++d;
  }
  return d;
}

// Probe q of a round: its bound (0 lower, 1 upper), its k (1-based), and
// its trip's place in the look-ahead tree, level lvl and the sub-intervals
// dig[0 .. lvl) that lead there.  The same every round.
struct Probe {
  bool on;
  int bd, k, lvl;
  int dig[MAX_DEPTH - 1];
};

__device__ Probe probe_of(int q, int per_bound, int ways) {
  const int nprb = ways - 1;
  Probe p;
  p.on = q < 2 * per_bound;
  p.bd = q >= per_bound;
  const int r = q - p.bd * per_bound;
  int node = r / nprb;
  p.k = r % nprb + 1;
  int width = 1;
  p.lvl = 0;
  while (node >= width) {
    node -= width;
    width *= ways;
    ++p.lvl;
  }
#pragma unroll
  for (int l = 0; l < MAX_DEPTH - 1; ++l) {
    p.dig[l] = 0;
    if (l < p.lvl) {
      width /= ways;
      p.dig[l] = node / width;
      node %= width;
    }
  }
  return p;
}

// The u32 genome word i; words past the end read 0 (genome_words).  The
// load's address is clamped, not branched around.
__device__ __forceinline__ uint32_t gword(const uint32_t* __restrict__ g,
                                          int64_t n_gw, int64_t i) {
  const uint32_t v = __ldg(g + (i < 0 ? 0 : (i < n_gw ? i : n_gw - 1)));
  return i < n_gw ? v : 0u;
}

// Eight nibbles (a genome word run or a query word) to their class
// nibbles: two-letter 1 - (b0 | b2); three-letter 2 hi + (lo & ~hi), hi
// and lo the bits sa and sb (3 and 1 for G->A, else 2 and 0), lo | hi.
// Both are computed and one is kept: no branch in a compare's word loop.
__device__ __forceinline__ uint32_t class_word(uint32_t wal, const Lane& L) {
  const uint32_t m1 = 0x11111111u;
  const uint32_t c2 = ((wal | (wal >> 2)) & m1) ^ m1;
  const uint32_t hi3 = (wal >> L.sa) & m1;
  const uint32_t lo3 = ((wal >> L.sb) & m1) | hi3;
  const uint32_t c3 = (hi3 << 1) | (lo3 & ~hi3);
  return L.t3 ? c3 : c2;
}

// The nibbles of class word j that lie within depth D.
__device__ __forceinline__ uint32_t depth_mask(int D, int j) {
  const int nrem = D - 8 * j;
  return nrem >= 8 ? FULL : (1u << (4 * nrem)) - 1u;
}

// The genome position a list entry names: index_all[clamp(idx)] + kw.
__device__ __forceinline__ int64_t entry(const Lane& L, int64_t idx) {
  idx = idx < 0 ? 0 : (idx >= L.n_idx ? L.n_idx - 1 : idx);
  return L.index_all[idx] + L.kw;
}

// The NW words from genome position g0's word on (a compare reads at most
// D / 8 + 1 <= NW of them), all loads issued before any is tested.
template <int NW>
__device__ __forceinline__ void load_words(const Lane& L, int64_t g0,
                                           uint32_t (&w)[NW]) {
  const int64_t w0 = g0 >> 3;
  // 16-byte loads from the word row's aligned start: a divergent load
  // costs the L1 a lookup a thread, whatever its width
  constexpr int NV = (NW + 3) / 4 + 1;
  const int64_t a0 = w0 & ~int64_t{3};
  if (L.vec && a0 >= 0 && a0 + 4 * NV <= L.n_gw) {
    uint32_t f[4 * NV];
    const uint4* const p = reinterpret_cast<const uint4*>(L.genome + a0);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const uint4 x = __ldg(p + v);
      f[4 * v] = x.x;
      f[4 * v + 1] = x.y;
      f[4 * v + 2] = x.z;
      f[4 * v + 3] = x.w;
    }
    const int o = static_cast<int>(w0 & 3);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      w[j] = o == 0 ? f[j]
                    : (o == 1 ? f[j + 1] : (o == 2 ? f[j + 2] : f[j + 3]));
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = gword(L.genome, L.n_gw, w0 + j);
  }
}

// cmp of the class string at list entry idx against the query's class
// words q, to depth D (lex): -1 below, 0 equal, 1 above.
template <int NW>
__device__ __forceinline__ int compare_at(const Lane& L,
                                          const uint32_t (&q)[NW],
                                          int64_t idx) {
  const int64_t g0 = entry(L, idx);
  uint32_t w[NW];
  load_words<NW>(L, g0, w);
  const unsigned sh = static_cast<unsigned>(g0 & 7) * 4u;
  const int jl = (L.D - 1) >> 3;  // the last class word within depth D
  const uint32_t tail = depth_mask(L.D, jl);
  // LEX class words at a time, each group's words independent of one
  // another, and a test for a difference after each group
#pragma unroll
  for (int j0 = 0; j0 + 1 < NW; j0 += LEX) {
    if (j0 > jl) break;
    int first = -1;
    uint32_t fg = 0, fd = 0, fq = 0;
#pragma unroll
    for (int j = j0 + LEX - 1; j >= j0; --j) {
      if (j + 1 >= NW) continue;
      const uint32_t g = class_word(__funnelshift_r(w[j], w[j + 1], sh), L);
      const uint32_t diff =
          (g ^ q[j]) & (j < jl ? FULL : (j == jl ? tail : 0u));
      if (diff) {
        first = j;
        fg = g;
        fd = diff;
        fq = q[j];
      }
    }
    if (first >= 0) {
      const int nib = (__ffs(fd) - 1) >> 2;
      return ((fg >> (4 * nib)) & 0xFu) < ((fq >> (4 * nib)) & 0xFu) ? -1
                                                                     : 1;
    }
  }
  return 0;
}

// (ff, lt) of the probes [lo, lo + n) of a round, merged with those of
// the chunk of 32 probes from q0 whose compares ballot m holds: the first
// k (1-based) whose probe is not below the query, and the last that is.
__device__ __forceinline__ void merge_group(unsigned m, int q0, int lo,
                                            int n, int& ff, int& lt) {
  const int s = max(lo, q0), e = min(lo + n, q0 + 32);
  if (s >= e) return;
  const int len = e - s;
  const unsigned lenmask = len >= 32 ? FULL : (1u << len) - 1u;
  const unsigned bits = (m >> (s - q0)) & lenmask;
  const int k0 = s - lo;
  if (bits) lt = max(lt, k0 + 32 - __clz(bits));
  const unsigned nb = ~bits & lenmask;
  if (nb) ff = min(ff, k0 + __ffs(nb));
}

// The k-ary search of one lane over its bucket's offsets [0, w0): (Lb,
// Ub), the plain version's aL and aU after kary_iters trips, as offsets.
// A trip moves a bound [a, b) to (p_lt + 1, p_ff) with lt its last probe
// below the query (or a) and ff its first other (or b); monotone
// compares leave sub-interval lt, others close the bound (a > b).
template <int NW>
__device__ void kary_search(const Lane& L, const uint32_t (&qr)[NW],
                            const Ways& wy, int kary_iters, int64_t base,
                            int w0, int& Lb, int& Ub) {
  const int t = threadIdx.x & 31;
  const int nprb = wy.n - 1;
  const int depth = lookahead(wy.n);
  int per_bound = 1;  // ways^depth - 1 probes a bound
  for (int d = 0; d < depth; ++d) per_bound *= wy.n;
  per_bound -= 1;
  const int nprobes = 2 * per_bound;
  const Probe mine = probe_of(t, per_bound, wy.n);
  int aL = 0, bL = w0, aU = 0, bU = w0;
  for (int it = 0; it < kary_iters; it += depth) {
    if (aL >= bL && aU >= bU) break;  // every later trip is a no-op
    const int levels = min(depth, kary_iters - it);
    int ff[2] = {wy.n, wy.n}, lt[2] = {0, 0};  // trip it, by bound
    unsigned m0 = 0;
    for (int q0 = 0; q0 < nprobes; q0 += 32) {
      const Probe pr = q0 ? probe_of(q0 + t, per_bound, wy.n) : mine;
      bool g = false;
      if (pr.on && pr.lvl < levels) {
        int a = pr.bd ? aU : aL, b = pr.bd ? bU : bL;
        // the trip's interval: the sub-intervals of the monotone trips
        // that lead to it
#pragma unroll
        for (int l = 0; l < MAX_DEPTH - 1; ++l)
          if (l < pr.lvl && a < b) wy.child(a, b, pr.dig[l]);
        if (a < b) {
          const int cmp = compare_at<NW>(L, qr, base + wy.probe(a, b, pr.k));
          g = pr.bd ? cmp <= 0 : cmp < 0;
        }
      }
      const unsigned m = __ballot_sync(FULL, g);
      if (q0 == 0) m0 = m;
      merge_group(m, q0, 0, nprb, ff[0], lt[0]);
      merge_group(m, q0, per_bound, nprb, ff[1], lt[1]);
    }
    // every thread moves both bounds through the round's trips
#pragma unroll
    for (int bd = 0; bd < 2; ++bd) {
      int a = bd ? aU : aL, b = bd ? bU : bL;
      int node = 0;
      for (int l = 0; l < levels && a < b; ++l) {
        int f = ff[bd], s = lt[bd];
        if (l) {  // depth > 1: the round's probes are one chunk
          const unsigned bits =
              (m0 >> (bd * per_bound + node * nprb)) & ((1u << nprb) - 1u);
          s = bits ? 32 - __clz(bits) : 0;
          f = __ffs(~bits);
        }
        const int na = s ? wy.probe(a, b, s) + 1 : a;
        const int nb = f < wy.n ? wy.probe(a, b, f) : b;
        a = na;
        b = nb;
        node = node * wy.n + 1 + s;
      }
      if (bd) {
        aU = a;
        bU = b;
      } else {
        aL = a;
        bL = b;
      }
    }
  }
  Lb = aL;
  Ub = aU;
}

// The LCPs of the window positions i = t + 32 (m0 + j), j < PB, into lcps:
// all index loads, then all genome words, then the compares, a class word
// of every position at a time until each has differed.
template <int NW, int PB>
__device__ void window_batch(const Lane& L, const uint32_t (&q)[NW], int m0,
                             int n_w, int ext_w, int64_t Lb, int64_t Ub,
                             int64_t lo0, int64_t hi0, int* lcps) {
  const int t = threadIdx.x & 31;
  int64_t g0[PB];
  bool open[PB];
  int lcp[PB];
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    const int i = t + 32 * (m0 + j);
    const int64_t wofs = i < ext_w ? Lb - 1 - i : Ub + (i - ext_w);
    open[j] = i < n_w && wofs >= lo0 && wofs < hi0;
    g0[j] = open[j] ? entry(L, L.idx_b + wofs) : 0;
    lcp[j] = open[j] ? L.D : -1;
  }
  uint32_t w[PB][NW];
#pragma unroll
  for (int j = 0; j < PB; ++j) load_words<NW>(L, g0[j], w[j]);
  const int kl = (L.D - 1) >> 3;  // the last class word within depth D
  const uint32_t tail = depth_mask(L.D, kl);
#pragma unroll
  for (int k = 0; k + 1 < NW; ++k) {
    if (k > kl) break;
    const uint32_t mask = k < kl ? FULL : tail;
    bool any = false;
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      const unsigned sh = static_cast<unsigned>(g0[j] & 7) * 4u;
      const uint32_t g =
          class_word(__funnelshift_r(w[j][k], w[j][k + 1], sh), L);
      const uint32_t diff = (g ^ q[k]) & mask;
      if (open[j] && diff) {
        lcp[j] = 8 * k + ((__ffs(diff) - 1) >> 2);
        open[j] = false;
      }
      any |= open[j];
    }
    if (!any) break;
  }
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    const int i = t + 32 * (m0 + j);
    if (i < n_w) lcps[i] = lcp[j];
  }
}

// A pool slot: its cell, the search, the window, the stop depth, the cell.
template <int NW>
__device__ void lane_warp(const Args& A, int slot, uint32_t* qs, int* lcps) {
  const int t = threadIdx.x & 31;
  const int64_t n_lanes = static_cast<int64_t>(A.B) * A.o_spec;
  const int n_cells = static_cast<int>(2 * n_lanes);

  // --- the slot's cell: the first c with cum_act[c] >= slot + 1, by a
  // (SEARCH + 1)-ary search; the count of active cells comes with its
  // first step
  const int64_t want = slot + 1;
  const int64_t total = A.cum_act[n_cells - 1];
  int lo = -1, hi = n_cells - 1;  // the cell is in (lo, hi]
  while (hi - lo > 1) {
    const int span = hi - lo;
    const bool last = span - 1 <= SEARCH;  // probe every position left
    // probe i at lo + floor(i span / (SEARCH + 1)), 1 <= i <= SEARCH; the
    // probes are in order and cum_act never falls, so the first f - 1 of
    // them are below the slot's count and probe f is the first at or past
    // its cell
    const int st = span / (SEARCH + 1), sr = span % (SEARCH + 1);
    int below = 0;
#pragma unroll
    for (int j = 0; j < SEARCH / 32; ++j) {
      const int i = t + 32 * j + 1;
      const int q = last ? lo + i : lo + i * st + i * sr / (SEARCH + 1);
      below += q < hi && A.cum_act[q] < want;
    }
    const int f = __reduce_add_sync(FULL, below) + 1;
    if (want > total) return;  // an empty slot: no cell
    if (last) {
      if (f <= SEARCH && lo + f < hi) hi = lo + f;
      break;
    }
    const int qf = lo + f * st + f * sr / (SEARCH + 1);
    const int qp = lo + (f - 1) * st + (f - 1) * sr / (SEARCH + 1);
    if (f <= SEARCH) hi = qf;
    if (f > 1) lo = qp;
  }
  if (want > total) return;
  const int64_t c = hi;

  // --- setup
  const bool t3 = c >= n_lanes;
  const int64_t rem = c - (t3 ? n_lanes : 0);
  const int64_t pb = rem / A.o_spec;
  const int poff = static_cast<int>(rem % A.o_spec);
  Lane L;
  L.genome = A.genome;
  L.n_gw = A.n_gw;
  L.index_all = A.index_all;
  L.n_idx = A.n_idx;
  L.t3 = t3;
  L.vec = (reinterpret_cast<uintptr_t>(A.genome) & 15) == 0;
  L.kw = t3 ? A.kw3 : A.kw2;
  const bool ga = t3 && A.is_ga[pb] != 0;
  L.sa = ga ? 3 : 2;
  L.sb = ga ? 1 : 0;
  L.idx_b = t3 ? A.base3[pb] : 0;
  const int64_t lo0 = t3 ? A.s3[rem] : A.s2[rem];
  const int64_t hi0 = t3 ? A.e3[rem] : A.e2[rem];
  const int64_t rl = A.lens[pb] - poff;
  L.D = static_cast<int>(imin64(imax64(rl - L.kw, 0), A.dqmax));

  // the query's class words, nibbles from offset poff + kw (0 past the
  // unit's row), built a word a thread and then held by every thread
  const int stride = 2 * A.W;
  const uint8_t* row = A.pnib + pb * A.W;
  for (int w = t; w < A.qw; w += 32) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int jx = poff + L.kw + 8 * w + k;
      const uint32_t nib =
          jx < stride ? (row[jx >> 1] >> (4 * (jx & 1))) & 0xFu : 0u;
      word |= nib << (4 * k);
    }
    qs[w] = class_word(word, L);
  }
  __syncwarp();
  uint32_t qr[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) qr[j] = j < A.qw ? qs[j] : 0u;

  // --- the k-ary lower / upper-bound search, in offsets from lo0
  const Ways wy{A.ways, A.ways_m, A.ways_sh};
  int lb, ub;
  kary_search<NW>(L, qr, wy, A.kary_iters, L.idx_b + lo0,
                  static_cast<int>(hi0 - lo0), lb, ub);
  const int64_t Lb = lo0 + lb, Ub = lo0 + ub;

  // --- the LCP window: ext_w positions on each side of [Lb, Ub)
  const int ext_w = A.ext_w, n_w = 2 * ext_w;
  constexpr int PB = NW <= 15 ? 3 : (NW <= 31 ? 2 : 1);
  for (int m0 = 0; 32 * m0 < n_w; m0 += PB)
    window_batch<NW, PB>(L, qr, m0, n_w, ext_w, Lb, Ub, lo0, hi0, lcps);
  __syncwarp();

  // --- stop depth, rollback and final range
  const int mc = A.mc;
  const int64_t c0 = Ub - Lb;
  int kth = 0;
  if (c0 <= mc) {
    // the j-th largest LCP, j = min(mc - c0, mc) (c0 < 0 where a bucket is
    // not sorted): the largest v in [-1, dqmax] with count(lcp >= v) >=
    // j + 1 (count(lcp >= -1) is n_w > mc >= j)
    const int need = static_cast<int>(imin64(mc - c0, mc)) + 1;
    int lo_v = -1, hi_v = A.dqmax + 1;
    while (hi_v - lo_v > 1) {
      const int mid = (lo_v + hi_v) >> 1;
      int n = 0;
      for (int i = t; i < n_w; i += 32) n += lcps[i] >= mid;
      if (__reduce_add_sync(FULL, n) >= need) lo_v = mid;
      else hi_v = mid;
    }
    kth = lo_v;
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
    int64_t* const cell = A.cells + (t3 ? 3 : 0) * n_lanes + rem;
    cell[0] = L.kw + t_use;
    cell[n_lanes] = fullr ? lo0 : Lb - (n & 0xFFFF);
    cell[2 * n_lanes] = fullr ? hi0 : Ub + (n >> 16);
  }
}

// A unit's cells that no lane holds, and its ext_fb.
__device__ void fill_warp(const Args& A, int64_t u) {
  const int t = threadIdx.x & 31;
  const int o_spec = A.o_spec;
  const int64_t n_lanes = static_cast<int64_t>(A.B) * o_spec;
  const int64_t len = A.lens[u];
  bool flag = false;
  for (int x0 = 0; x0 < 2 * o_spec; x0 += 32 * FILL) {
    bool act[FILL], ok[FILL];
    int64_t cum[FILL], s[FILL], e[FILL];
#pragma unroll
    for (int j = 0; j < FILL; ++j) {
      const int x = x0 + t + 32 * j;
      ok[j] = x < 2 * o_spec;
      const bool t3 = x >= o_spec;
      const int64_t rem = u * o_spec + (t3 ? x - o_spec : x);
      const int64_t c = (t3 ? n_lanes : 0) + rem;
      act[j] = ok[j] && A.flat_act[c] != 0;
      cum[j] = ok[j] ? A.cum_act[c] : 0;
      s[j] = ok[j] ? (t3 ? A.s3 : A.s2)[rem] : 0;
      e[j] = ok[j] ? (t3 ? A.e3 : A.e2)[rem] : 0;
    }
#pragma unroll
    for (int j = 0; j < FILL; ++j) {
      if (!ok[j]) continue;
      const int x = x0 + t + 32 * j;
      const bool t3 = x >= o_spec;
      const int off = t3 ? x - o_spec : x;
      const bool pooled = act[j] && cum[j] <= A.P;
      // a spilled lane, or a pooled one that reaches past the sort depth
      flag |= act[j] && (!pooled || len - off > A.n_sort);
      if (pooled) continue;  // its lane writes it
      int64_t* const cell = A.cells + (t3 ? 3 : 0) * n_lanes + u * o_spec
                            + off;
      cell[0] = t3 ? A.kw3 : A.kw2;
      cell[n_lanes] = s[j];
      cell[2 * n_lanes] = e[j];
    }
  }
  const bool fb = __any_sync(FULL, flag);
  if (t == 0) A.ext_fb[u] = fb;
}

template <int NW>
__global__ void seed_extend_kernel(Args A) {
  extern __shared__ uint32_t smem[];
  const int wb = threadIdx.x >> 5;
  const int lane_blocks = (A.P + WARPS - 1) / WARPS;
  if (static_cast<int>(blockIdx.x) >= lane_blocks) {
    const int64_t u =
        static_cast<int64_t>(blockIdx.x - lane_blocks) * WARPS + wb;
    if (u < A.B) fill_warp(A, u);
    return;
  }
  const int slot = blockIdx.x * WARPS + wb;
  if (slot >= A.P) return;  // the whole warp
  uint32_t* const qs = smem + wb * (A.qw + 2 * A.ext_w);
  lane_warp<NW>(A, slot, qs, reinterpret_cast<int*>(qs + A.qw));
}

}  // namespace

extern "C" int seed_extend_launch(
    const void* genome32, int64_t n_gw, const void* index_all, int64_t n_idx,
    const void* pnib, int W, const void* lens, const void* is_ga,
    const void* base3, const void* s2, const void* e2, const void* s3,
    const void* e3, const void* flat_act, const void* cum_act, int B,
    int o_spec, int P, int dqmax, int qw, int kw2, int kw3, int mc, int ways,
    int kary_iters, int ext_w, int n_sort, void* cells, void* ext_fb,
    void* stream) {
  if (ways < 2 || 2 * ext_w >= 1 << 16 || mc + 1 > 2 * ext_w || P < 0 ||
      B <= 0 || o_spec <= 0 || qw + 1 > 63 ||
      2 * static_cast<int64_t>(B) * o_spec >= int64_t{1} << 31)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.genome = static_cast<const uint32_t*>(genome32);
  a.n_gw = n_gw;
  a.index_all = static_cast<const int64_t*>(index_all);
  a.n_idx = n_idx;
  a.pnib = static_cast<const uint8_t*>(pnib);
  a.W = W;
  a.lens = static_cast<const int64_t*>(lens);
  a.is_ga = static_cast<const uint8_t*>(is_ga);
  a.base3 = static_cast<const int64_t*>(base3);
  a.s2 = static_cast<const int64_t*>(s2);
  a.e2 = static_cast<const int64_t*>(e2);
  a.s3 = static_cast<const int64_t*>(s3);
  a.e3 = static_cast<const int64_t*>(e3);
  a.flat_act = static_cast<const uint8_t*>(flat_act);
  a.cum_act = static_cast<const int64_t*>(cum_act);
  a.B = B;
  a.o_spec = o_spec;
  a.P = P;
  a.dqmax = dqmax;
  a.qw = qw;
  a.kw2 = kw2;
  a.kw3 = kw3;
  a.mc = mc;
  a.ways = ways;
  int l = 0;
  while ((1 << l) < ways) ++l;
  a.ways_sh = 31 + l;
  a.ways_m = static_cast<uint32_t>(((uint64_t{1} << (31 + l)) + ways - 1) /
                                   ways);
  a.kary_iters = kary_iters;
  a.ext_w = ext_w;
  a.n_sort = n_sort;
  a.cells = static_cast<int64_t*>(cells);
  a.ext_fb = static_cast<uint8_t*>(ext_fb);
  // the compare's word rows: qw class words and the word past them
  void (*kern)(Args) = seed_extend_kernel<63>;
  if (qw + 1 <= 15) kern = seed_extend_kernel<15>;
  else if (qw + 1 <= 31) kern = seed_extend_kernel<31>;
  const int blocks = (P + WARPS - 1) / WARPS + (B + WARPS - 1) / WARPS;
  const size_t smem = sizeof(uint32_t) * WARPS * (qw + 2 * ext_w);
  kern<<<blocks, 32 * WARPS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
