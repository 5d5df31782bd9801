// K2 and K3: banded local-alignment score and traceback.
//
// K2 (banded_score_packed_launch) replaces abismal_tpu/kernels/
// banded_align.py:_kernel_body (the Pallas scorer called at
// abismal_tpu/map/pipeline.py:1482) together with the operand gathers in
// front of it there and in banded_align.py:build_device_align (:358): it
// reads packed query rows and the packed genome itself.
// K3 (banded_trace_launch, banded_trace_packed_launch) replaces
// banded_align.py:_tracer_body together with the arrow walk of
// pipeline.py:build_tb_block (:1080-1160), fused.
//
// The recurrence is AbismalAlign::align in the JAX package's row
// parametrization: table row i is walked as rr = i - bw + QOFF, band column
// c in [0, BAND), query nibble q[rr + c - QOFF], window nibble win[rr].
// Per row: left = max(QOFF - rr, 0), right = min(bw, qsz + QOFF - rr),
// cells c in [left, right) are live, every other cell stores 0.
//   x(c)      = max(0, prev(c) + sub(c))                 (+2 / -3)
//   x(c)      = max(x(c), prev(c + 1) - 4)  if c < right - 1   (deletion)
//   stored(c) = max_{left <= k <= c} x(k) - 4 (c - k)         (insertion)
// The scorer returns the largest stored cell.  The tracer also keeps, per
// cell, a nibble (arrow | score > 0 << 2) with arrows in the overwrite
// order M < D < I (M = 0, I = 1, D = 2, none = 3) and the row-major-first
// argmax cell, then walks the arrows from that cell emitting run-length
// cigar ops (run << 4 | arrow) in walk order.
//
// K2 on the H100 is bound by instruction issue: a job is a serial loop of
// rows, each a short chain of integer ops and shuffles, and the bytes per
// job (its query, window and two ints) are a few hundred.  So the design
// spends lanes and instructions only where the band has cells:
//   - a warp takes 4 consecutive jobs.  Jobs with bands up to 32 columns
//     run together, each on a group of 8 lanes holding 2, 3 or 4 columns a
//     lane (picked from the widest such band in the warp), so the
//     insertion chain is a 3-step scan; wider bands (up to 61) run one at
//     a time on all 32 lanes, 2 columns a lane;
//   - the warp stages its jobs' queries and windows once in shared memory,
//     zero-padded, so a row reads one new query nibble and one window
//     nibble per lane with no bounds test (the next row's are fetched
//     while this row computes);
//   - cells are kept as stored(c) + 4 c, which turns the insertion chain
//     into a plain prefix maximum and the deletion into a constant -8, and
//     drops the per-row conversions; add-then-max is one DPX instruction
//     (__viaddmax_s32); all arithmetic stays exact int32;
//   - between the first row with the whole band live and the last one
//     (QOFF <= rr <= qsz + QOFF - bw for every job of the pass) a row
//     tests no cell against the row's range: the live range is the
//     constant c < bw there;
//   - rows no job of the pass can reach are skipped; a negative band, or a
//     fill row (bw 1, qsz 0), has no live cell: it scores 0 and is neither
//     staged nor run;
//   - the warp unpacks each live job's query row (two nibbles a byte) and
//     genome window (eight nibbles a word, a funnel shift for the nibble
//     offset) into the staged rows with 32-bit stores, so the caller
//     builds no operand.
//
// K3 on the H100 is bound by one warp's latency: a chunk traces about a
// thousand winners, which is under one wave of warps whatever the layout,
// so its time is the longest job's serial chain, and a lone warp issues an
// integer instruction every second cycle at best.  The design shortens
// the chain and the instructions on it:
//   - a warp takes 2 consecutive jobs, each on a group of 16 lanes; a lane
//     holds one pair of columns (bands up to 32 in the warp) or two (up to
//     61), so no lane group changes with the band;
//   - the table runs by anti-diagonals, not by rows: column pair v is one
//     row behind pair v - 1, and a loop trip computes every pair's even
//     column, then every odd one.  The three neighbours of a cell are then
//     half a trip old at most and sit in the lane's own registers or one
//     shuffle away, so the insertion is the plain recurrence stored(c) =
//     max(x(c), stored(c - 1) - 4) and needs no prefix scan.  A trip's
//     chain is two shuffles, each followed by one add-and-max
//     (__viaddmax_s32) and one select; everything else hangs beside it;
//   - rows are staged zero-padded in shared memory as in K2, by the job's
//     own group, the window also 32 rows before row 0 and after the last
//     for the pairs that run behind; banded_trace_packed stages them
//     itself from the packed query row pnib[unit] (two nibbles a byte) and
//     from the packed genome at win_start(pos, bw) & 0xFFFFFFFF (eight
//     nibbles a word, 0 past the end), so the caller builds no operand;
//   - a dead neighbour stores 0, so a deletion or insertion from it is -4
//     and never wins: only the row's own live range is tested, and between
//     the first row with the whole band live and the last one (for every
//     pair of every job of the warp) not even that;
//   - the arrows read off as: D  del >= x1 (and c < right - 1); I  ins >=
//     max(x1, del), which is stored == left + INDEL; M otherwise, as a
//     positive cell without D or I has diag > 0.  A cell keeps two bits:
//     0 not positive, 1 I, 2 D, 3 M.  A lane collects them in registers,
//     one bit a trip, and writes two words a column to shared memory
//     every 32 trips: nothing is zeroed, bit 0 of the first word is the
//     row before the first;
//   - the argmax is deferred: every lane keeps the maximum of value << 16
//     | 65535 - (row * 64 + column) over its cells, and one reduction
//     after the last trip gives the largest value, then the lowest row,
//     then the lowest column: the row-major-first cell;
//   - the two leaders walk at once.  A walk starts on a live cell and
//     moves to (row - 1, c), to (row, c - 1) only from a cell with a live
//     left neighbour, or to (row - 1, c + 1) only below the row's last
//     live cell, so it reads written bits and needs no range test; code 0
//     stops it, as fetch's out-of-range 0 does in the plain version.  The
//     rows of one column are consecutive bits, so a run of M arrows is one
//     count of leading ones, not a step a row.  The ops go to shared
//     memory; the warp then writes its 48 op words and 8 meta words in one
//     coalesced pass.  A warp none of whose jobs has a live cell (untraced
//     lanes carry bw 1, qsz 0) writes its rows and leaves before staging.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QOFF = 60;
constexpr int BAND = 64;
constexpr int MATCH = 2;
constexpr int MISMATCH = -3;
constexpr int INDEL = -4;
constexpr int NEG = -(1 << 14);
constexpr int NOPS = 24;
constexpr unsigned FULL = 0xFFFFFFFFu;

// State of one K2 pass in a lane: CPL band columns c = CPL * l + k of its
// group's job, kept as stored(c) + 4 c.
template <int CPL>
struct BandState {
  int P[CPL];       // the previous row's cells
  int best[CPL];    // the largest cell of each column so far
  int z[CPL];       // 4 c: a stored 0
  unsigned qn[CPL];  // the row's query nibbles
  unsigned ref;      // the row's window nibble
};

// Rows [r0, r1) of a K2 pass on a group of G lanes.  EDGE rows test every
// cell against the row's live range [left, right).  Rows that are not EDGE
// must have left = 0 and right = b for the job (QOFF <= rr <= n + QOFF - b),
// or no live cell at all (b <= 0): their live range is the constant c < b,
// and the deletion needs no test, as the cell past the band's end stores 0
// and 0 - 8 never beats the floor.  All 32 lanes of the warp must call it.
template <int G, int CPL, bool EDGE>
__device__ __forceinline__ void band_rows(BandState<CPL>& st,
                                          const uint8_t* __restrict__ sq,
                                          const uint8_t* __restrict__ sw, int b,
                                          int n, int r0, int r1, int l) {
  bool inband[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) inband[k] = CPL * l + k < b;
  for (int rr = r0; rr < r1; ++rr) {
    // next row's nibbles, in flight while this row computes (both arrays
    // are padded past the last row)
    const unsigned qnext = sq[rr + CPL * l + CPL];
    const unsigned rnext = sw[rr + 1];
    const int left = max(QOFF - rr, 0);
    const int right = min(b, n + QOFF - rr);
    // prev(c + 1) of the lane's last column; past the group's last column
    // a stored 0
    int nb = __shfl_down_sync(FULL, st.P[0], 1, G);
    if (l == G - 1) nb = 4 * G * CPL;
    int m[CPL];
    bool valid[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = CPL * l + k;
      const int sub = (st.qn[k] & st.ref) ? MATCH : MISMATCH;
      int x = __viaddmax_s32(st.P[k], sub, st.z[k]);
      const int up = k + 1 < CPL ? st.P[k + 1] : nb;
      if (!EDGE || c < right - 1) x = __viaddmax_s32(up, 2 * INDEL, x);
      valid[k] = EDGE ? (c >= left && c < right) : inband[k];
      m[k] = valid[k] ? x : NEG;
    }
    // insertion chain: inclusive prefix max over the band's columns (a
    // shuffle from below the group's first lane returns the lane's own)
#pragma unroll
    for (int k = 1; k < CPL; ++k) m[k] = max(m[k], m[k - 1]);
    int s = m[CPL - 1];
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
      s = max(s, __shfl_up_sync(FULL, s, off, G));
    int before = __shfl_up_sync(FULL, s, 1, G);
    if (l == 0) before = NEG;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      st.P[k] = valid[k] ? max(m[k], before) : st.z[k];
      st.best[k] = max(st.best[k], st.P[k]);
    }
#pragma unroll
    for (int k = 0; k + 1 < CPL; ++k) st.qn[k] = st.qn[k + 1];
    st.qn[CPL - 1] = qnext;
    st.ref = rnext;
  }
}

// One pass of K2 over the rows [r0, r1) for the job of this lane's group of
// G lanes, CPL band columns per lane (G * CPL >= the job's band).  sq is
// the job's zero-padded query (sq[rr + c] = q[rr + c - QOFF]), sw its
// window rows.  b <= 0 leaves no live cell.  [s0, s1) within [r0, r1) are
// rows that are not EDGE rows for any job of the pass.  Returns the best
// score in every lane of the group.  All 32 lanes of the warp must call it.
template <int G, int CPL>
__device__ __forceinline__ int band_pass(const uint8_t* __restrict__ sq,
                                         const uint8_t* __restrict__ sw, int b,
                                         int n, int r0, int r1, int s0, int s1,
                                         int l) {
  BandState<CPL> st;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    st.z[k] = 4 * (CPL * l + k);
    st.P[k] = st.z[k];
    st.best[k] = st.z[k];
    st.qn[k] = sq[r0 + CPL * l + k];
  }
  st.ref = sw[r0];
  band_rows<G, CPL, true>(st, sq, sw, b, n, r0, s0, l);
  band_rows<G, CPL, false>(st, sq, sw, b, n, s0, s1, l);
  band_rows<G, CPL, true>(st, sq, sw, b, n, s1, r1, l);
  int out = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) out = max(out, st.best[k] - st.z[k]);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    out = max(out, __shfl_xor_sync(FULL, out, off, G));
  return out;
}

constexpr int JPW = 4;      // jobs per warp
constexpr int NARROW = 32;  // widest band that runs on a group of 8 lanes

// Shared-memory bytes of one job: the padded query, then the window rows
// (+ 4: the row loop fetches one row ahead), both rounded to words.
__host__ __device__ inline int k2_sq_bytes(int lq) {
  return (QOFF + lq + BAND + 3) & ~3;
}
__host__ __device__ inline int k2_sw_bytes(int lq) {
  return (lq + QOFF + 4 + 3) & ~3;
}

// Four nibbles (the low 16 bits of x) spread to a byte each.
__device__ __forceinline__ uint32_t spread_nibbles(uint32_t x) {
  return (x & 0xFu) | ((x & 0xF0u) << 4) | ((x & 0xF00u) << 8) |
         ((x & 0xF000u) << 12);
}

// Words k = k0, k0 + stride, ... below nwords of a staged query, unpacked
// from the packed row prow (base i in nibble i & 1 of byte i >> 1): byte
// 4 k + t holds query nibble 4 k + t - QOFF, 0 outside [0, nq).
__device__ __forceinline__ void stage_packed_query(
    uint32_t* __restrict__ sq4, int nwords, const uint8_t* __restrict__ prow,
    int nq, int k0, int stride) {
#pragma unroll 4
  for (int k = k0; k < nwords; k += stride) {
    const int i = 4 * k - QOFF;  // even
    uint32_t word = 0u;
    if (i >= 0 && i < nq) {
      const uint32_t b0 = __ldg(prow + (i >> 1));
      const uint32_t b1 = i + 2 < nq ? __ldg(prow + (i >> 1) + 1) : 0u;
      word = spread_nibbles(b0 | (b1 << 8));
      if (nq - i < 4) word &= (1u << (8 * (nq - i))) - 1u;
    }
    sq4[k] = word;
  }
}

// Words k = k0, k0 + stride, ... below nwords of staged window rows, from
// the packed genome (n_gw words, eight nibbles a word): byte 4 k + t holds
// row i = 4 k + t - skew, the genome nibble g0 + i, 0 outside [0, nw) and
// past the genome's end.
__device__ __forceinline__ void stage_packed_window(
    uint32_t* __restrict__ sw4, int nwords, int skew,
    const uint32_t* __restrict__ genome32, int64_t n_gw, int64_t g0, int nw,
    int k0, int stride) {
#pragma unroll 4
  for (int k = k0; k < nwords; k += stride) {
    const int i = 4 * k - skew;
    uint32_t word = 0u;
    if (i >= 0 && i < nw) {
      const int64_t p = g0 + i;
      const int64_t wi = p >> 3;
      const int sh = static_cast<int>(p & 7) * 4;
      const uint32_t w0 = wi < n_gw ? __ldg(genome32 + wi) : 0u;
      // four nibbles from bit sh on: the next word only above bit 16
      const uint32_t w1 =
          (sh > 16 && wi + 1 < n_gw) ? __ldg(genome32 + wi + 1) : 0u;
      word = spread_nibbles(__funnelshift_r(w0, w1, sh));
      if (nw - i < 4) word &= (1u << (8 * (nw - i))) - 1u;
    }
    sw4[k] = word;
  }
}

// The genome nibble of window row 0 of a job at band position pos with
// band b: win_start(pos, b) modulo 2^32.
__device__ __forceinline__ int64_t window_start(int64_t pos, int b) {
  return (pos + ((b - 1) >> 1) - QOFF) & 0xFFFFFFFFll;
}

// The K2 passes over a warp's staged jobs, from base (JPW jobs of sqb +
// swb bytes, query then window rows).  Group g of 8 lanes holds job g's
// band b and length n, live if it has a cell; a job that is not live has
// been written already.  All 32 lanes of the warp must call it.
__device__ __forceinline__ void score_warp(const uint8_t* base, int sqb,
                                           int swb, int lq, int b, int n,
                                           bool live, int njobs, int64_t job0,
                                           int32_t* __restrict__ out,
                                           int lane) {
  const int g = lane >> 3;
  const int l = lane & 7;
  // --- narrow pass: group g runs job g if its band fits 8 lanes
  {
    const bool on = live && b <= NARROW;
    const int bn = on ? b : 0;
    const int maxb = __reduce_max_sync(FULL, bn);
    // rows the band reaches: [QOFF - b + 1, min(lq, n) + QOFF); from QOFF
    // to n + QOFF - b the live range is the whole band
    const int r0 = __reduce_min_sync(FULL, on ? max(0, QOFF - bn + 1)
                                              : lq + QOFF);
    const int r1 = __reduce_max_sync(FULL, on ? min(lq, n) + QOFF : 0);
    const int s0 = min(max(r0, QOFF), r1);
    const int s1 = max(s0, min(r1, __reduce_min_sync(
        FULL, on ? min(lq, n) + QOFF - bn + 1 : lq + QOFF)));
    const uint8_t* sq = base + g * (sqb + swb);
    const uint8_t* sw = sq + sqb;
    int best = 0;
    if (r0 < r1) {  // uniform per warp
      if (maxb <= 16)
        best = band_pass<8, 2>(sq, sw, bn, n, r0, r1, s0, s1, l);
      else if (maxb <= 24)
        best = band_pass<8, 3>(sq, sw, bn, n, r0, r1, s0, s1, l);
      else
        best = band_pass<8, 4>(sq, sw, bn, n, r0, r1, s0, s1, l);
    }
    if (on && l == 0) out[job0 + g] = best;
  }

  // --- wide pass: a band above NARROW columns takes the whole warp
  const unsigned wide = __ballot_sync(FULL, live && b > NARROW);
  for (int s = 0; s < njobs; ++s) {
    if (!((wide >> (8 * s)) & 1u)) continue;  // uniform per warp
    const int bs = __shfl_sync(FULL, b, 8 * s);
    const int ns = __shfl_sync(FULL, n, 8 * s);
    const uint8_t* sq = base + s * (sqb + swb);
    const int r0 = max(0, QOFF - bs + 1);
    const int r1 = min(lq, ns) + QOFF;
    const int s0 = min(QOFF, r1);
    const int s1 = max(s0, r1 - bs + 1);
    const int best =
        band_pass<32, 2>(sq, sq + sqb, bs, ns, r0, r1, s0, s1, lane);
    if (lane == 0) out[job0 + s] = best;
  }
}

// K2 on the caller's packed operands (build_device_align's program, and
// the job builds of the fused programs): job j scores the query row
// pnib[unit[j]] (W bytes, base i in nibble i & 1 of byte i >> 1; its first
// lq nibbles) against the lq + QOFF genome nibbles from window_start(
// pos[j], bw[j]) of genome32 (n_gw words, 0 past the end).  Group g of 8
// lanes holds job g's band and length.  A job without a live cell (band
// <= 0, or a fill row of qsz 0) scores 0, is not staged and takes no part
// in the row ranges.  The warp stages its live jobs with 32-bit loads,
// zero-padded, then runs the passes of score_warp.
__global__ void banded_score_packed_kernel(
    const uint32_t* __restrict__ genome32, int64_t n_gw,
    const uint8_t* __restrict__ pnib, int W, int lq,
    const int64_t* __restrict__ unit, const int64_t* __restrict__ pos,
    const int64_t* __restrict__ bw, const int64_t* __restrict__ qsz,
    int32_t* __restrict__ out, int J) {
  extern __shared__ uint32_t smem[];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t job0 =
      (blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + wib) * JPW;
  if (job0 >= J) return;  // uniform per warp
  const int njobs = J - job0 < JPW ? static_cast<int>(J - job0) : JPW;
  const int sqb = k2_sq_bytes(lq);
  const int swb = k2_sw_bytes(lq);
  uint8_t* base = reinterpret_cast<uint8_t*>(smem) + wib * JPW * (sqb + swb);

  const int g = lane >> 3;
  const int l = lane & 7;
  int b = 0, n = 0;
  if (g < njobs) {
    b = static_cast<int>(bw[job0 + g]);
    n = static_cast<int>(qsz[job0 + g]);
  }
  const bool live = g < njobs && b > 0 && n > 0;
  if (g < njobs && !live && l == 0) out[job0 + g] = 0;
  const unsigned staged = __ballot_sync(FULL, live);
  if (staged == 0u) return;  // uniform per warp

  // --- the warp unpacks each live job's query row and window in turn
  const int nq = min(lq, 2 * W);
  for (int s = 0; s < njobs; ++s) {
    if (!((staged >> (8 * s)) & 1u)) continue;  // uniform per warp
    uint32_t* sq4 = reinterpret_cast<uint32_t*>(base + s * (sqb + swb));
    stage_packed_query(sq4, sqb / 4, pnib + unit[job0 + s] * W, nq, lane,
                       32);
    stage_packed_window(
        sq4 + sqb / 4, swb / 4, 0, genome32, n_gw,
        window_start(pos[job0 + s], __shfl_sync(FULL, b, 8 * s)), lq + QOFF,
        lane, 32);
  }
  __syncwarp();
  score_warp(base, sqb, swb, lq, b, n, live, njobs, job0, out, lane);
}

// ---------------------------------------------------------------- K3 ----

constexpr int TJPW = 2;    // jobs a warp
constexpr int TG = 16;     // lanes of a job's group
constexpr int SKEW = 32;   // rows the last column pair runs behind the first
constexpr int KEYROW = 32;  // row bias of the argmax key (rows from -SKEW on)

// Shared-memory bytes of one staged job: the padded query as K2's, then
// the window rows with SKEW zero rows before row 0 and after the last.
__host__ __device__ inline int k3_sw_bytes(int lq) {
  return (SKEW + lq + QOFF + SKEW + 3) & ~3;
}
__host__ __device__ inline int k3_job_bytes(int lq) {
  return k2_sq_bytes(lq) + k3_sw_bytes(lq);
}
// 32-trip words of a column's code streams: one bit a loop trip (at most
// lq + QOFF + SKEW - 1 trips, from bit 1 on) and a spare word.
__host__ __device__ inline int k3_words(int lq) {
  return (lq + QOFF + SKEW + 31) / 32 + 1;
}
// ... of one warp's panel (k3_words x 4 column slots x 32 lanes of uint2)
// and of one warp: the panel, TJPW staged jobs, TJPW ops and meta rows, a
// multiple of 16.
__host__ __device__ inline int k3_panel_bytes(int lq) {
  return k3_words(lq) * 4 * 32 * 8;
}
__host__ __device__ inline int k3_warp_bytes(int lq) {
  return (k3_panel_bytes(lq) + TJPW * k3_job_bytes(lq) +
          TJPW * (NOPS + 4) * 4 + 15) & ~15;
}
// The staged query of the warp's job g (its window rows follow it).
__device__ __forceinline__ uint8_t* k3_staged(uint8_t* base, int lq, int g) {
  return base + k3_panel_bytes(lq) + g * k3_job_bytes(lq);
}

// The arrow codes of one column over 32 loop trips, two bits a cell in two
// words: 0 the cell is not positive (a walk stops there), 1 I, 2 D, 3 M.
// A positive cell always has an arrow: its value came from the insertion,
// the deletion or a diagonal that stayed above 0.
struct ArrowBits {
  uint32_t lo, hi;
};

// One table cell.  diag_in, del_in, ins_in are the stored values of
// (row - 1, c), (row - 1, c + 1) and (row, c - 1), 0 where that cell is
// dead, so a deletion or an insertion from a dead cell (-4) never wins and
// only the live range of this row is tested: valid, and c < right - 1 for
// the deletion.  dadd and iadd are INDEL, or NEG where the deletion does
// not apply or the neighbour lies outside the group.  Of the two
// neighbours in the row's chain, the one that arrives by shuffle is
// LATE_DEL or the insertion's: the stored value is one add-and-max and one
// select behind it, and the arrows are read off beside the chain.  Arrows
// in the overwrite order M < D < I.  Sets bit `mask` of the cell's arrow
// code, folds value << 16 | key into best and returns the stored value.
template <bool LATE_DEL>
__device__ __forceinline__ int trace_cell(int diag_in, int del_in, int dadd,
                                          int ins_in, int iadd, unsigned q,
                                          unsigned ref, bool valid,
                                          uint32_t mask, ArrowBits& w, int key,
                                          int& best) {
  const int diag = diag_in + ((q & ref) ? MATCH : MISMATCH);
  const int x1 = max(diag, 0);
  const int del = del_in + dadd;
  const int ins = ins_in + iadd;
  const bool isdel = del >= x1;
  const int x = max(x1, del);
  const bool isins = ins >= x;
  const int s = valid ? (LATE_DEL ? __viaddmax_s32(del_in, dadd, max(x1, ins))
                                  : __viaddmax_s32(ins_in, iadd, x))
                      : 0;
  if (s > 0 && (isins || !isdel)) w.lo |= mask;
  if (s > 0 && !isins) w.hi |= mask;
  best = max(best, (s << 16) + key);
  return s;
}

// State of a K3 pass in a lane: C2 column pairs v = C2 l + j (columns 2 v,
// 2 v + 1), pair v one row behind pair v - 1.
template <int C2>
struct TraceState {
  int E[C2], O[C2];  // stored values of the pair's columns, last row
  unsigned qe[C2], qo[C2], ref[C2];  // their query nibbles, the row's window
  ArrowBits bits[2 * C2];            // slot 2 j + p: column 2 v + p
  int key[C2];   // argmax key of the even column's cell
  int best;      // max over cells of value << 16 | key
  uint32_t mask;  // this trip's bit
  int word;       // 32-trip words written so far
};

// Trips [h0, h1) of a K3 pass.  In a WHOLE trip every pair of every live
// job computes a row whose live range is the whole band (QOFF <= row <=
// n + QOFF - b), so a cell is live where its column is below b.  All 32
// lanes of the warp must call it.
template <int C2, bool WHOLE>
__device__ __forceinline__ void trace_trips(TraceState<C2>& st,
                                            const uint8_t* __restrict__ sq,
                                            const uint8_t* __restrict__ sw,
                                            uint2* __restrict__ panel, int b,
                                            int n, int h0, int h1, int l,
                                            int lane) {
  bool inb[C2][3];  // columns 2 v, 2 v + 1, 2 v + 2 below b
#pragma unroll
  for (int j = 0; j < C2; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k) inb[j][k] = 2 * (C2 * l + j) + k < b;
  for (int h = h0; h < h1;) {
    // up to the last trip of the range or of the streams' 32-trip words
    const int hw = min(h1, h + 33 - __ffs(st.mask));
    for (; h < hw; ++h) {
      unsigned qn[C2], rn[C2];  // the next trip's, in flight meanwhile
      bool ve[C2], ae[C2], vo[C2], ao[C2];  // live, and below the last cell
#pragma unroll
      for (int j = 0; j < C2; ++j) {
        const int v = C2 * l + j;
        qn[j] = sq[h + v + 2];
        rn[j] = sw[SKEW + h + 1 - v];
        if (WHOLE) {
          ve[j] = inb[j][0];
          ae[j] = vo[j] = inb[j][1];
          ao[j] = inb[j][2];
        } else {
          const int qr = QOFF - h + v;  // QOFF - row
          const int left = max(qr, 0);
          const int right = min(b, n + qr);
          ve[j] = 2 * v >= left && 2 * v < right;
          ae[j] = 2 * v + 1 < right;
          vo[j] = 2 * v + 1 >= left && ae[j];
          ao[j] = 2 * v + 2 < right;
        }
      }
      // even columns: the insertion comes from the pair below's odd column,
      // for the lane's first pair by shuffle (none below lane 0)
      const int up = __shfl_up_sync(FULL, st.O[C2 - 1], 1, TG);
      int En[C2];
#pragma unroll
      for (int j = 0; j < C2; ++j)
        En[j] = trace_cell<false>(
            st.E[j], st.O[j], ae[j] ? INDEL : NEG, j > 0 ? st.O[j - 1] : up,
            j > 0 || l > 0 ? INDEL : NEG, st.qe[j], st.ref[j], ve[j], st.mask,
            st.bits[2 * j], st.key[j], st.best);
      // odd columns: the deletion comes from the pair above's even column,
      // for the lane's last pair by shuffle (none above the last lane)
      const int dn = __shfl_down_sync(FULL, En[0], 1, TG);
#pragma unroll
      for (int j = 0; j < C2; ++j) {
        st.O[j] = trace_cell<true>(
            st.O[j], j + 1 < C2 ? En[j + 1] : dn,
            ao[j] && (j + 1 < C2 || l < TG - 1) ? INDEL : NEG, En[j], INDEL,
            st.qo[j], st.ref[j], vo[j], st.mask, st.bits[2 * j + 1],
            st.key[j] - 1, st.best);
        st.E[j] = En[j];
        st.qe[j] = st.qo[j];
        st.qo[j] = qn[j];
        st.ref[j] = rn[j];
        st.key[j] -= BAND;
      }
      st.mask <<= 1;
    }
    if (st.mask == 0u) {  // uniform: the words are full
#pragma unroll
      for (int s = 0; s < 2 * C2; ++s) {
        panel[(st.word * 4 + s) * 32 + lane] =
            make_uint2(st.bits[s].lo, st.bits[s].hi);
        st.bits[s] = ArrowBits{0u, 0u};
      }
      ++st.word;
      st.mask = 1u;
    }
  }
}

// The tables of the jobs of both groups, by anti-diagonals: lane l holds
// the column pairs v = C2 l + j, and in trip h pair v computes row h - v:
// first every even column, then every odd one, so a cell's three
// neighbours are one half trip back at most -- in the lane's own
// registers, or one shuffle away.  No prefix scan is needed, as the
// insertion comes from the finished left neighbour.  sq, sw are the job's
// staged rows (sw with SKEW rows before row 0); b = 0 leaves no live
// cell; [m0, m1) within the trips are WHOLE for every live job.  The trips
// h in [r0, r1 + 16 C2 - 1) write bit h - r0 + 1 of the code streams
// (word w, slot 2 j + p of column 2 v + p, lane) at panel[(w * 4 + slot)
// * 32 + lane].  Returns, in every lane of the group, value << 16 | 65535
// - ((row + KEYROW) * 64 + column) of the row-major-first largest cell, or
// less than 1 << 16 when no cell is positive.  All 32 lanes of the warp
// must call it.
template <int C2>
__device__ __forceinline__ int trace_pass(const uint8_t* __restrict__ sq,
                                          const uint8_t* __restrict__ sw,
                                          uint2* __restrict__ panel, int b,
                                          int n, int r0, int r1, int m0, int m1,
                                          int l, int lane) {
  TraceState<C2> st;
#pragma unroll
  for (int j = 0; j < C2; ++j) {
    const int v = C2 * l + j;
    st.E[j] = st.O[j] = 0;
    st.qe[j] = sq[r0 + v];
    st.qo[j] = sq[r0 + v + 1];
    st.ref[j] = sw[SKEW + r0 - v];
    st.key[j] = 65535 - ((r0 - v + KEYROW) * BAND + 2 * v);
    st.bits[2 * j] = st.bits[2 * j + 1] = ArrowBits{0u, 0u};
  }
  st.best = 0;
  st.mask = 2u;  // trip r0 is bit 1: bit 0 is the row before
  st.word = 0;
  const int h1 = r1 + TG * C2 - 1;
  m0 = min(max(m0 + TG * C2 - 1, r0), h1);
  m1 = min(max(m1, m0), h1);
  trace_trips<C2, false>(st, sq, sw, panel, b, n, r0, m0, l, lane);
  trace_trips<C2, true>(st, sq, sw, panel, b, n, m0, m1, l, lane);
  trace_trips<C2, false>(st, sq, sw, panel, b, n, m1, h1, l, lane);
#pragma unroll
  for (int s = 0; s < 2 * C2; ++s)
    panel[(st.word * 4 + s) * 32 + lane] =
        make_uint2(st.bits[s].lo, st.bits[s].hi);
  int best = st.best;
#pragma unroll
  for (int off = TG / 2; off > 0; off >>= 1)
    best = max(best, __shfl_xor_sync(FULL, best, off, TG));
  return best;
}

// The walk of one job, run by one lane: from the argmax cell in fin (below
// 1 << 16: no positive cell) along the arrows of its code streams (c2s = 0
// or 1: one or two column pairs a lane, the job's lanes from lane0 on,
// trip bit 0 at row hb of pair 0), run-length ops into so[NOPS] (zeroed
// by the caller), the four meta words into sm.  A walk starts on a live
// cell and moves to (row - 1, c), to (row, c - 1) only from a cell with a
// live left neighbour, or to (row - 1, c + 1) only below the row's last
// live cell: it reads bits the pass wrote, or bit 0, and needs no range
// test; a cell that is not positive stops it.  A run of M arrows is
// consecutive bits of one stream and is taken at once.
__device__ __forceinline__ void trace_walk(const uint2* __restrict__ panel,
                                           int c2s, int lane0, int hb, int fin,
                                           int b, int n, int64_t wp, bool tb,
                                           int max_step, int32_t* so,
                                           int32_t* sm) {
  const int best = fin >> 16;
  const int cell = best > 0 ? 65535 - (fin & 0xFFFF) : KEYROW * BAND;
  const int brr = cell / BAND - KEYROW;
  const int bc = cell % BAND;
  uint2 w;
  int bit;
  // the code streams of column c, and the bit of its row rr
  auto fetch = [&](int rr, int c) {
    const int v = c >> 1;
    const int hh = rr + v - hb;
    const int slot = ((v & ((1 << c2s) - 1)) << 1) | (c & 1);
    w = panel[((hh >> 5) * 4 + slot) * 32 + lane0 + (v >> c2s)];
    bit = hh & 31;
  };
  // the cell's code: 0 not positive, 1 I, 2 D, 3 M
  auto code_at = [&]() -> int {
    return ((w.x >> bit) & 1u) | (((w.y >> bit) & 1u) << 1);
  };
  // the cell (0, 0) is never live (row 0 starts at column QOFF), so
  // without a positive cell the first arrow reads 0
  int a0 = 0;
  if (best > 0) {
    fetch(brr, bc);
    a0 = code_at() % 3;  // M is arrow 0
  }
  const bool started = tb && best > 0;
  int rr = brr - (a0 == 1 ? 0 : 1);
  int j = bc - (a0 == 1 ? 1 : 0) + (a0 == 2 ? 1 : 0);
  bool act = started;
  bool over = false;
  int prv = a0, run = 1, cnt = 0, step = 0;
  while (act && step < max_step) {
    fetch(rr, j);
    // cells with an M arrow from this row down
    const uint32_t stop = ~(w.x & w.y) << (31 - bit);
    const int len = min(min(stop ? __clz(stop) : 32, bit + 1), max_step - step);
    int arrow = 0, adv = len;
    if (len == 0) {
      arrow = code_at();  // I, D or not positive
      act = arrow != 0;
      if (!act) break;
      adv = 1;
    }
    if (arrow != prv) {
      so[min(cnt, NOPS - 1)] = (run << 4) | prv;
      over = over || cnt >= NOPS;
      ++cnt;
      run = adv;
    } else {
      run += adv;
    }
    rr -= arrow != 1 ? adv : 0;
    j += (arrow == 2 ? 1 : 0) - (arrow == 1 ? 1 : 0);
    step += adv;
    prv = arrow;
  }
  if (started) {
    so[min(cnt, NOPS - 1)] = (run << 4) | prv;
    over = over || cnt >= NOPS;
    ++cnt;
  }
  over = over || act;  // still walking at the step cap
  const int i0 = brr - QOFF + b;  // table rows of the first and last cell
  const int i = rr - QOFF + b;
  sm[0] = (started && !over) ? cnt : -1;
  sm[1] = (n + b - 1) - (i0 + bc);
  sm[2] = (i + j) - (b - 1);
  sm[3] = static_cast<int32_t>(static_cast<uint32_t>(wp) -
                               static_cast<uint32_t>((b - 1) >> 1) +
                               static_cast<uint32_t>(i));
}

// What a lane knows of its group's job.
struct TraceJob {
  int b, n;    // band and query length; 0, 0 past the last job
  int64_t wp;  // band position (u32 value)
  bool tb;     // walk it
  bool live;   // it has a live cell
};

// A warp none of whose jobs has a live cell: zero ops, meta from the
// formulas alone.
__device__ __forceinline__ void trace_write_dead(const TraceJob& jb,
                                                 int32_t* __restrict__ ops,
                                                 int32_t* __restrict__ meta,
                                                 int64_t job0, int njobs,
                                                 int lane) {
  for (int t = lane; t < njobs * NOPS; t += 32) ops[job0 * NOPS + t] = 0;
  const int g = lane / TG;
  if (lane % TG == 0 && g < njobs)
    trace_walk(nullptr, 0, 0, 0, 0, jb.b, jb.n, jb.wp, jb.tb, 0, nullptr,
               meta + (job0 + g) * 4);
}

// The warp's two staged jobs (group g's rows at k3_staged(base, lq, g)):
// the tables, the walks, the output rows.  All 32 lanes must call it.
__device__ __forceinline__ void trace_warp(uint8_t* base, int lq,
                                           const TraceJob& jb,
                                           int32_t* __restrict__ ops,
                                           int32_t* __restrict__ meta,
                                           int64_t job0, int njobs,
                                           int max_step, int lane) {
  const int g = lane / TG;
  const int l = lane % TG;
  const uint8_t* sq = k3_staged(base, lq, g);
  const uint8_t* sw = sq + k2_sq_bytes(lq);
  uint2* panel = reinterpret_cast<uint2*>(base);
  int32_t* sops = reinterpret_cast<int32_t*>(k3_staged(base, lq, TJPW));
  int32_t* smeta = sops + TJPW * NOPS;
  for (int t = lane; t < TJPW * NOPS; t += 32) sops[t] = 0;

  const int bn = jb.live ? jb.b : 0;
  const int maxb = __reduce_max_sync(FULL, bn);
  // rows a live job's band reaches: [QOFF - b + 1, min(lq, n) + QOFF)
  const int r0 =
      __reduce_min_sync(FULL, jb.live ? max(0, QOFF - bn + 1) : lq + QOFF);
  const int nn = min(lq, jb.n);
  const int r1 = __reduce_max_sync(FULL, jb.live ? nn + QOFF : 0);
  // from QOFF to nn + QOFF - b a row's live range is the whole band
  const int m1 =
      __reduce_min_sync(FULL, jb.live ? nn + QOFF - bn + 1 : lq + QOFF);
  __syncwarp();  // the staged rows and the zeroed ops are in place
  // one column pair a lane holds bands up to 32, two pairs up to 64
  const bool wide = maxb > NARROW;
  const int fin =
      wide ? trace_pass<2>(sq, sw, panel, bn, jb.n, r0, r1, QOFF, m1, l, lane)
           : trace_pass<1>(sq, sw, panel, bn, jb.n, r0, r1, QOFF, m1, l, lane);
  __syncwarp();  // the code streams are whole
  if (l == 0 && g < njobs)
    trace_walk(panel, wide ? 1 : 0, TG * g, r0 - 1, fin, jb.b, jb.n, jb.wp,
               jb.tb, max_step, sops + g * NOPS, smeta + g * 4);
  __syncwarp();
  for (int t = lane; t < njobs * NOPS; t += 32)
    ops[job0 * NOPS + t] = sops[t];
  if (lane < njobs * 4) meta[job0 * 4 + lane] = smeta[lane];
}

__global__ void banded_trace_kernel(const uint8_t* __restrict__ q, int lq,
                                    const uint8_t* __restrict__ win, int lw,
                                    const int32_t* __restrict__ bw,
                                    const int32_t* __restrict__ qsz,
                                    const int64_t* __restrict__ wpos,
                                    const uint8_t* __restrict__ do_tb,
                                    int32_t* __restrict__ ops,
                                    int32_t* __restrict__ meta, int J,
                                    int max_step) {
  extern __shared__ uint4 smem16[];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t job0 =
      (blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + wib) * TJPW;
  if (job0 >= J) return;  // uniform per warp
  const int njobs = J - job0 < TJPW ? static_cast<int>(J - job0) : TJPW;
  const int g = lane / TG;
  const int l = lane % TG;
  TraceJob jb = {0, 0, 0, false, false};
  if (g < njobs) {
    jb.b = bw[job0 + g];
    jb.n = qsz[job0 + g];
    jb.wp = wpos[job0 + g];
    jb.tb = do_tb[job0 + g] != 0;
    jb.live = jb.b > 0 && jb.n > 0;
  }
  if (!__any_sync(FULL, jb.live)) {  // uniform per warp
    trace_write_dead(jb, ops, meta, job0, njobs, lane);
    return;
  }
  uint8_t* base = reinterpret_cast<uint8_t*>(smem16) + wib * k3_warp_bytes(lq);
  // --- group g stages its job's query and window, zero-padded
  if (jb.live) {
    const int sqb = k2_sq_bytes(lq);
    const int swb = k3_sw_bytes(lq);
    uint8_t* sq = k3_staged(base, lq, g);
    uint8_t* sw = sq + sqb;  // window row k at sw[SKEW + k]
    const uint8_t* qj = q + (job0 + g) * lq;
    const uint8_t* wj = win + (job0 + g) * lw;
    if (((lq | lw) & 3) == 0) {  // rows start on word bounds
      uint32_t* sq4 = reinterpret_cast<uint32_t*>(sq);
      uint32_t* sw4 = reinterpret_cast<uint32_t*>(sw);
      const uint32_t* q4 = reinterpret_cast<const uint32_t*>(qj);
      const uint32_t* w4 = reinterpret_cast<const uint32_t*>(wj);
#pragma unroll 4
      for (int k = l; k < sqb / 4; k += TG) {
        const int i = k - QOFF / 4;
        sq4[k] = (i >= 0 && i < lq / 4) ? __ldg(q4 + i) : 0u;
      }
#pragma unroll 4
      for (int k = l; k < swb / 4; k += TG) {
        const int i = k - SKEW / 4;
        sw4[k] = (i >= 0 && i < lw / 4 && i < (lq + QOFF) / 4) ? __ldg(w4 + i)
                                                               : 0u;
      }
    } else {
      for (int k = l; k < sqb; k += TG) {
        const int i = k - QOFF;
        sq[k] = (i >= 0 && i < lq) ? __ldg(qj + i) : 0;
      }
      for (int k = l; k < swb; k += TG) {
        const int i = k - SKEW;
        sw[k] = (i >= 0 && i < lw && i < lq + QOFF) ? __ldg(wj + i) : 0;
      }
    }
  }
  trace_warp(base, lq, jb, ops, meta, job0, njobs, max_step, lane);
}

// K3 on the caller's packed operands: job j traces the query row
// pnib[wunit[j]] (W bytes, base i in nibble i & 1 of byte i >> 1; its first
// lq nibbles) against the genome window of lq + QOFF nibbles that starts at
// nibble (wpos[j] + (wbw[j] - 1) / 2 - QOFF) & 0xFFFFFFFF of genome32 (n_gw
// words, eight nibbles a word, 0 past the end).
__global__ void banded_trace_packed_kernel(
    const uint32_t* __restrict__ genome32, int64_t n_gw,
    const uint8_t* __restrict__ pnib, int W, int lq,
    const int64_t* __restrict__ wunit, const int64_t* __restrict__ wbw,
    const int64_t* __restrict__ wqsz, const int64_t* __restrict__ wpos,
    const uint8_t* __restrict__ do_tb, int32_t* __restrict__ ops,
    int32_t* __restrict__ meta, int J, int max_step) {
  extern __shared__ uint4 smem16[];
  const int wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t job0 =
      (blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + wib) * TJPW;
  if (job0 >= J) return;  // uniform per warp
  const int njobs = J - job0 < TJPW ? static_cast<int>(J - job0) : TJPW;
  const int g = lane / TG;
  const int l = lane % TG;
  TraceJob jb = {0, 0, 0, false, false};
  if (g < njobs) {
    jb.b = static_cast<int>(wbw[job0 + g]);
    jb.n = static_cast<int>(wqsz[job0 + g]);
    jb.wp = wpos[job0 + g];
    jb.tb = do_tb[job0 + g] != 0;
    jb.live = jb.b > 0 && jb.n > 0;
  }
  if (!__any_sync(FULL, jb.live)) {  // uniform per warp
    trace_write_dead(jb, ops, meta, job0, njobs, lane);
    return;
  }
  uint8_t* base = reinterpret_cast<uint8_t*>(smem16) + wib * k3_warp_bytes(lq);
  // --- group g unpacks its job's query row and window, zero-padded
  if (jb.live) {
    const int sqb = k2_sq_bytes(lq);
    uint32_t* sq4 = reinterpret_cast<uint32_t*>(k3_staged(base, lq, g));
    stage_packed_query(sq4, sqb / 4, pnib + wunit[job0 + g] * W,
                       min(lq, 2 * W), l, TG);
    // window row k at byte SKEW + k
    stage_packed_window(sq4 + sqb / 4, k3_sw_bytes(lq) / 4, SKEW, genome32,
                        n_gw, window_start(jb.wp, jb.b), lq + QOFF, l, TG);
  }
  trace_warp(base, lq, jb, ops, meta, job0, njobs, max_step, lane);
}

}  // namespace

extern "C" int banded_score_packed_launch(
    const void* genome32, int64_t n_gw, const void* pnib, int W, int lq,
    const void* unit, const void* pos, const void* bw, const void* qsz,
    void* out, int J, void* stream) {
  // 8 warps x 4 jobs per block while their staged rows fit the 48 KB of
  // shared memory a block gets without opting in; fewer warps for long lq
  const int per_warp = JPW * (k2_sq_bytes(lq) + k2_sw_bytes(lq));
  const int fit = (48 * 1024) / per_warp;
  const int warps = fit < 8 ? fit : 8;
  if (warps < 1 || lq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int jobs_per_block = warps * JPW;
  const int blocks = (J + jobs_per_block - 1) / jobs_per_block;
  banded_score_packed_kernel<<<blocks, warps * 32, warps * per_warp,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(genome32), n_gw,
      static_cast<const uint8_t*>(pnib), W, lq,
      static_cast<const int64_t*>(unit), static_cast<const int64_t*>(pos),
      static_cast<const int64_t*>(bw), static_cast<const int64_t*>(qsz),
      static_cast<int32_t*>(out), J);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// One warp of TJPW jobs a block: a chunk's winners are under one wave, so
// nothing is gained by packing warps, and a block stays within the 48 KB of
// shared memory it gets without opting in up to lq = 670; longer rows opt
// in.  0 or the error code.
template <typename Kernel>
int k3_prepare(Kernel kernel, int lq, size_t* smem) {
  // the argmax key holds (row + KEYROW) * BAND + column in 16 bits, rows
  // up to lq + QOFF + SKEW
  if (lq < 1 || (lq + QOFF + SKEW + KEYROW) * BAND > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = static_cast<size_t>(k3_warp_bytes(lq));
  if (*smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

}  // namespace

extern "C" int banded_trace_launch(const void* q, int lq, const void* win,
                                   int lw, const void* bw, const void* qsz,
                                   const void* wpos, const void* do_tb,
                                   void* ops, void* meta, int J, int max_step,
                                   void* stream) {
  size_t smem;
  const int rc = k3_prepare(banded_trace_kernel, lq, &smem);
  if (rc != 0) return rc;
  banded_trace_kernel<<<(J + TJPW - 1) / TJPW, 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), lq, static_cast<const uint8_t*>(win), lw,
      static_cast<const int32_t*>(bw), static_cast<const int32_t*>(qsz),
      static_cast<const int64_t*>(wpos), static_cast<const uint8_t*>(do_tb),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta), J, max_step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int banded_trace_packed_launch(
    const void* genome32, int64_t n_gw, const void* pnib, int W, int lq,
    const void* wunit, const void* wbw, const void* wqsz, const void* wpos,
    const void* do_tb, void* ops, void* meta, int J, int max_step,
    void* stream) {
  size_t smem;
  const int rc = k3_prepare(banded_trace_packed_kernel, lq, &smem);
  if (rc != 0) return rc;
  banded_trace_packed_kernel<<<(J + TJPW - 1) / TJPW, 32, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(genome32), n_gw,
      static_cast<const uint8_t*>(pnib), W, lq,
      static_cast<const int64_t*>(wunit), static_cast<const int64_t*>(wbw),
      static_cast<const int64_t*>(wqsz), static_cast<const int64_t*>(wpos),
      static_cast<const uint8_t*>(do_tb), static_cast<int32_t*>(ops),
      static_cast<int32_t*>(meta), J, max_step);
  return static_cast<int>(cudaGetLastError());
}
