// K2 and K3: banded local-alignment score and traceback.
//
// K2 (banded_score_launch) replaces abismal_tpu/kernels/banded_align.py:
// _kernel_body (the Pallas scorer called at abismal_tpu/map/pipeline.py:1482).
// K3 (banded_trace_launch) replaces banded_align.py:_tracer_body together
// with the arrow walk of pipeline.py:build_tb_block (:1080-1160), fused.
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
//     staged nor run.
// K3 keeps one warp per job with two band columns per lane and its job's
// nibble panel (lp + QOFF rows x 64 columns x 4 bits, 6 KB at lmax 128) in
// shared memory, so the walk that follows -- a serial pointer chase run by
// one lane -- never touches device memory until it writes the ops.

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

struct RowCells {
  int s0, s1;    // stored values of columns 2 * lane and 2 * lane + 1
  uint8_t nibs;  // their (arrow | positive) nibbles, column 2 * lane low
};

// One DP row of the warp's job in K3.  prev0/prev1 hold the previous row's
// stored values of this lane's two columns; on return they hold this row's.
__device__ __forceinline__ RowCells dp_row(int rr, int b, int n,
                                           const uint8_t* __restrict__ qj,
                                           int lq, uint8_t ref, int lane,
                                           int& prev0, int& prev1) {
  const int c0 = 2 * lane;
  const int c1 = c0 + 1;
  const int left = max(QOFF - rr, 0);
  const int right = min(b, n + QOFF - rr);
  const bool valid0 = c0 >= left && c0 < right;
  const bool valid1 = c1 >= left && c1 < right;
  const int qi0 = rr + c0 - QOFF;
  const int qi1 = qi0 + 1;
  const uint8_t q0 = (qi0 >= 0 && qi0 < lq) ? __ldg(qj + qi0) : 0;
  const uint8_t q1 = (qi1 >= 0 && qi1 < lq) ? __ldg(qj + qi1) : 0;
  const int diag0 = prev0 + ((q0 & ref) ? MATCH : MISMATCH);
  const int diag1 = prev1 + ((q1 & ref) ? MATCH : MISMATCH);
  const int x10 = max(0, diag0);
  const int x11 = max(0, diag1);
  // deletion neighbour prev(c + 1): own column c1 for c0, lane + 1's c0
  // for c1 (column 64 reads 0; right <= BW_MAX < 63 never reaches it)
  int nb = __shfl_down_sync(FULL, prev0, 1);
  if (lane == 31) nb = 0;
  const int del0 = prev1 + INDEL;
  const int del1 = nb + INDEL;
  const bool app0 = c0 < right - 1;
  const bool app1 = c1 < right - 1;
  const int x0 = app0 ? max(x10, del0) : x10;
  const int x1 = app1 ? max(x11, del1) : x11;
  // insertion chain: inclusive max-prefix over columns of x(c) - INDEL * c
  int m0 = valid0 ? x0 - INDEL * c0 : NEG;
  const int m1 = max(m0, valid1 ? x1 - INDEL * c1 : NEG);
  int s = m1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(FULL, s, off);
    if (lane >= off) s = max(s, t);
  }
  int before = __shfl_up_sync(FULL, s, 1);
  if (lane == 0) before = NEG;
  m0 = max(m0, before);
  RowCells out;
  out.s0 = valid0 ? m0 + INDEL * c0 : 0;
  out.s1 = valid1 ? s + INDEL * c1 : 0;
  int left0 = __shfl_up_sync(FULL, out.s1, 1);  // stored(c0 - 1)
  if (lane == 0) left0 = 0;
  int a0 = diag0 >= 0 ? 0 : 3;
  if (app0 && del0 >= x10) a0 = 2;
  if (out.s0 == left0 + INDEL) a0 = 1;
  int a1 = diag1 >= 0 ? 0 : 3;
  if (app1 && del1 >= x11) a1 = 2;
  if (out.s1 == out.s0 + INDEL) a1 = 1;
  const int n0 = valid0 ? (a0 | (out.s0 > 0 ? 4 : 0)) : 0;
  const int n1 = valid1 ? (a1 | (out.s1 > 0 ? 4 : 0)) : 0;
  out.nibs = static_cast<uint8_t>(n0 | (n1 << 4));
  prev0 = out.s0;
  prev1 = out.s1;
  return out;
}

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

__global__ void banded_score_kernel(const uint8_t* __restrict__ q, int lq,
                                    const uint8_t* __restrict__ win, int lw,
                                    const int32_t* __restrict__ bw,
                                    const int32_t* __restrict__ qsz,
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

  // --- group g of 8 lanes holds job g's band and length.  A job without a
  // live cell (band <= 0, or a fill row of qsz 0) scores 0, is not staged
  // and takes no part in the row ranges
  const int g = lane >> 3;
  const int l = lane & 7;
  int b = 0, n = 0;
  if (g < njobs) {
    b = bw[job0 + g];
    n = qsz[job0 + g];
  }
  const bool live = g < njobs && b > 0 && n > 0;
  if (g < njobs && !live && l == 0) out[job0 + g] = 0;
  const unsigned staged = __ballot_sync(FULL, live);
  if (staged == 0u) return;  // uniform per warp

  // --- stage the live jobs' queries and windows, zero-padded
  const bool words = ((lq | lw) & 3) == 0;  // rows start on word bounds
  for (int s = 0; s < njobs; ++s) {
    if (!((staged >> (8 * s)) & 1u)) continue;  // uniform per warp
    uint8_t* sq = base + s * (sqb + swb);
    uint8_t* sw = sq + sqb;
    const uint8_t* qj = q + (job0 + s) * lq;
    const uint8_t* wj = win + (job0 + s) * lw;
    if (words) {
      uint32_t* sq4 = reinterpret_cast<uint32_t*>(sq);
      uint32_t* sw4 = reinterpret_cast<uint32_t*>(sw);
      const uint32_t* q4 = reinterpret_cast<const uint32_t*>(qj);
      const uint32_t* w4 = reinterpret_cast<const uint32_t*>(wj);
#pragma unroll 2
      for (int k = lane; k < sqb / 4; k += 32) {
        const int i = k - QOFF / 4;
        sq4[k] = (i >= 0 && i < lq / 4) ? __ldg(q4 + i) : 0u;
      }
#pragma unroll 2
      for (int k = lane; k < swb / 4; k += 32)
        sw4[k] = (k < lw / 4 && k < (lq + QOFF) / 4) ? __ldg(w4 + k) : 0u;
    } else {
      for (int k = lane; k < sqb; k += 32) {
        const int i = k - QOFF;
        sq[k] = (i >= 0 && i < lq) ? __ldg(qj + i) : 0;
      }
      for (int k = lane; k < swb; k += 32)
        sw[k] = (k < lw && k < lq + QOFF) ? __ldg(wj + k) : 0;
    }
  }
  __syncwarp();

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

__global__ void banded_trace_kernel(const uint8_t* __restrict__ q, int lq,
                                    const uint8_t* __restrict__ win, int lw,
                                    const int32_t* __restrict__ bw,
                                    const int32_t* __restrict__ qsz,
                                    const int64_t* __restrict__ wpos,
                                    const uint8_t* __restrict__ do_tb,
                                    int32_t* __restrict__ ops,
                                    int32_t* __restrict__ meta, int J,
                                    int panel_rows, int max_step) {
  extern __shared__ uint32_t smem[];
  const int wib = threadIdx.x >> 5;
  const int64_t job = blockIdx.x * static_cast<int64_t>(blockDim.x >> 5) + wib;
  const int lane = threadIdx.x & 31;
  if (job >= J) return;  // uniform per warp
  // panel byte (rr, k) holds columns 2k (low nibble) and 2k + 1 (high)
  uint8_t* panel = reinterpret_cast<uint8_t*>(smem) + wib * panel_rows * 32;
  uint32_t* pwords = reinterpret_cast<uint32_t*>(panel);
  for (int k = lane; k < panel_rows * 8; k += 32) pwords[k] = 0u;
  __syncwarp();

  const uint8_t* qj = q + job * lq;
  const uint8_t* wj = win + job * lw;
  const int b = bw[job];
  const int n = qsz[job];
  int prev0 = 0, prev1 = 0, best = 0, brr = 0, bc = 0;
  const int r0 = max(0, QOFF - b + 1);
  const int r1 = min(lq, n) + QOFF;
  for (int rr = r0; rr < r1; ++rr) {
    const uint8_t ref = rr < lw ? __ldg(wj + rr) : 0;
    const RowCells c = dp_row(rr, b, n, qj, lq, ref, lane, prev0, prev1);
    panel[rr * 32 + lane] = c.nibs;
    // row-major-first argmax: strict '>' keeps the earliest row, the min
    // column among the row's maxima the earliest column
    const int rmax = __reduce_max_sync(FULL, max(c.s0, c.s1));
    const int cand =
        c.s0 == rmax ? 2 * lane : (c.s1 == rmax ? 2 * lane + 1 : BAND);
    const int cstar = __reduce_min_sync(FULL, cand);
    if (rmax > best) {
      best = rmax;
      brr = rr;
      bc = cstar;
    }
  }
  __syncwarp();
  if (lane != 0) return;

  auto fetch = [&](int i, int j) -> int {
    const int rr = i - b + QOFF;
    if (rr < 0 || rr >= panel_rows || j < 0 || j >= BAND) return 0;
    return (panel[rr * 32 + (j >> 1)] >> ((j & 1) * 4)) & 0xF;
  };
  int32_t* orow = ops + job * NOPS;
  for (int k = 0; k < NOPS; ++k) orow[k] = 0;
  const int i0 = brr - QOFF + b;
  const int j0 = bc;
  const bool started = do_tb[job] != 0 && best > 0;
  const int a0 = fetch(i0, j0) & 3;
  int i = i0 - (a0 == 1 ? 0 : 1);
  int j = j0 - (a0 == 1 ? 1 : 0) + (a0 == 2 ? 1 : 0);
  bool act = started;
  bool over = false;
  int prv = a0, run = 1, cnt = 0;
  for (int step = 0; act && step < max_step; ++step) {
    const int nib = fetch(i, j);
    act = (nib & 4) != 0;
    if (!act) break;
    const int arrow = nib & 3;
    if (arrow != prv) {
      orow[min(cnt, NOPS - 1)] = (run << 4) | prv;
      over = over || cnt >= NOPS;
      ++cnt;
      run = 1;
    } else {
      ++run;
    }
    if (arrow != 1) --i;
    j += (arrow == 2 ? 1 : 0) - (arrow == 1 ? 1 : 0);
    prv = arrow;
  }
  if (started) {
    orow[min(cnt, NOPS - 1)] = (run << 4) | prv;
    over = over || cnt >= NOPS;
  }
  over = over || act;  // still walking at the step cap
  if (started) ++cnt;
  const uint32_t newpos = static_cast<uint32_t>(wpos[job]) -
                          static_cast<uint32_t>((b - 1) >> 1) +
                          static_cast<uint32_t>(i);
  int32_t* mrow = meta + job * 4;
  mrow[0] = (started && !over) ? cnt : -1;
  mrow[1] = (n + b - 1) - (i0 + j0);
  mrow[2] = (i + j) - (b - 1);
  mrow[3] = static_cast<int32_t>(newpos);
}

}  // namespace

extern "C" int banded_score_launch(const void* q, int lq, const void* win,
                                   int lw, const void* bw, const void* qsz,
                                   void* out, int J, void* stream) {
  // 8 warps x 4 jobs per block while their staged rows fit the 48 KB of
  // shared memory a block gets without opting in; fewer warps for long lq
  const int per_warp = JPW * (k2_sq_bytes(lq) + k2_sw_bytes(lq));
  const int fit = (48 * 1024) / per_warp;
  const int warps = fit < 8 ? fit : 8;
  if (warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int jobs_per_block = warps * JPW;
  const int blocks = (J + jobs_per_block - 1) / jobs_per_block;
  banded_score_kernel<<<blocks, warps * 32, warps * per_warp,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), lq, static_cast<const uint8_t*>(win), lw,
      static_cast<const int32_t*>(bw), static_cast<const int32_t*>(qsz),
      static_cast<int32_t*>(out), J);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int banded_trace_launch(const void* q, int lq, const void* win,
                                   int lw, const void* bw, const void* qsz,
                                   const void* wpos, const void* do_tb,
                                   void* ops, void* meta, int J,
                                   int panel_rows, int max_step,
                                   int warps_per_block, void* stream) {
  const int blocks = (J + warps_per_block - 1) / warps_per_block;
  const size_t smem = static_cast<size_t>(warps_per_block) * panel_rows * 32;
  banded_trace_kernel<<<blocks, warps_per_block * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), lq, static_cast<const uint8_t*>(win), lw,
      static_cast<const int32_t*>(bw), static_cast<const int32_t*>(qsz),
      static_cast<const int64_t*>(wpos), static_cast<const uint8_t*>(do_tb),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta), J, panel_rows,
      max_step);
  return static_cast<int>(cudaGetLastError());
}
