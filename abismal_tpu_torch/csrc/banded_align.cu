// K2 and K3: banded local-alignment score and traceback, one warp per job.
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
// Bound on the H100: latency of the serial row loop (up to lmax + QOFF
// dependent rows per job, each a chain of shuffles).  The design puts one
// job on one warp with two band columns per lane, so a row costs one
// deletion shuffle and a five-step warp max-scan for the insertion chain,
// and all arithmetic is exact int32.  Rows that the band cannot reach
// (before QOFF - bw + 1 and from min(lp, qsz) + QOFF on) are skipped, and
// 8 warps per block (K2) keep enough jobs in flight to hide the shuffle
// latency.  K3 keeps its job's nibble panel (lp + QOFF rows x 64 columns x
// 4 bits, 6 KB at lmax 128) in shared memory, so the walk that follows --
// a serial pointer chase run by one lane -- never touches device memory
// until it writes the ops.

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

// One DP row of the warp's job.  prev0/prev1 hold the previous row's stored
// values of this lane's two columns; on return they hold this row's.
template <bool TRACE>
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
  out.nibs = 0;
  if (TRACE) {
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
  }
  prev0 = out.s0;
  prev1 = out.s1;
  return out;
}

__global__ void banded_score_kernel(const uint8_t* __restrict__ q, int lq,
                                    const uint8_t* __restrict__ win, int lw,
                                    const int32_t* __restrict__ bw,
                                    const int32_t* __restrict__ qsz,
                                    int32_t* __restrict__ out, int J) {
  const int64_t job =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (job >= J) return;  // uniform per warp
  const uint8_t* qj = q + job * lq;
  const uint8_t* wj = win + job * lw;
  const int b = bw[job];
  const int n = qsz[job];
  int prev0 = 0, prev1 = 0, best = 0;
  const int r0 = max(0, QOFF - b + 1);
  const int r1 = min(lq, n) + QOFF;
  for (int rr = r0; rr < r1; ++rr) {
    const uint8_t ref = rr < lw ? __ldg(wj + rr) : 0;
    dp_row<false>(rr, b, n, qj, lq, ref, lane, prev0, prev1);
    best = max(best, max(prev0, prev1));
  }
  best = __reduce_max_sync(FULL, best);
  if (lane == 0) out[job] = best;
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
    const RowCells c = dp_row<true>(rr, b, n, qj, lq, ref, lane, prev0, prev1);
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
  const int threads = 256;  // 8 jobs per block
  const int blocks = (J + 7) / 8;
  banded_score_kernel<<<blocks, threads, 0,
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
