// K6: the candidate core's global candidate list: one warp a unit's head,
// one warp a chunk of the list.
//
// Replaces abismal_tpu/map/pipeline.py:868-921, the global candidate list
// of _make_core: the cumsum over the cells, the cell-of-candidate carry (a
// scatter-max plus jax.lax.associative_scan(jnp.maximum, ...), :876-889),
// the megarow gather of each candidate's cell start and bucket offset
// (:895-913) and the index_all gather of its position (:915-920).  It is
// not a pl.pallas_call (XLA compiles the scan); the port ran it as a cumsum
// over B n_cells cells, a torch.searchsorted of every candidate into the
// cells' starts and a gather per column.
//
// Unit u's cells hold cnt_cells[u, c] candidates (already clamped to
// CELLCAP) of the bucket that starts at lo_cells[u, c] in index_all; the
// unit's candidates are laid out from unit_start[u] (the exclusive prefix
// of unit_total, the row sums of cnt_cells), cell after cell.  For every
// position f < gflat of that list it writes out[0..3][f] = (b_of, cell_of,
// slot, pos) and valid[f]:
//   - f < total (total = unit_start[B - 1] + unit_total[B - 1]): f's unit
//     and cell, slot = f - the cell's start, valid = 1, pos = (index_all[lo
//     + slot] - coff) & 0xFFFFFFFF, coff = cell_of >> 1 in the specific
//     phase (cell_of < 2 o_spec) and (cell_of - 2 o_spec) >> 1 in the
//     sensitive one;
//   - f in [total, gflat), the tail: what searchsorted(starts, f, right) -
//     1 gives there, the last cell overall: b_of = B - 1, cell_of = n_cells
//     - 1, slot = f - that cell's start, pos = 0, valid = 0.
// Units past gflat write nothing, and a unit that straddles it stops
// there.  Every value is an integer: the output equals candidate_list_plain
// exactly where unit_start and unit_total are those of cnt_cells (the
// caller computes them from it).  An index entry past index_all's end
// (which the plain version's gather refuses) is read clamped.
//
// Bound on the H100: bytes.  The cell counts are read once (B n_cells
// int64: 5.5 MB at B = 2048, n_cells = 336), a bucket offset and an index
// entry per candidate, and 33 bytes a candidate written: ~10 MB, ~3 us at
// 3.35 TB/s.  What bounds a warp is its chain of dependent loads, and a
// warp that writes a whole unit is as slow on the large ones (units of
// thousands of candidates at CELLCAP in many cells).  So no warp writes
// more than CAP positions:
//   - unit u's warp writes the unit's first CAP candidates; the warp of
//     list chunk k writes what lies in [k CAP, (k + 1) CAP) past the first
//     CAP of a unit, and the tail there.  A chunk's warp finds the unit at
//     its start by a 32-way search of unit_start (one __ballot_sync a
//     step), then takes the units from there 32 at a time and works on
//     those whose candidates past CAP reach into the chunk;
//   - to write a unit's positions the warp stages the unit's n_cells counts
//     in its slice of shared memory (loads that do not wait on each other),
//     scans them there 32 at a time with __shfl_up_sync (int32: a unit
//     holds at most n_cells x CELLCAP = 92,160 candidates at lmax 256), so
//     that each cell's start is a shared-memory word, then writes RPL
//     candidates a lane a round: RPL binary searches over those starts (10
//     steps at n_cells = 720), then their bucket offsets, then their index
//     entries, each batch of loads issued together;
//   - the grid's size comes from B and gflat alone (no host sync: a CUDA
//     graph captures the launch).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;  // warps a block
constexpr int RPL = 4;    // candidates a lane writes a round
constexpr int CAP = 32 * RPL;  // positions a warp writes (one round)
constexpr int64_t M32 = 0xFFFFFFFFll;

__device__ __forceinline__ int64_t imax64(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct List {
  const int64_t* cnt_cells;
  const int64_t* lo_cells;
  const int64_t* unit_start;
  const int64_t* unit_total;
  const int64_t* index_all;
  int64_t n_idx;
  int B, n_cells, o_spec;
  int64_t gflat;
  int64_t* out;  // (4, gflat): b_of, cell_of, slot, pos
  uint8_t* valid;
};

// pre[c] = the start of unit u's cell c relative to the unit's first
// candidate, staged and scanned in the warp's slice of shared memory
__device__ void scan_unit(const List& L, int u, int* pre, int t) {
  const int64_t row = static_cast<int64_t>(u) * L.n_cells;
  __syncwarp();  // the warp's reads of the previous unit's starts are done
#pragma unroll 4
  for (int c = t; c < L.n_cells; c += 32)
    pre[c] = static_cast<int>(L.cnt_cells[row + c]);
  __syncwarp();
  int carry = 0;
  for (int c0 = 0; c0 < L.n_cells; c0 += 32) {
    const int c = c0 + t;
    const int v = c < L.n_cells ? pre[c] : 0;
    int inc = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, d);
      if (t >= d) inc += y;
    }
    if (c < L.n_cells) pre[c] = carry + inc - v;
    carry += __shfl_sync(FULL, inc, 31);
  }
  __syncwarp();
}

// unit u's candidates [qa, qb) (relative to its first, at s_u)
__device__ void write_unit(const List& L, int u, int64_t s_u, const int* pre,
                           int qa, int qb, int t) {
  const int64_t row = static_cast<int64_t>(u) * L.n_cells;
  for (int q0 = qa; q0 < qb; q0 += CAP) {
    int cell[RPL], sl[RPL];
    int64_t lo[RPL], p[RPL];
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int q = q0 + 32 * j + t;
      int a = 0, b = L.n_cells;  // the last cell whose start is <= q
      while (b - a > 1) {
        const int mid = (a + b) >> 1;
        if (pre[mid] <= q) a = mid;
        else b = mid;
      }
      cell[j] = a;
      sl[j] = q - pre[a];
    }
#pragma unroll
    for (int j = 0; j < RPL; ++j)
      lo[j] = q0 + 32 * j + t < qb ? L.lo_cells[row + cell[j]] : 0;
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      const int64_t k = imin64(imax64(lo[j] + sl[j], 0), L.n_idx - 1);
      p[j] = q0 + 32 * j + t < qb ? L.index_all[k] : 0;
    }
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
      if (q0 + 32 * j + t >= qb) continue;
      const int64_t f = s_u + q0 + 32 * j + t;
      const int c = cell[j];
      const int coff = c < 2 * L.o_spec ? c >> 1 : (c - 2 * L.o_spec) >> 1;
      L.out[f] = u;
      L.out[L.gflat + f] = c;
      L.out[2 * L.gflat + f] = sl[j];
      L.out[3 * L.gflat + f] = (p[j] - coff) & M32;
      L.valid[f] = 1;
    }
  }
}

// the last unit whose start is <= f (unit_start[0] = 0 <= f), by a 32-way
// search: one ballot a step
__device__ int unit_of(const List& L, int64_t f, int t) {
  int lo = 0, len = L.B;
  while (len > 1) {
    const int step = (len + 31) / 32;
    const bool ok = t * step < len && L.unit_start[lo + t * step] <= f;
    const unsigned bal = __ballot_sync(FULL, ok);
    const int k = 31 - __clz(bal);  // lane 0 probes lo: bal != 0
    len = min(step, len - k * step);
    lo += k * step;
  }
  return lo;
}

__global__ void candidate_list_kernel(List L) {
  extern __shared__ int starts_smem[];
  const int t = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + wib;
  int* const pre = starts_smem + wib * L.n_cells;

  if (w < L.B) {
    // --- unit u: its first CAP candidates
    const int u = static_cast<int>(w);
    const int64_t s_u = L.unit_start[u];
    const int64_t n = imin64(imin64(L.unit_total[u], CAP), L.gflat - s_u);
    if (n <= 0 || s_u < 0) return;  // (a start below 0 breaks the contract)
    scan_unit(L, u, pre, t);
    write_unit(L, u, s_u, pre, 0, static_cast<int>(n), t);
    return;
  }
  // --- list chunk k: [f0, f1)
  const int64_t f0 = (w - L.B) * CAP;
  const int64_t f1 = imin64(L.gflat, f0 + CAP);
  if (f0 >= f1) return;
  const int64_t total = L.unit_start[L.B - 1] + L.unit_total[L.B - 1];
  if (f1 > total) {  // the tail: the last cell overall
    const int64_t last = static_cast<int64_t>(L.B) * L.n_cells - 1;
    const int64_t start_last = total - L.cnt_cells[last];
    for (int64_t f = imax64(f0, total) + t; f < f1; f += 32) {
      L.out[f] = L.B - 1;
      L.out[L.gflat + f] = L.n_cells - 1;
      L.out[2 * L.gflat + f] = f - start_last;
      L.out[3 * L.gflat + f] = 0;
      L.valid[f] = 0;
    }
  }
  if (f0 >= total) return;
  // units whose candidates past their first CAP reach into [f0, f1)
  for (int u0 = unit_of(L, f0, t); u0 < L.B; u0 += 32) {
    const int uu = u0 + t;
    const int64_t s = uu < L.B ? L.unit_start[uu] : f1;
    const int64_t n = uu < L.B ? L.unit_total[uu] : 0;
    const bool work =
        n > CAP && imax64(f0, s + CAP) < imin64(f1, s + n);
    unsigned bal = __ballot_sync(FULL, work);
    while (bal != 0) {
      const int l = __ffs(bal) - 1;
      bal &= bal - 1;
      const int u = u0 + l;
      const int64_t s_u = L.unit_start[u];
      const int64_t n_u = L.unit_total[u];
      scan_unit(L, u, pre, t);
      write_unit(L, u, s_u, pre, static_cast<int>(imax64(f0, s_u + CAP) - s_u),
                 static_cast<int>(imin64(f1, s_u + n_u) - s_u), t);
    }
    if (__any_sync(FULL, s >= f1)) break;  // later units start past f1
  }
}

}  // namespace

extern "C" int candidate_list_launch(
    const void* cnt_cells, const void* lo_cells, const void* unit_start,
    const void* unit_total, const void* index_all, int64_t n_idx, int B,
    int n_cells, int o_spec, int64_t gflat, void* out, void* valid,
    void* stream) {
  const size_t smem = sizeof(int) * WARPS * static_cast<size_t>(n_cells);
  if (B <= 0 || n_cells <= 0 || gflat <= 0 || n_idx <= 0 ||
      gflat >= (int64_t{1} << 31) || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  List L;
  L.cnt_cells = static_cast<const int64_t*>(cnt_cells);
  L.lo_cells = static_cast<const int64_t*>(lo_cells);
  L.unit_start = static_cast<const int64_t*>(unit_start);
  L.unit_total = static_cast<const int64_t*>(unit_total);
  L.index_all = static_cast<const int64_t*>(index_all);
  L.n_idx = n_idx;
  L.B = B;
  L.n_cells = n_cells;
  L.o_spec = o_spec;
  L.gflat = gflat;
  L.out = static_cast<int64_t*>(out);
  L.valid = static_cast<uint8_t*>(valid);
  const int64_t warps = B + (gflat + CAP - 1) / CAP;
  const int blocks = static_cast<int>((warps + WARPS - 1) / WARPS);
  candidate_list_kernel<<<blocks, 32 * WARPS, smem,
                          static_cast<cudaStream_t>(stream)>>>(L);
  return static_cast<int>(cudaGetLastError());
}
