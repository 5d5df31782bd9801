// K5: the slot-rank carry of the fused programs: one warp a segment's
// head, one warp a region of the pool.
//
// Replaces the JAX programs' scatter-max plus running max
// (jax.lax.associative_scan(jnp.maximum, ...)) with the prefix counts
// around it: abismal_tpu/map/pipeline.py:1296-1323 (single-end: each
// candidate's rank among its read's gated candidates, :1317-1320 the scan)
// and :1680-1697 (paired-end: among its unit's accepted candidates,
// :1694-1696 the scan).  It is not a pl.pallas_call (XLA compiles the
// scan); the port ran it as a cumsum, a scatter_reduce and a torch.cummax,
// which on a 1-D tensor runs as one block.
//
// Given a mask gate (n,) and segments r with starts seg_start (n_seg,),
// non-decreasing, clamped to n, the first 0, and ends seg_end, it writes
//   - rank[i], for every i in [0, n): the gated entries in [seg_start[r*],
//     i), r* the last segment with seg_start[r*] <= i (the JAX scan's
//     g_exc[i] - base_of[i]);
//   - counts[r]: the gated entries in [seg_start[r], seg_end[r]), and
//     ex_counts[r] those of a second mask ex, where one is given.
// Every value is an integer: the output equals segment_rank_plain exactly
// where the callers' contract holds:
//   - seg_start[r] <= seg_end[r] <= seg_start[r + 1] (both fused programs
//     pass contiguous spans: seg_end[r] = seg_start[r + 1]), seg_end[n_seg
//     - 1] <= n;
//   - gate (and ex) are false on the tail [seg_end[n_seg - 1], n): the
//     programs gate on valid = f < total, and the last span ends at
//     min(total, n).  A rank in the tail is then the last segment's
//     count, which the tail's region warps take from the segment's own
//     entries alone (tests/test_torch_scan_kernels.py pins that the
//     programs' gates are false there).
//
// Bound on the H100: bytes, at ~10 a candidate (its gate, its mask, its
// int64 rank): ~1.3 MB at 131,072 candidates, 0.4 us at 3.35 TB/s, far
// under a launch.  What made torch.cummax slow is that one block walks
// the whole pool; a warp that walks a whole segment is as slow on the
// long ones (a read of 12,832 candidates at 1 Gb: 401 dependent steps).
// So no warp walks more than REGION entries one by one:
//   - the pool is cut into regions of REGION entries.  Segment r's warp
//     ranks its entries from its start to the end of the region that
//     holds the start (or the segment's end); the warp of region k ranks
//     the entries of [k REGION, (k + 1) REGION) whose segment began in an
//     earlier region, from a base count of that segment's gated entries
//     before the region.  The tail is such a region part of the last
//     segment;
//   - ranks go 32 entries a step: a __ballot_sync of the gate and a
//     __popc of the lanes below give each entry's rank within the step,
//     the warp's carry the rest; UNROLL steps' gates are loaded before
//     their ballots, so that their loads overlap;
//   - counts (a segment's, a region's base) are taken 16 mask bytes a
//     lane and load (a __popc of each word's 0/1 bytes), then one
//     __reduce_add_sync: a segment of 12,832 entries is 26 loads a lane;
//   - a region's warp finds its segment by a 32-way search of seg_start
//     (one __ballot_sync a step: 2,048 segments in three);
//   - counts stay int32 in the kernel (a segment holds under 2^31) and are
//     written as int64; no shared memory, no block-wide barrier; the
//     grid's size comes from n and n_seg alone (no host sync: a CUDA graph
//     captures the launch).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;       // warps a block
constexpr int REGION = 1024;   // pool entries a region
constexpr int UNROLL = 8;      // 32-entry steps whose loads go together

__device__ __forceinline__ int64_t imax64(int64_t a, int64_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
// a span bound read from the caller's tensors, kept inside [0, n] (a value
// outside breaks the contract, and no write may leave the pool)
__device__ __forceinline__ int64_t in_pool(int64_t v, int64_t n) {
  return imin64(imax64(v, 0), n);
}

// the set bytes of m over [x, y), summed over the warp; m's base is 16-byte
// aligned (the wrapper sees to it) and every byte is 0 or 1 (bool)
__device__ int count_range(const uint8_t* __restrict__ m, int64_t x,
                           int64_t y, int t) {
  int c = 0;
  if (x < y) {
    const int64_t xa = imin64(y, (x + 15) & ~int64_t{15});
    const int64_t ya = imax64(xa, y & ~int64_t{15});
    for (int64_t i = x + t; i < xa; i += 32) c += m[i] != 0;
    const uint4* v = reinterpret_cast<const uint4*>(m + xa);
    const int64_t nv = (ya - xa) >> 4;
#pragma unroll 4
    for (int64_t j = t; j < nv; j += 32) {
      const uint4 w = v[j];
      c += __popc(w.x & 0x01010101u) + __popc(w.y & 0x01010101u) +
           __popc(w.z & 0x01010101u) + __popc(w.w & 0x01010101u);
    }
    for (int64_t i = ya + t; i < y; i += 32) c += m[i] != 0;
  }
  return __reduce_add_sync(FULL, c);
}

// ranks of [x, y): carry plus the gated entries in [x, i)
__device__ void rank_range(const uint8_t* __restrict__ gate, int64_t x,
                           int64_t y, int carry, int t,
                           int64_t* __restrict__ rank) {
  const unsigned below = (1u << t) - 1;
  for (int64_t b = x; b < y; b += 32 * UNROLL) {
    bool g[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t i = b + 32 * k + t;
      g[k] = i < y && gate[i] != 0;
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int64_t i = b + 32 * k + t;
      const unsigned bal = __ballot_sync(FULL, g[k]);
      if (i < y) rank[i] = carry + __popc(bal & below);
      carry += __popc(bal);
    }
  }
}

// the last segment whose start is <= a (seg_start[0] = 0 <= a), by a
// 32-way search: one ballot a step
__device__ int segment_of(const int64_t* __restrict__ seg_start, int n_seg,
                          int64_t a, int t) {
  int lo = 0, len = n_seg;
  while (len > 1) {
    const int step = (len + 31) / 32;
    const int j = lo + t * step;
    const bool ok = t * step < len && seg_start[j] <= a;
    const unsigned bal = __ballot_sync(FULL, ok);
    const int k = 31 - __clz(bal);  // lane 0 probes lo: bal != 0
    len = min(step, len - k * step);
    lo += k * step;
  }
  return lo;
}

__global__ void segment_rank_kernel(
    const uint8_t* __restrict__ gate, const uint8_t* __restrict__ ex,
    int64_t n, const int64_t* __restrict__ seg_start,
    const int64_t* __restrict__ seg_end, int n_seg,
    int64_t* __restrict__ rank, int64_t* __restrict__ counts,
    int64_t* __restrict__ ex_counts) {
  const int t = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    (threadIdx.x >> 5);
  const int last = n_seg - 1;
  if (w < n_seg) {
    // --- segment r: its counts, and its ranks up to its region's end
    const int r = static_cast<int>(w);
    const int64_t s = in_pool(seg_start[r], n);
    const int64_t e = imax64(s, in_pool(seg_end[r], n));
    const int64_t hi = r < last ? in_pool(seg_start[r + 1], n) : n;
    const int ng = count_range(gate, s, e, t);
    const int nx = ex != nullptr ? count_range(ex, s, e, t) : 0;
    if (t == 0) {
      counts[r] = ng;
      if (ex != nullptr) ex_counts[r] = nx;
    }
    rank_range(gate, s, imin64(hi, (s / REGION + 1) * REGION), 0, t, rank);
    return;
  }
  // --- region k: the entries whose segment began in an earlier region
  const int64_t a = (w - n_seg) * REGION;
  if (a >= n) return;
  const int r = segment_of(seg_start, n_seg, a, t);
  const int64_t s = in_pool(seg_start[r], n);
  if (s == a) return;  // segment r's warp ranks from a on
  const int64_t hi = r < last ? in_pool(seg_start[r + 1], n) : n;
  // the last segment's gates are false from its end on (the contract)
  const int64_t upto = r < last ? a : imin64(a, in_pool(seg_end[last], n));
  const int base = count_range(gate, s, upto, t);
  rank_range(gate, a, imin64(hi, a + REGION), base, t, rank);
}

}  // namespace

extern "C" int segment_rank_launch(const void* gate, const void* ex,
                                   int64_t n, const void* seg_start,
                                   const void* seg_end, int n_seg,
                                   void* rank, void* counts, void* ex_counts,
                                   void* stream) {
  if (n <= 0 || n_seg <= 0 || (ex != nullptr && ex_counts == nullptr) ||
      reinterpret_cast<uintptr_t>(gate) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ex) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t warps = n_seg + (n + REGION - 1) / REGION;
  const int blocks = static_cast<int>((warps + WARPS - 1) / WARPS);
  segment_rank_kernel<<<blocks, 32 * WARPS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(gate), static_cast<const uint8_t*>(ex), n,
      static_cast<const int64_t*>(seg_start),
      static_cast<const int64_t*>(seg_end), n_seg,
      static_cast<int64_t*>(rank), static_cast<int64_t*>(counts),
      static_cast<int64_t*>(ex_counts));
  return static_cast<int>(cudaGetLastError());
}
