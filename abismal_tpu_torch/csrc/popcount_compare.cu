// K1: bisulfite-aware popcount Hamming compare, four lanes per candidate.
//
// Replaces abismal_tpu/kernels/popcount_compare.py:_body (the Pallas kernel
// called at abismal_tpu/map/pipeline.py:944).  For candidate g at genome
// nibble position pos[g] (taken modulo 2^32) and read unit b_of[g]:
//
//   d[g] = sum_{j < nw_of[g]} 8 - popc(read_word[b_of[g]][j] & win_word[j])
//
// where win_word[j] is the genome word run starting at word pos >> 3,
// funnel-shifted right by 4 * (pos & 7) bits.  Genome words past the end of
// genome32 read as 0 (the TPU layout's zero guard rows).
//
// Bound on the H100: bytes.  A candidate needs 68 bytes of genome at a
// data-dependent place (17 words at lmax 128), 20 bytes of indices and its
// share of the unit's 64 bytes of read words; the arithmetic is four ops a
// word.  So the design is about how those bytes are asked for:
//   - a group of 4 lanes takes one candidate, and lane t compares read
//     words 4t .. 4t + 3.  It reads the two 16-byte-aligned quads of
//     genome words that hold the five words it needs, as two 128-bit
//     loads; the group's first loads cover one aligned 64-byte run, so a
//     warp asks for whole sectors and every load is in flight at once
//     (one thread per candidate walking 17 scalar loads keeps two in
//     flight and touches 32 unrelated lines per instruction);
//   - the funnel shift runs over registers; a lane whose four words lie
//     past the word count nw loads nothing, and nw masks single words;
//   - the lane's four read words are one 128-bit load; candidates come
//     sorted by unit, so a block's few units stay in L1 and need no staging
//     in shared memory;
//   - the four partial sums meet in two shuffles and lane 0 writes d.
// pos and b_of are taken as the int64 the candidate list holds, so the
// main path adds no conversion.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// The aligned quad of genome words starting at word index i (a multiple of
// 4); words at or past n_gw read as 0.
__device__ __forceinline__ uint4 load_quad(const uint32_t* __restrict__ g,
                                           int64_t n_gw, int64_t i) {
  if (i + 4 <= n_gw) return __ldg(reinterpret_cast<const uint4*>(g + i));
  uint4 v;
  v.x = i < n_gw ? __ldg(g + i) : 0u;
  v.y = i + 1 < n_gw ? __ldg(g + i + 1) : 0u;
  v.z = i + 2 < n_gw ? __ldg(g + i + 2) : 0u;
  v.w = 0u;  // i + 3 >= n_gw here
  return v;
}

__global__ void popcount_compare_kernel(const uint32_t* __restrict__ genome32,
                                        int64_t n_gw,
                                        const int64_t* __restrict__ pos,
                                        const uint32_t* __restrict__ pk,
                                        int nw_words,
                                        const int64_t* __restrict__ b_of,
                                        const int32_t* __restrict__ nw_of,
                                        int32_t* __restrict__ d, int64_t G) {
  const int64_t tid =
      blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t g = tid >> 2;
  const int t = threadIdx.x & 3;
  // a group is whole or absent, and a warp's shuffles name all 32 lanes:
  // lanes of absent groups run on candidate G - 1 and do not write
  const bool live = g < G;
  const int64_t gg = live ? g : G - 1;
  const uint64_t p = static_cast<uint64_t>(pos[gg]) & 0xFFFFFFFFull;
  const int64_t w = static_cast<int64_t>(p >> 3);
  const unsigned sh = static_cast<unsigned>(p & 7) * 4u;
  const int nw = min(nw_of[gg], nw_words);
  const uint32_t* rw = pk + b_of[gg] * nw_words;

  const int o = static_cast<int>(w & 3);
  int acc = 0;
  // 16 read words a turn: one turn at lmax 128
  for (int j0 = 4 * t; j0 < nw; j0 += 16) {
    // genome words w + j0 .. w + j0 + 4 lie in the aligned quads at a, a + 4
    const int64_t a = w - o + j0;
    const uint4 lo = load_quad(genome32, n_gw, a);
    const uint4 hi = load_quad(genome32, n_gw, a + 4);
    uint32_t r[4];
    if ((nw_words & 3) == 0) {  // the unit's row keeps 16-byte alignment
      const uint4 rv = __ldg(reinterpret_cast<const uint4*>(rw + j0));
      r[0] = rv.x, r[1] = rv.y, r[2] = rv.z, r[3] = rv.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        r[k] = j0 + k < nw_words ? __ldg(rw + j0 + k) : 0u;
    }
    // words o .. o + 4 of the eight, o in 0..3, picked in two rounds of
    // selects so that everything stays in registers
    const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t v[6], x[5];
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = (o & 2) ? u[k + 2] : u[k];
#pragma unroll
    for (int k = 0; k < 5; ++k) x[k] = (o & 1) ? v[k + 1] : v[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // (x[k] >> sh) | (x[k + 1] << (32 - sh)), defined at sh == 0
      const uint32_t win = __funnelshift_r(x[k], x[k + 1], sh);
      if (j0 + k < nw) acc += 8 - __popc(r[k] & win);
    }
  }
  acc += __shfl_xor_sync(FULL, acc, 1);
  acc += __shfl_xor_sync(FULL, acc, 2);
  if (live && t == 0) d[g] = acc;
}

}  // namespace

extern "C" int popcount_compare_launch(const void* genome32, int64_t n_gw,
                                       const void* pos, const void* pk,
                                       int nw_words, const void* b_of,
                                       const void* nw_of, void* d, int64_t G,
                                       void* stream) {
  const int threads = 256;  // 64 candidates per block
  const int64_t blocks = (4 * G + threads - 1) / threads;
  popcount_compare_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(genome32), n_gw,
      static_cast<const int64_t*>(pos), static_cast<const uint32_t*>(pk),
      nw_words, static_cast<const int64_t*>(b_of),
      static_cast<const int32_t*>(nw_of), static_cast<int32_t*>(d), G);
  return static_cast<int>(cudaGetLastError());
}
