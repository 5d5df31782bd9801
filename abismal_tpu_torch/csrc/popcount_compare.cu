// K1: bisulfite-aware popcount Hamming compare, one thread per candidate.
//
// Replaces abismal_tpu/kernels/popcount_compare.py:_body (the Pallas kernel
// called at abismal_tpu/map/pipeline.py:944).  For candidate g at genome
// nibble position pos[g] and read unit b_of[g]:
//
//   d[g] = sum_{j < nw_of[g]} 8 - popc(read_word[b_of[g]][j] & win_word[j])
//
// where win_word[j] is the genome word run starting at word pos >> 3,
// funnel-shifted right by 4 * (pos & 7) bits.  Genome words past the end of
// genome32 read as 0 (the TPU layout's zero guard rows).
//
// Bound on the H100: memory/gather.  Each thread reads nw + 1 genome words
// at a data-dependent address (one 32-byte sector run for the 17 words at
// lmax 128) and the unit's packed read words, which are shared by every
// candidate of the unit and so stay L1/L2-resident.  The design reads
// genome32 directly -- no per-candidate overlapped-row copy and no
// word-alignment log-roll, which were TPU gather workarounds -- and keeps
// only the running pair (lo, hi) of words in registers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void popcount_compare_kernel(const uint32_t* __restrict__ genome32,
                                        int64_t n_gw,
                                        const int64_t* __restrict__ pos,
                                        const uint32_t* __restrict__ pk,
                                        int nw_words,
                                        const int64_t* __restrict__ b_of,
                                        const int32_t* __restrict__ nw_of,
                                        int32_t* __restrict__ d, int64_t G) {
  const int64_t g =
      blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (g >= G) return;
  const uint64_t p = static_cast<uint64_t>(pos[g]) & 0xFFFFFFFFull;
  const int64_t w = static_cast<int64_t>(p >> 3);
  const unsigned sh = static_cast<unsigned>(p & 7) * 4u;
  const uint32_t* rw = pk + b_of[g] * nw_words;
  const int nw = min(nw_of[g], nw_words);
  uint32_t lo = w < n_gw ? __ldg(genome32 + w) : 0u;
  int acc = 0;
  for (int j = 0; j < nw; ++j) {
    const int64_t wi = w + j + 1;
    const uint32_t hi = wi < n_gw ? __ldg(genome32 + wi) : 0u;
    // (lo >> sh) | (hi << (32 - sh)), defined at sh == 0 (returns lo)
    const uint32_t win = __funnelshift_r(lo, hi, sh);
    acc += 8 - __popc(__ldg(rw + j) & win);
    lo = hi;
  }
  d[g] = acc;
}

}  // namespace

extern "C" int popcount_compare_launch(const void* genome32, int64_t n_gw,
                                       const void* pos, const void* pk,
                                       int nw_words, const void* b_of,
                                       const void* nw_of, void* d, int64_t G,
                                       void* stream) {
  const int threads = 256;
  const int64_t blocks = (G + threads - 1) / threads;
  popcount_compare_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(genome32), n_gw,
      static_cast<const int64_t*>(pos), static_cast<const uint32_t*>(pk),
      nw_words, static_cast<const int64_t*>(b_of),
      static_cast<const int32_t*>(nw_of), static_cast<int32_t*>(d), G);
  return static_cast<int>(cudaGetLastError());
}
