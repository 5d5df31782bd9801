// Native host-side helpers for abismal-tpu.
//
// This library implements the sequential host-side hot loops that are not
// worth expressing as TPU programs: the deterministic N-replacement LCG, the
// windowed seed-selection DP used during index construction, and the WGBS
// read simulator (bit-compatible with `abismal sim`, including its use of
// std::mt19937 and the libstdc++ uniform distribution mappings, which are
// re-implemented explicitly here so output does not depend on the host's C++
// standard library).
//
// Reference semantics: src/AbismalIndex.hpp:39-64 (LCG),
// src/AbismalIndex.cpp:643-855 (compress_dp), src/simreads.cpp (simulator).
//
// Built as a plain shared library; accessed from Python via ctypes.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <atomic>
#include <thread>
#include <vector>

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Deterministic LCG random bases: x <- (1103515245*x + 12345) & (2^31 - 1),
// emitting "ACGT"[x & 3].  Returns the final state.
// ---------------------------------------------------------------------------
uint32_t
lcg_random_bases(uint32_t state, int64_t n, uint8_t *out) {
  static const char bases[4] = {'A', 'C', 'G', 'T'};
  for (int64_t i = 0; i < n; ++i) {
    state = (1103515245u * state + 12345u) & 0x7fffffffu;
    out[i] = static_cast<uint8_t>(bases[state & 3u]);
  }
  return state;
}

// ---------------------------------------------------------------------------
// One-pass genome cleaning (AbismalIndex.cpp:125-175): finds maximal 'N'
// runs; runs longer than max_n_count become exclude intervals (bases left
// untouched), shorter runs are replaced in place with the deterministic
// LCG stream (seed 1, advanced once per replaced base in increasing
// position order) -- identical to contiguous_n + replace_included_n over
// GB-scale numpy temporaries, without the temporaries.  Writes up to
// `cap` exclude intervals into exc_s/exc_e; returns the interval count
// (call again with a bigger cap if it exceeds cap).
// ---------------------------------------------------------------------------
int64_t
index_clean_genome(uint8_t *genome, int64_t n, int64_t max_n_count,
                   int64_t *exc_s, int64_t *exc_e, int64_t cap) {
  static const char bases[4] = {'A', 'C', 'G', 'T'};
  uint32_t state = 1;
  int64_t n_exc = 0;
  int64_t i = 0;
  while (i < n) {
    if (genome[i] != 'N') {
      // skip non-N quickly (memchr finds the next run start)
      const void *p = memchr(genome + i, 'N', (size_t)(n - i));
      if (!p)
        break;
      i = (const uint8_t *)p - genome;
    }
    int64_t j = i;
    while (j < n && genome[j] == 'N')
      ++j;
    if (j - i > max_n_count) {
      if (n_exc < cap) {
        exc_s[n_exc] = i;
        exc_e[n_exc] = j;
      }
      ++n_exc;
    }
    else {
      for (int64_t k = i; k < j; ++k) {
        state = (1103515245u * state + 12345u) & 0x7fffffffu;
        genome[k] = (uint8_t)bases[state & 3u];
      }
    }
    i = j;
  }
  return n_exc;
}

// ---------------------------------------------------------------------------
// Fused genome encode + pack (dna_four_bit_bisulfite.hpp:169-187): ASCII ->
// per-base nibbles AND 16-base/u64 packed words in one threaded pass (the
// numpy table-gather + strided packing costs several genome-sized
// temporaries and strided stores at hg38 scale).  The caller passes the
// table (utils/dna.py ENCODE_GENOME) so the quirk source of truth stays in
// one place.  words_out has ceil(n/16) entries; tail nibbles are zero.
// ---------------------------------------------------------------------------
void
encode_pack_genome(const uint8_t *ascii, int64_t n, const uint8_t *table,
                   uint8_t *nib_out, uint64_t *words_out, int n_threads) {
  const int64_t n_words = (n + 15) / 16;
  if (n_threads < 1)
    n_threads = 1;
  std::vector<std::thread> ts;
  std::atomic<int64_t> next(0);
  const int64_t block_w = 1 << 18;  // words per work unit (4 Mb of genome)
  auto worker = [&]() {
    for (;;) {
      const int64_t bw = next.fetch_add(1);
      const int64_t w0 = bw * block_w;
      if (w0 >= n_words)
        return;
      const int64_t w1 = std::min(n_words, w0 + block_w);
      for (int64_t w = w0; w < w1; ++w) {
        const int64_t base = w * 16;
        const int64_t lim = std::min<int64_t>(16, n - base);
        uint64_t word = 0;
        for (int64_t k = 0; k < lim; ++k) {
          const uint8_t v = table[ascii[base + k]];
          nib_out[base + k] = v;
          word |= (uint64_t)v << (4 * k);
        }
        words_out[w] = word;
      }
    }
  };
  for (int t = 0; t < n_threads; ++t)
    ts.emplace_back(worker);
  for (auto &t : ts)
    t.join();
}

// ---------------------------------------------------------------------------
// Windowed seed-selection DP ("compress"): for each block, minimize the
// total expected candidate cost subject to every window of `window`
// consecutive positions keeping at least one indexed position.
//
//   opt[p] = c[p]                                   for p < window
//   opt[p] = c[p] + min_{q in [p-window, p-1]} opt[q]   otherwise,
// with prev[p] = the smallest q attaining the window minimum; traceback
// starts from the largest p in the final window with the strictly smallest
// cost, and marks the chain into keep[].
//
// Hash keys are recomputed per block with the same truncated spool the
// reference uses so small blocks produce identical costs.
// ---------------------------------------------------------------------------

static const uint32_t KEY_WEIGHT = 25;
static const uint32_t KEY_WEIGHT_THREE = 16;
static const uint32_t HASH_MASK = (1u << 25) - 1;
static const uint32_t HASH_MASK_THREE = 43046721u;  // 3^16

static inline uint32_t
nib_bit(const uint8_t n) {
  return (n & 5u) == 0 ? 1u : 0u;
}
static inline uint32_t
nib_three_ct(const uint8_t n) {
  return ((((n & 4u) != 0) << 1) | ((n & 1u) != 0));
}
static inline uint32_t
nib_three_ga(const uint8_t n) {
  return ((((n & 8u) != 0) << 1) | ((n & 2u) != 0));
}

void
compress_dp_blocks(const uint8_t *nib,    // genome nibbles, full length
                   const uint32_t *counter, const uint32_t *counter_t,
                   const uint32_t *counter_a,
                   const uint8_t *itl,    // is_two_letter per position
                   const int64_t *block_starts, const int64_t *block_ends,
                   int64_t n_blocks, uint32_t window, uint8_t *keep) {
  const uint64_t SENTINEL = std::numeric_limits<uint64_t>::max();
  std::vector<uint64_t> opt;
  std::vector<uint64_t> prev;
  std::vector<uint64_t> qidx;  // deque of candidate indices
  std::vector<uint64_t> qcost;

  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t bs = block_starts[b];
    const int64_t be = block_ends[b];
    const uint64_t cbs = static_cast<uint64_t>(be - bs);
    if (cbs < window)
      continue;

    opt.assign(cbs, 0);
    prev.assign(cbs, SENTINEL);

    // spool hashes; the two-letter spool is truncated to the block size
    // (AbismalIndex.cpp:762-766), the three-letter spool is not (:771-777)
    uint32_t h2 = 0, ht = 0, ha = 0;
    const uint64_t m2 = std::min<uint64_t>(cbs, KEY_WEIGHT - 1);
    for (uint64_t j = 0; j < m2; ++j)
      h2 = ((h2 << 1) | nib_bit(nib[bs + j])) & HASH_MASK;
    for (uint64_t j = 0; j < KEY_WEIGHT_THREE - 1; ++j) {
      const uint8_t x = nib[bs + j];
      ht = (ht * 3 + nib_three_ct(x)) % HASH_MASK_THREE;
      ha = (ha * 3 + nib_three_ga(x)) % HASH_MASK_THREE;
    }

    // monotone deque over a sliding window of opt values
    uint64_t qf = 0, qb = 0;  // [qf, qb) into qidx/qcost
    qidx.assign(cbs + 1, 0);
    qcost.assign(cbs + 1, 0);

    // lookahead rollers D positions ahead prefetch the random count reads
    // (same spool rules as the main rollers, advanced D extra steps)
    const uint64_t D = 16;
    uint32_t h2f = h2, htf = ht, haf = ha;
    uint64_t i2f = m2, i3f = KEY_WEIGHT_THREE - 1;
    for (uint64_t j = 0; j < std::min<uint64_t>(D, cbs); ++j) {
      h2f = ((h2f << 1) | nib_bit(nib[bs + i2f++])) & HASH_MASK;
      const uint8_t xf = nib[bs + i3f++];
      htf = (htf * 3 + nib_three_ct(xf)) % HASH_MASK_THREE;
      haf = (haf * 3 + nib_three_ga(xf)) % HASH_MASK_THREE;
    }

    uint64_t i2 = m2;                      // next two-letter symbol offset
    uint64_t i3 = KEY_WEIGHT_THREE - 1;    // next three-letter symbol offset
    for (uint64_t p = 0; p < cbs; ++p) {
      if (p + D < cbs) {
        h2f = ((h2f << 1) | nib_bit(nib[bs + i2f++])) & HASH_MASK;
        const uint8_t xf = nib[bs + i3f++];
        htf = (htf * 3 + nib_three_ct(xf)) % HASH_MASK_THREE;
        haf = (haf * 3 + nib_three_ga(xf)) % HASH_MASK_THREE;
        if (itl[bs + p + D]) {
          __builtin_prefetch(counter + h2f);
        }
        else {
          __builtin_prefetch(counter_t + htf);
          __builtin_prefetch(counter_a + haf);
        }
      }
      h2 = ((h2 << 1) | nib_bit(nib[bs + i2++])) & HASH_MASK;
      const uint8_t x3 = nib[bs + i3++];
      ht = (ht * 3 + nib_three_ct(x3)) % HASH_MASK_THREE;
      ha = (ha * 3 + nib_three_ga(x3)) % HASH_MASK_THREE;

      const uint64_t c =
        itl[bs + p] ? static_cast<uint64_t>(counter[h2])
                    : (static_cast<uint64_t>(counter_t[ht]) + counter_a[ha]) >> 1;

      if (p < window) {
        opt[p] = c;
        prev[p] = SENTINEL;
      }
      else {
        // window minimum over [p-window, p-1]; deque front is the earliest
        // index attaining it
        opt[p] = qcost[qf] + c;
        prev[p] = qidx[qf];
      }
      // push (p, opt[p]) keeping costs non-decreasing front to back;
      // strict '>' keeps the earliest index among equal minima in front
      while (qb > qf && qcost[qb - 1] > opt[p])
        --qb;
      qidx[qb] = p;
      qcost[qb] = opt[p];
      ++qb;
      // expire indices that fall out of the window for position p+1
      while (qidx[qf] + window <= p)
        ++qf;
    }

    // traceback start: among the last `window` positions, the smallest
    // cost, with the largest index winning ties (descending scan with
    // strict '<', AbismalIndex.cpp:827-836)
    uint64_t best_cost = SENTINEL;
    uint64_t last = SENTINEL;
    for (uint64_t p = cbs - 1; p + window >= cbs && p != SENTINEL; --p) {
      if (opt[p] < best_cost) {
        best_cost = opt[p];
        last = p;
      }
      if (p == 0)
        break;
    }

    uint64_t cur = last;
    while (cur != SENTINEL) {
      keep[bs + cur] = 1;
      cur = prev[cur];
    }
  }
}

// ---------------------------------------------------------------------------
// Banded local alignment (score-only and with traceback), equivalent to the
// reference's AbismalAlign (src/AbismalAlign.hpp:320-440): int16 scores,
// zero floor, band rows of width `bandwidth` stored flat with stride
// `bandwidth`, three update moves applied in order diagonal / from-above /
// from-left with from-left reading already-updated cells, traceback symbols
// overwritten on score ties in that same order.
// ---------------------------------------------------------------------------

namespace {
const int16_t ALN_MATCH = 2;
const int16_t ALN_MISMATCH = -3;
const int16_t ALN_INDEL = -4;
const int8_t OP_M = 0;
const int8_t OP_I = 1;
const int8_t OP_D = 2;
const int8_t OP_S = 4;
}  // namespace

extern "C++" {

static int16_t
banded_align_impl(const uint8_t *gnib, const uint8_t *q, const int64_t q_sz,
                  const int64_t t_pos, const int64_t bw, int16_t *table,
                  int8_t *tb, const bool do_tb) {
  const int64_t t_shift = q_sz + bw;
  const int64_t n_cells = t_shift * bw;
  std::memset(table, 0, n_cells * sizeof(int16_t));
  if (do_tb)
    std::memset(tb, -1, n_cells);

  const int64_t t_beg = t_pos - ((bw - 1) / 2);
  const uint8_t *t_itr = gnib + t_beg;

  for (int64_t i = 1; i < t_shift; ++i) {
    const int64_t left = (i < bw) ? bw - i : 0;
    const int64_t right = std::min<int64_t>(bw, t_shift - i);
    int16_t *cur = table + i * bw;
    const int16_t *prev = cur - bw;
    int8_t *trow = do_tb ? tb + i * bw : nullptr;
    const uint8_t ref_base = t_itr[i - 1];
    const int64_t q0 = i - bw;
    // diagonal
    for (int64_t j = left; j < right; ++j) {
      const int16_t sub = (q[q0 + j] & ref_base) ? ALN_MATCH : ALN_MISMATCH;
      const int16_t score = static_cast<int16_t>(prev[j] + sub);
      if (score > cur[j])
        cur[j] = score;
      if (do_tb && cur[j] == score)
        trow[j] = OP_M;
    }
    // from above (deletion)
    for (int64_t j = left; j + 1 < right; ++j) {
      const int16_t score = static_cast<int16_t>(prev[j + 1] + ALN_INDEL);
      if (score > cur[j])
        cur[j] = score;
      if (do_tb && cur[j] == score)
        trow[j] = OP_D;
    }
    // from left (insertion; reads updated cells)
    for (int64_t j = left + 1; j < right; ++j) {
      const int16_t score = static_cast<int16_t>(cur[j - 1] + ALN_INDEL);
      if (score > cur[j])
        cur[j] = score;
      if (do_tb && cur[j] == score)
        trow[j] = OP_I;
    }
  }

  int16_t best = 0;
  for (int64_t k = 0; k < n_cells; ++k)
    if (table[k] > best)
      best = table[k];
  return best;
}

}  // extern "C++"

extern "C" {

// Score-only banded alignment.  scratch must hold (q_sz + bw) * bw int16.
int16_t
banded_align_score(const uint8_t *genome_nib, const uint8_t *qseq,
                   int64_t q_sz, int64_t t_pos, int64_t bandwidth,
                   int16_t *scratch) {
  return banded_align_impl(genome_nib, qseq, q_sz, t_pos, bandwidth, scratch,
                           nullptr, false);
}

// Alignment with traceback -> BAM cigar ops.  Returns the number of cigar
// ops written; outputs aligned length and the updated t_pos.
// (AbismalAlign.hpp:388-440)
int64_t
banded_align_traceback(const uint8_t *genome_nib, const uint8_t *qseq,
                       int64_t q_sz, int64_t t_pos, int64_t bandwidth,
                       int16_t *scratch, int8_t *tb_scratch,
                       uint32_t *cigar_out, int64_t *aln_len_out,
                       int64_t *t_pos_out, int16_t *score_out) {
  const int64_t bw = bandwidth;
  const int16_t r = banded_align_impl(genome_nib, qseq, q_sz, t_pos, bw,
                                      scratch, tb_scratch, true);
  *score_out = r;
  const int64_t t_shift = q_sz + bw;
  const int64_t n_cells = t_shift * bw;
  // argmax in flat order (first max wins)
  int64_t best_cell = 0;
  int16_t best = -1;
  for (int64_t k = 0; k < n_cells; ++k)
    if (scratch[k] > best) {
      best = scratch[k];
      best_cell = k;
    }
  if (r == 0) {
    cigar_out[0] = static_cast<uint32_t>(q_sz) << 4;  // '<len>M'
    *aln_len_out = q_sz;
    *t_pos_out = t_pos;
    return 1;
  }
  int64_t the_row = best_cell / bw;
  int64_t the_col = best_cell % bw;
  const int64_t soft_clip_bottom = (q_sz + bw - 1) - (the_row + the_col);

  // traceback walk (AbismalAlign.hpp:166-193)
  int64_t n_ops = 0;
  int8_t prev_arrow = tb_scratch[the_row * bw + the_col];
  bool is_del = prev_arrow == OP_D;
  bool is_ins = prev_arrow == OP_I;
  the_row -= is_ins ? 0 : 1;
  the_col -= is_ins ? 1 : 0;
  the_col += is_del ? 1 : 0;
  uint32_t n = 1;
  while (scratch[the_row * bw + the_col] > 0) {
    const int8_t arrow = tb_scratch[the_row * bw + the_col];
    is_del = arrow == OP_D;
    is_ins = arrow == OP_I;
    the_row -= is_ins ? 0 : 1;
    the_col -= is_ins ? 1 : 0;
    the_col += is_del ? 1 : 0;
    if (arrow != prev_arrow) {
      cigar_out[n_ops++] = (n << 4) | static_cast<uint32_t>(prev_arrow);
      n = 0;
    }
    ++n;
    prev_arrow = arrow;
  }
  cigar_out[n_ops++] = (n << 4) | static_cast<uint32_t>(prev_arrow);

  const int64_t soft_clip_top = (the_row + the_col) - (bw - 1);
  if (soft_clip_top > 0)
    cigar_out[n_ops++] =
      (static_cast<uint32_t>(soft_clip_top) << 4) | OP_S;
  std::reverse(cigar_out, cigar_out + n_ops);
  if (soft_clip_bottom > 0)
    cigar_out[n_ops++] =
      (static_cast<uint32_t>(soft_clip_bottom) << 4) | OP_S;

  *aln_len_out = q_sz - soft_clip_bottom - soft_clip_top;
  *t_pos_out = (t_pos - ((bw - 1) / 2)) + the_row;
  return n_ops;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MT19937 (32-bit Mersenne Twister, standard algorithm) plus the libstdc++
// mappings for uniform_int_distribution<uint64_t> over the full range and
// uniform_real_distribution<double> over [0,1) (generate_canonical with two
// 32-bit draws), reproduced explicitly for cross-platform determinism.
// ---------------------------------------------------------------------------
struct MT19937 {
  uint32_t mt[624];
  int idx;

  explicit MT19937(uint32_t seed) {
    mt[0] = seed;
    for (int i = 1; i < 624; ++i)
      mt[i] = 1812433253u * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i;
    idx = 624;
  }

  void
  refill() {
    for (int i = 0; i < 624; ++i) {
      const uint32_t y = (mt[i] & 0x80000000u) | (mt[(i + 1) % 624] & 0x7fffffffu);
      uint32_t next = mt[(i + 397) % 624] ^ (y >> 1);
      if (y & 1u)
        next ^= 0x9908b0dfu;
      mt[i] = next;
    }
    idx = 0;
  }

  uint32_t
  next32() {
    if (idx >= 624)
      refill();
    uint32_t y = mt[idx++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }

  // std::uniform_int_distribution<uint64_t> over [0, 2^64-1] from a 32-bit
  // engine: high word drawn first, then low word
  uint64_t
  next64() {
    const uint64_t hi = next32();
    const uint64_t lo = next32();
    return (hi << 32) | lo;
  }

  // std::uniform_real_distribution<double> over [0,1):
  // generate_canonical<double,53>: sum = lo + hi*2^32, result sum / 2^64
  double
  next_double() {
    const double r = 4294967296.0;  // 2^32
    double sum = 0.0, tmp = 1.0;
    sum += static_cast<double>(next32()) * tmp;
    tmp *= r;
    sum += static_cast<double>(next32()) * tmp;
    tmp *= r;
    double ret = sum / tmp;
    if (ret >= 1.0)
      ret = std::nextafter(1.0, 0.0);
    return ret;
  }
};

// ---------------------------------------------------------------------------
// WGBS read simulator (parity with `abismal sim`, src/simreads.cpp).
// ---------------------------------------------------------------------------

namespace {

struct SimRng {
  MT19937 mt;
  uint32_t lcg{1};

  explicit SimRng(uint64_t seed) : mt(static_cast<uint32_t>(seed)) {}

  uint64_t
  rand_int() {
    return mt.next64();
  }
  double
  rand_double() {
    return mt.next_double();
  }
  char
  random_base() {
    lcg = (1103515245u * lcg + 12345u) & 0x7fffffffu;
    return "ACGT"[lcg & 3u];
  }
};

inline char
complement(const char c) {
  switch (c) {
  case 'A': return 'T';
  case 'C': return 'G';
  case 'G': return 'C';
  case 'T': return 'A';
  default: return 'N';
  }
}

inline std::string
revcomp(const std::string &s) {
  std::string t(s.rbegin(), s.rend());
  for (auto &c : t)
    c = complement(c);
  return t;
}

struct CigarOp {
  uint32_t len;
  char op;
};

inline std::vector<CigarOp>
parse_cigar(const std::string &c) {
  std::vector<CigarOp> ops;
  uint32_t n = 0;
  for (const char ch : c) {
    if (ch >= '0' && ch <= '9')
      n = n * 10 + (ch - '0');
    else {
      ops.push_back({n, ch});
      n = 0;
    }
  }
  return ops;
}

inline std::string
unparse_cigar(const std::vector<CigarOp> &ops) {
  std::string r;
  for (const auto &o : ops) {
    r += std::to_string(o.len);
    r += o.op;
  }
  return r;
}

inline bool
consumes_query(const char op) {
  return op == 'M' || op == 'I' || op == 'S' || op == '=' || op == 'X';
}

inline std::string
truncate_cigar_q(const std::string &c, const uint32_t n_ops) {
  std::vector<CigarOp> out;
  uint32_t q = 0;
  for (const auto &o : parse_cigar(c)) {
    if (q >= n_ops)
      break;
    if (consumes_query(o.op)) {
      const uint32_t take = std::min(o.len, n_ops - q);
      q += take;
      if (take)
        out.push_back({take, o.op});
      if (q >= n_ops)
        break;
    }
    else
      out.push_back(o);
  }
  return unparse_cigar(out);
}

inline std::string
reverse_cigar(const std::string &c) {
  auto ops = parse_cigar(c);
  std::reverse(ops.begin(), ops.end());
  return unparse_cigar(ops);
}

inline std::string
merge_equal_neighbors(const std::string &c) {
  std::vector<CigarOp> out;
  for (const auto &o : parse_cigar(c)) {
    if (!out.empty() && out.back().op == o.op)
      out.back().len += o.len;
    else
      out.push_back(o);
  }
  return unparse_cigar(out);
}

}  // namespace

// Runs the full simulation, writing read1/read2/loc files.  Returns 0 on
// success.  `chrom_names` is a '\n'-joined list aligned with chrom_starts.
int
simreads_native(const uint8_t *genome, int64_t genome_size,
                const uint32_t *chrom_starts, int64_t n_chroms,
                const char *chrom_names_joined, int64_t n_reads,
                int64_t read_length, int64_t min_frag, int64_t max_frag,
                char strand_code, int pbat, int random_pbat,
                int require_valid, double mutation_rate, double sub_rate,
                double ins_rate, double del_rate, double bs_conv,
                uint64_t seed, int single_end, int fasta_format,
                int show_cigar_matches, const char *read1_path,
                const char *read2_path, const char *loc_path) {
  // normalize change-type rates (simreads.cpp:351-362)
  {
    const double total = std::max(sub_rate + ins_rate + del_rate,
                                  std::numeric_limits<double>::min());
    sub_rate /= total;
    ins_rate /= total;
    del_rate /= total;
    ins_rate += sub_rate;
    del_rate += ins_rate;
  }

  std::vector<std::string> names;
  {
    std::string blob(chrom_names_joined);
    size_t p = 0;
    while (p <= blob.size() && static_cast<int64_t>(names.size()) < n_chroms) {
      size_t e = blob.find('\n', p);
      if (e == std::string::npos)
        e = blob.size();
      names.push_back(blob.substr(p, e - p));
      p = e + 1;
    }
  }

  SimRng rng(seed);

  FILE *f1 = std::fopen(read1_path, "w");
  if (!f1)
    return 1;
  FILE *f2 = nullptr;
  if (!single_end) {
    f2 = std::fopen(read2_path, "w");
    if (!f2) {
      std::fclose(f1);
      return 1;
    }
  }
  FILE *floc = nullptr;
  if (loc_path && loc_path[0]) {
    floc = std::fopen(loc_path, "w");
    if (!floc) {
      std::fclose(f1);
      if (f2)
        std::fclose(f2);
      return 1;
    }
  }

  const char *gc = reinterpret_cast<const char *>(genome);

  for (int64_t r = 0; r < n_reads; ++r) {
    // --- sample fragment (simreads.cpp:272-348) ---
    int64_t frag_len = min_frag;
    if (max_frag > min_frag)
      frag_len = min_frag + static_cast<int64_t>(
                              rng.rand_int() %
                              static_cast<uint64_t>(max_frag - min_frag));
    const uint64_t lim = static_cast<uint64_t>(genome_size - frag_len + 1);
    uint64_t posn = rng.rand_int() % lim;
    std::string seq(gc + posn, gc + posn + frag_len);
    // --require-valid resampling loop: the reference re-draws while the
    // fragment consists entirely of valid (ACGT) bases -- the condition
    // reads inverted upstream, and the RNG consumption is observable, so
    // it is reproduced verbatim (simreads.cpp:276-291)
    while (require_valid
           && std::all_of(seq.begin(), seq.end(), [](char c) {
                c = static_cast<char>(std::toupper(
                  static_cast<unsigned char>(c)));
                return c == 'A' || c == 'C' || c == 'G' || c == 'T';
              })) {
      posn = rng.rand_int() % lim;
      seq.assign(gc + posn, gc + posn + frag_len);
    }

    // chrom lookup: upper_bound(starts, pos) - 1
    int64_t ci = 0;
    {
      int64_t lo = 0, hi = n_chroms + 1;  // starts has n_chroms+1 entries
      while (lo < hi) {
        const int64_t mid = (lo + hi) / 2;
        if (chrom_starts[mid] <= posn)
          lo = mid + 1;
        else
          hi = mid;
      }
      ci = lo - 1;
    }
    uint64_t start_pos = posn - chrom_starts[ci];
    const std::string &chrom = names[ci];
    uint64_t end_pos = start_pos + frag_len;
    const std::string name = "read" + std::to_string(r);
    char strand = '+';
    if (strand_code == 'r')
      strand = '-';
    else if (strand_code == 'b')
      strand = (rng.rand_int() & 1u) ? '+' : '-';
    if (strand == '-')
      seq = revcomp(seq);

    // --- mutate (simreads.cpp:350-411) ---
    std::string mseq, ucigar;
    {
      size_t i = 0;
      const std::string orig(seq);
      while (i < orig.size()) {
        char mut = '=';
        const double x = rng.rand_double();
        if (x <= mutation_rate) {
          const double y = rng.rand_double();
          mut = y < sub_rate ? 'M' : (y < ins_rate ? 'I' : 'D');
        }
        if (mut == 'I') {
          ucigar += 'I';
          mseq += rng.random_base();
        }
        else if (mut == 'D') {
          ucigar += 'D';
          ++i;
        }
        else if (mut == 'M') {
          ucigar += 'M';
          mseq += rng.random_base();
          ++i;
        }
        else {
          ucigar += '=';
          mseq += orig[i];
          ++i;
        }
      }
      seq.swap(mseq);
    }
    // compress per-base cigar
    std::string cigar;
    {
      size_t i = 0;
      while (i < ucigar.size()) {
        size_t j = i;
        while (j < ucigar.size() && ucigar[j] == ucigar[i])
          ++j;
        cigar += std::to_string(j - i);
        cigar += ucigar[i];
        i = j;
      }
    }

    // --- bisulfite conversion (simreads.cpp:161-175) ---
    {
      bool a_rich = false;
      if (pbat)
        a_rich = true;
      else if (random_pbat)
        a_rich = rng.rand_double() < 0.5;
      const char from = a_rich ? 'G' : 'C';
      const char to = a_rich ? 'A' : 'T';
      for (auto &c : seq)
        if (c == from && rng.rand_double() < bs_conv)
          c = to;
    }

    if (!show_cigar_matches) {
      std::string c(cigar);
      for (auto &ch : c)
        if (ch == '=')
          ch = 'M';
      cigar = merge_equal_neighbors(c);
    }

    // --- ground-truth locations line (simreads.cpp:203-270) ---
    if (floc) {
      const bool rc = strand == '-';
      const uint16_t fl_read = 0x1 | 0x2 | 0x40 | (rc ? 0x10 : 0x20);
      const uint16_t fl_mate = 0x1 | 0x2 | 0x80 | (rc ? 0x20 : 0x10);
      const uint64_t read_pos = start_pos + 1;
      const uint64_t mate_pos = end_pos - read_length + 1;
      const int64_t tlen = rc ? -static_cast<int64_t>(seq.size())
                              : static_cast<int64_t>(seq.size());
      std::string cigar1 = truncate_cigar_q(cigar, read_length);
      std::string cigar2 = truncate_cigar_q(reverse_cigar(cigar), read_length);
      if (rc)
        cigar1 = reverse_cigar(cigar1);
      else
        cigar2 = reverse_cigar(cigar2);
      const std::string seq1 = seq.substr(0, std::min<size_t>(seq.size(), read_length));
      const std::string rcseq = revcomp(seq);
      const std::string seq2 = rcseq.substr(0, std::min<size_t>(rcseq.size(), read_length));
      const uint64_t pos1 = rc ? mate_pos : read_pos;
      const uint64_t pos2 = rc ? read_pos : mate_pos;
      std::fprintf(floc,
                   "%s.1\t%u\t%s\t%llu\t255\t%s\t=\t%llu\t%lld\t%s\t*\n"
                   "%s.2\t%u\t%s\t%llu\t255\t%s\t=\t%llu\t%lld\t%s\t*\n",
                   name.c_str(), fl_read, chrom.c_str(),
                   static_cast<unsigned long long>(pos1), cigar1.c_str(),
                   static_cast<unsigned long long>(pos2),
                   static_cast<long long>(tlen), seq1.c_str(), name.c_str(),
                   fl_mate, chrom.c_str(),
                   static_cast<unsigned long long>(pos2), cigar2.c_str(),
                   static_cast<unsigned long long>(pos1),
                   static_cast<long long>(-tlen), seq2.c_str());
    }

    // --- emit reads (simreads.cpp:113-133) ---
    {
      std::string read = seq.substr(0, std::min<size_t>(seq.size(), read_length));
      // NB: the bound is re-evaluated as the read grows, so only about half
      // of the missing length is filled -- reference behavior
      // (simreads.cpp:115-118)
      for (int64_t i = 0; i < read_length - static_cast<int64_t>(read.size());
           ++i)
        read += rng.random_base();
      if (fasta_format)
        std::fprintf(f1, ">%s.1\n%s\n", name.c_str(), read.c_str());
      else
        std::fprintf(f1, "@%s.1\n%s\n+\n%s\n", name.c_str(), read.c_str(),
                     std::string(read.size(), 'B').c_str());
    }
    if (!single_end) {
      std::string read = revcomp(seq);
      read = read.substr(0, std::min<size_t>(read.size(), read_length));
      for (int64_t i = 0; i < read_length - static_cast<int64_t>(read.size());
           ++i)
        read += rng.random_base();
      if (fasta_format)
        std::fprintf(f2, ">%s.2\n%s\n", name.c_str(), read.c_str());
      else
        std::fprintf(f2, "@%s.2\n%s\n+\n%s\n", name.c_str(), read.c_str(),
                     std::string(read.size(), 'B').c_str());
    }
  }

  std::fclose(f1);
  if (f2)
    std::fclose(f2);
  if (floc)
    std::fclose(floc);
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native index-construction stages (threaded), used by index/build.py for
// large genomes: bucket counting (AbismalIndex.cpp:333-436), two-vs-three
// classification (:471-543), counting-sort bucket fill (:545-641) and
// per-bucket suffix sorting (:905-978).  All stages are streaming scans with
// O(1) temporaries per thread, so hg38-scale genomes build without
// materializing full-genome hash arrays.  Semantics mirror the repo's
// NumPy build path (the oracle), including the interval-end skip quirk.
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

namespace {

const uint32_t IDX_N_BUCKETS_TWO = 1u << 25;
const uint32_t IDX_N_BUCKETS_THREE = 43046721u;
const int IDX_N_SORTING = 256;

// iterate positions skipping exclude intervals [s, e] CLOSED at the end,
// reproducing the reference's lazy iterator advance (the first position
// after an excluded N run is tested against the stale interval and
// silently skipped -- AbismalIndex.cpp:355-364)
struct ExcludeWalker {
  const int64_t *starts, *ends;
  int64_t n;
  int64_t i = 0;
  inline bool skip(int64_t p) {
    while (i < n && p > ends[i])
      ++i;
    return i < n && p >= starts[i] && p <= ends[i];
  }
};

struct Roll2 {
  uint32_t h = 0;
  inline void push(uint8_t nb) { h = ((h << 1) | nib_bit(nb)) & HASH_MASK; }
};
struct Roll3CT {
  uint32_t h = 0;
  inline void push(uint8_t nb) {
    h = (h * 3 + nib_three_ct(nb)) % HASH_MASK_THREE;
  }
};
struct Roll3GA {
  uint32_t h = 0;
  inline void push(uint8_t nb) {
    h = (h * 3 + nib_three_ga(nb)) % HASH_MASK_THREE;
  }
};

// one full-genome rolling scan; calls fn(p, key) for every non-excluded,
// mask-accepted position p in [0, lim)
template <class Roll, class Fn>
void scan_table(const uint8_t *nib, int64_t lim, int64_t warm,
                const int64_t *exc_s, const int64_t *exc_e, int64_t n_exc,
                const uint8_t *keep, const uint8_t *itl, int want_itl,
                Fn fn) {
  ExcludeWalker ex{exc_s, exc_e, n_exc};
  Roll r;
  for (int64_t j = 0; j < warm; ++j)
    r.push(nib[j]);
  for (int64_t p = 0; p < lim; ++p) {
    r.push(nib[p + warm]);
    if (ex.skip(p))
      continue;
    if (keep) {
      if (!keep[p])
        continue;
      if (want_itl >= 0 && (int)itl[p] != want_itl)
        continue;
    }
    fn(p, r.h);
  }
}

// --- chunked suffix keys for the per-bucket sort ---------------------------
// The reference comparators (AbismalIndex.cpp:857-903) walk the two suffixes
// byte by byte; packing 64 two-letter bits / 16 three-letter nibbles into one
// u64 per chunk turns each comparison into contiguous u64 compares, and the
// whole 231/240-symbol suffix into at most 4/15 chunks (almost every bucket
// resolves within chunk 0).

inline uint64_t bitrev64(uint64_t x) {
  x = __builtin_bswap64(x);
  x = ((x & 0xF0F0F0F0F0F0F0F0ULL) >> 4) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
  x = ((x & 0xCCCCCCCCCCCCCCCCULL) >> 2) | ((x & 0x3333333333333333ULL) << 2);
  x = ((x & 0xAAAAAAAAAAAAAAAAULL) >> 1) | ((x & 0x5555555555555555ULL) << 1);
  return x;
}

// symbols [KEY_WEIGHT + 64c, ...): one bit per symbol, symbol 0 at the MSB;
// the final partial chunk pads with 0s (equal padding on both operands)
inline uint64_t suffix_chunk2(const uint8_t *nib, uint32_t p, int c) {
  const int base = (int)KEY_WEIGHT + (c << 6);
  const int lim = IDX_N_SORTING - base < 64 ? IDX_N_SORTING - base : 64;
  const uint8_t *q = nib + p + base;
#if defined(__AVX512BW__)
  const uint64_t m = _mm512_testn_epi8_mask(
      _mm512_loadu_si512((const void *)q), _mm512_set1_epi8(5));
  uint64_t k = bitrev64(m);
  if (lim < 64)
    k &= ~0ULL << (64 - lim);
  return k;
#else
  uint64_t k = 0;
  for (int j = 0; j < lim; ++j)
    k = (k << 1) | (uint64_t)nib_bit(q[j]);
  return k << (64 - lim);
#endif
}

// symbols [KEY_WEIGHT_THREE + 16c, +16): one (nib & mask) nibble per symbol,
// symbol 0 in the top nibble (240 symbols = exactly 15 chunks)
inline uint64_t suffix_chunk3(const uint8_t *nib, uint32_t p, int c,
                              uint8_t mask) {
  const uint8_t *q = nib + p + KEY_WEIGHT_THREE + (c << 4);
  uint64_t k = 0;
  for (int j = 0; j < 16; ++j)
    k = (k << 4) | (uint64_t)(q[j] & mask);
  return k;
}

struct SItem {
  uint64_t key;
  uint32_t pos;
};

// sort items by the suffix starting at chunk c; full-suffix ties end in
// descending position order (== the back-to-front fill order the stable
// reference sort preserves).  std::sort is safe: the (key, pos-desc)
// comparator is a total order at every level, and equal-key runs are
// re-sorted by the next chunk, so only FULL ties keep the pos-desc order.
template <class ChunkF>
void suffix_sort_run(SItem *it, int64_t n, int c, int n_chunks,
                     const ChunkF &chunk) {
  for (int64_t i = 0; i < n; ++i)
    it[i].key = chunk(it[i].pos, c);
  std::sort(it, it + n, [](const SItem &a, const SItem &b) {
    return a.key != b.key ? a.key < b.key : a.pos > b.pos;
  });
  if (c + 1 >= n_chunks)
    return;
  int64_t i = 0;
  while (i < n) {
    int64_t j = i + 1;
    while (j < n && it[j].key == it[i].key)
      ++j;
    if (j - i > 1)
      suffix_sort_run(it + i, j - i, c + 1, n_chunks, chunk);
    i = j;
  }
}

// per-bucket suffix sorts with chunked u64 keys (suffix_chunk2/3), threaded
// over bucket ranges; equal suffixes keep descending position (the fill
// order), matching the reference's stable_sort semantics.
// mode 0: two-letter bit compare; 1: nt & 5; 2: nt & 10
void sort_buckets_chunked(const uint8_t *nib, const uint32_t *counter,
                          int64_t n_buckets, uint32_t *out, int mode,
                          int n_threads) {
  const uint8_t mask = mode == 1 ? 5 : 10;
  const int n_chunks = mode == 0
                           ? (IDX_N_SORTING - (int)KEY_WEIGHT + 63) / 64
                           : (IDX_N_SORTING - (int)KEY_WEIGHT_THREE) / 16;
  auto chunk = [&](uint32_t p, int c) {
    return mode == 0 ? suffix_chunk2(nib, p, c) : suffix_chunk3(nib, p, c, mask);
  };
  const int64_t grab = 1 << 14;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<SItem> scratch;
    for (;;) {
      const int64_t g = next.fetch_add(1);
      const int64_t b0 = g * grab;
      if (b0 >= n_buckets)
        return;
      const int64_t b1 = std::min(n_buckets, b0 + grab);
      for (int64_t b = b0; b < b1; ++b) {
        const uint32_t s = counter[b], e = counter[b + 1];
        const int64_t m = (int64_t)e - s;
        if (m < 2)
          continue;
        if (m == 2) {
          // dominant case: compare the two suffixes chunk by chunk;
          // a full tie keeps the existing descending-position order
          const uint32_t a = out[s], bq = out[s + 1];
          for (int c = 0; c < n_chunks; ++c) {
            const uint64_t ka = chunk(a, c), kb = chunk(bq, c);
            if (ka != kb) {
              if (ka > kb) {
                out[s] = bq;
                out[s + 1] = a;
              }
              break;
            }
          }
          continue;
        }
        if ((int64_t)scratch.size() < m)
          scratch.resize(m);
        for (int64_t i = 0; i < m; ++i)
          scratch[i].pos = out[s + i];
        suffix_sort_run(scratch.data(), m, 0, n_chunks, chunk);
        for (int64_t i = 0; i < m; ++i)
          out[s + i] = scratch[i].pos;
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < std::max(1, n_threads); ++t)
    ts.emplace_back(worker);
  for (auto &t : ts)
    t.join();
}

}  // namespace

extern "C" {

// Bucket counting, one thread per table (the reference's
// initialize_bucket_sizes).  Unmasked pass (keep == null): two-letter over
// [0, lim2), three-letter over [0, lim3).  Masked pass: all tables over
// [0, lim2) with keep && (itl for two-letter / !itl for three-letter),
// exactly like the NumPy build's kept2/kept3 selections.
void
index_count_hashes(const uint8_t *nib, int64_t n, const int64_t *exc_s,
                   const int64_t *exc_e, int64_t n_exc, const uint8_t *keep,
                   const uint8_t *itl, uint32_t *cnt2, uint32_t *cnt3t,
                   uint32_t *cnt3a) {
  const int64_t lim2 = n - KEY_WEIGHT + 1;
  const int64_t lim3 = keep ? lim2 : n - KEY_WEIGHT_THREE + 1;
  // each increment is a read-modify-write cache miss into a 128-344 MB
  // array; a FIFO ring defers it 32 keys so the line is prefetched by
  // the time it's touched (sums are commutative, so the deferred order
  // is immaterial)
  struct DeferInc {
    uint32_t *cnt;
    uint32_t ring[32] = {};
    int head = 0, filled = 0;
    inline void add(uint32_t k) {
      __builtin_prefetch(cnt + k, 1);
      if (filled == 32)
        ++cnt[ring[head]];
      else
        ++filled;
      ring[head] = k;
      head = (head + 1) & 31;
    }
    void drain() {
      for (int i = 0; i < filled; ++i)
        ++cnt[ring[(head + 32 - filled + i) & 31]];
    }
  };
  std::thread t1([&]() {
    std::memset(cnt2, 0, sizeof(uint32_t) * (IDX_N_BUCKETS_TWO + 1));
    DeferInc di{cnt2};
    scan_table<Roll2>(nib, lim2, KEY_WEIGHT - 1, exc_s, exc_e, n_exc, keep,
                      itl, keep ? 1 : -1,
                      [&](int64_t, uint32_t k) { di.add(k); });
    di.drain();
  });
  std::thread t2([&]() {
    std::memset(cnt3t, 0, sizeof(uint32_t) * (IDX_N_BUCKETS_THREE + 1));
    DeferInc di{cnt3t};
    scan_table<Roll3CT>(nib, lim3, KEY_WEIGHT_THREE - 1, exc_s, exc_e, n_exc,
                        keep, itl, keep ? 0 : -1,
                        [&](int64_t, uint32_t k) { di.add(k); });
    di.drain();
  });
  std::thread t3([&]() {
    std::memset(cnt3a, 0, sizeof(uint32_t) * (IDX_N_BUCKETS_THREE + 1));
    DeferInc di{cnt3a};
    scan_table<Roll3GA>(nib, lim3, KEY_WEIGHT_THREE - 1, exc_s, exc_e, n_exc,
                        keep, itl, keep ? 0 : -1,
                        [&](int64_t, uint32_t k) { di.add(k); });
    di.drain();
  });
  t1.join();
  t2.join();
  t3.join();
}

// Two- vs three-letter classification over the block decomposition
// (AbismalIndex.cpp:471-543): itl[p] = cnt2[k2(p)] <= (ct[k3t(p)] +
// ca[k3a(p)]) >> 1 (the three-letter cost sums in 64 bits), block-parallel.
void
index_select_two_letter(const uint8_t *nib, const uint32_t *cnt2,
                        const uint32_t *cnt3t, const uint32_t *cnt3a,
                        const int64_t *bs, const int64_t *be,
                        int64_t n_blocks, uint8_t *itl, int n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= n_blocks)
        return;
      Roll2 r2, r2f;
      Roll3CT rt, rtf;
      Roll3GA ra, raf;
      const int64_t s = bs[b], e = be[b];
      for (int64_t j = s; j < s + KEY_WEIGHT - 1; ++j)
        r2.push(nib[j]);
      for (int64_t j = s; j < s + KEY_WEIGHT_THREE - 1; ++j) {
        rt.push(nib[j]);
        ra.push(nib[j]);
      }
      // lookahead rollers D positions ahead prefetch the three random
      // count reads (the stage is otherwise one cache miss per read)
      const int64_t D = 16;
      if (e - s > D) {
        for (int64_t j = s + D; j < s + D + KEY_WEIGHT - 1; ++j)
          r2f.push(nib[j]);
        for (int64_t j = s + D; j < s + D + KEY_WEIGHT_THREE - 1; ++j) {
          rtf.push(nib[j]);
          raf.push(nib[j]);
        }
      }
      for (int64_t p = s; p < e; ++p) {
        if (p + D < e) {
          r2f.push(nib[p + D + KEY_WEIGHT - 1]);
          rtf.push(nib[p + D + KEY_WEIGHT_THREE - 1]);
          raf.push(nib[p + D + KEY_WEIGHT_THREE - 1]);
          __builtin_prefetch(cnt2 + r2f.h);
          __builtin_prefetch(cnt3t + rtf.h);
          __builtin_prefetch(cnt3a + raf.h);
        }
        r2.push(nib[p + KEY_WEIGHT - 1]);
        rt.push(nib[p + KEY_WEIGHT_THREE - 1]);
        ra.push(nib[p + KEY_WEIGHT_THREE - 1]);
        const uint64_t three = ((uint64_t)cnt3t[rt.h] + cnt3a[ra.h]) >> 1;
        itl[p] = (uint64_t)cnt2[r2.h] <= three ? 1 : 0;
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < std::max(1, n_threads); ++t)
    ts.emplace_back(worker);
  for (auto &t : ts)
    t.join();
}

// Block-parallel wrapper over the seed-selection DP (compress_dp_blocks
// above); blocks are independent (AbismalIndex.cpp:738-751).
void
compress_dp_blocks_mt(const uint8_t *nib, const uint32_t *counter,
                      const uint32_t *counter_t, const uint32_t *counter_a,
                      const uint8_t *itl, const int64_t *block_starts,
                      const int64_t *block_ends, int64_t n_blocks,
                      uint32_t window, uint8_t *keep, int n_threads) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= n_blocks)
        return;
      compress_dp_blocks(nib, counter, counter_t, counter_a, itl,
                         block_starts + b, block_ends + b, 1, window, keep);
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < std::max(1, n_threads); ++t)
    ts.emplace_back(worker);
  for (auto &t : ts)
    t.join();
}

// Counting-sort bucket fill + per-bucket suffix sort.  counterX are the
// final prefix arrays (n_buckets + 1); positions are written back-to-front
// (ascending scan into decrementing slots = descending position within a
// bucket), then each bucket is stable_sorted by the reduced-alphabet
// suffix over symbols [key_weight, 256) -- equal suffixes keep descending
// position order, matching the NumPy lexsort oracle and the reference.
void
index_fill_and_sort(const uint8_t *nib, int64_t n, const int64_t *exc_s,
                    const int64_t *exc_e, int64_t n_exc, const uint8_t *keep,
                    const uint8_t *itl, const uint32_t *counter2,
                    const uint32_t *counter3t, const uint32_t *counter3a,
                    uint32_t *index2, uint32_t *index_t, uint32_t *index_a,
                    int n_threads) {
  const int64_t lim2 = n - KEY_WEIGHT + 1;

  auto fill = [&](const uint32_t *counter, int64_t n_buckets, uint32_t *out,
                  int want_itl, auto roll, int64_t warm) {
    std::vector<uint32_t> ctr(counter + 1, counter + n_buckets + 1);
    // FIFO-deferred stores (same trick as the counting pass): prefetch
    // the bucket cursor line 32 keys ahead of the read-modify-write;
    // FIFO order keeps the back-to-front fill order bit-exact
    struct E {
      uint32_t k, p;
    };
    E ring[32];
    int head = 0, filled = 0;
    auto step = [&](int64_t p, uint32_t k) {
      __builtin_prefetch(ctr.data() + k, 1);
      if (filled == 32) {
        const E &e = ring[head];
        out[--ctr[e.k]] = e.p;
      }
      else
        ++filled;
      ring[head] = E{k, (uint32_t)p};
      head = (head + 1) & 31;
    };
    scan_table<decltype(roll)>(
      nib, lim2, warm, exc_s, exc_e, n_exc, keep, itl, want_itl, step);
    for (int i = 0; i < filled; ++i) {
      const E &e = ring[(head + 32 - filled + i) & 31];
      out[--ctr[e.k]] = e.p;
    }
  };

  std::thread f1([&]() {
    fill(counter2, IDX_N_BUCKETS_TWO, index2, 1, Roll2(), KEY_WEIGHT - 1);
  });
  std::thread f2([&]() {
    fill(counter3t, IDX_N_BUCKETS_THREE, index_t, 0, Roll3CT(),
         KEY_WEIGHT_THREE - 1);
  });
  std::thread f3([&]() {
    fill(counter3a, IDX_N_BUCKETS_THREE, index_a, 0, Roll3GA(),
         KEY_WEIGHT_THREE - 1);
  });
  f1.join();
  f2.join();
  f3.join();

  sort_buckets_chunked(nib, counter2, IDX_N_BUCKETS_TWO, index2, 0, n_threads);
  sort_buckets_chunked(nib, counter3t, IDX_N_BUCKETS_THREE, index_t, 1,
                       n_threads);
  sort_buckets_chunked(nib, counter3a, IDX_N_BUCKETS_THREE, index_a, 2,
                       n_threads);
}

// One fused block-parallel scan over [0, lim2): rolls all three hash keys
// at once and captures each kept position's keys into compact arrays
// (k2/p2 where itl, k3t+k3a/p3 where !itl), replacing the masked recount
// scan AND the three fill re-scans of the build's final stage with work
// proportional to the KEPT positions.  Positions come out ascending
// (threads own contiguous ranges), which the placement below relies on.
// Exactness: the rolling hashes are 25-/16-symbol windows (recomputable at
// any block start by warming that many symbols), and ExcludeWalker::skip
// is a pure monotone predicate of p, so block boundaries are invisible.
// Writes the true counts to out_n2/out_n3; the caller allocates from the
// keep/itl population counts (an upper bound: the walker also skips the
// lazy-advance positions the reference's counting loops never see).
// threaded population counts of the kept two-/three-letter positions
// (allocation bounds for the capture below); numpy's boolean-temp
// equivalent costs GB-scale allocations on hosts with slow faulting
void
index_count_kept(const uint8_t *keep, const uint8_t *itl, int64_t lim2,
                 int64_t *out_n2, int64_t *out_n3, int n_threads) {
  const int T = std::max(1, n_threads);
  std::vector<int64_t> c2(T, 0), c3(T, 0);
  auto worker = [&](int t) {
    const int64_t p0 = lim2 * t / T, p1 = lim2 * (t + 1) / T;
    int64_t a = 0, b = 0;
    for (int64_t p = p0; p < p1; ++p) {
      a += keep[p] & itl[p];
      b += keep[p] & (1 - itl[p]);
    }
    c2[t] = a;
    c3[t] = b;
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < T; ++t)
    ts.emplace_back(worker, t);
  for (auto &t : ts)
    t.join();
  *out_n2 = 0;
  *out_n3 = 0;
  for (int t = 0; t < T; ++t) {
    *out_n2 += c2[t];
    *out_n3 += c3[t];
  }
}

void
index_capture_kept(const uint8_t *nib, int64_t n, const int64_t *exc_s,
                   const int64_t *exc_e, int64_t n_exc, const uint8_t *keep,
                   const uint8_t *itl, uint32_t *k2, uint32_t *p2,
                   uint32_t *k3t, uint32_t *k3a, uint32_t *p3,
                   uint32_t *cnt2, uint32_t *cnt3t, uint32_t *cnt3a,
                   int64_t *out_n2, int64_t *out_n3, int n_threads) {
  const int64_t lim2 = n - KEY_WEIGHT + 1;
  const int T = std::max(1, n_threads);
  std::vector<std::vector<uint32_t>> vk2(T), vp2(T), vkt(T), vka(T), vp3(T);
  // keys are recomputed from scratch at each kept position (direct
  // 25-symbol / 16-symbol window reads) rather than rolled at every
  // position: the DP keeps only ~5-8% of positions, so O(kept * window)
  // beats O(genome * 3 rolls), and the keep bitmap is skipped 64 bytes at
  // a time.  The rolling form's value is the last 16 symbols' Horner in
  // base 3 modulo 3^16.  IUPAC genome codes give symbol 3 (R for C->T, Y
  // for G->A, ...), which can carry the Horner past 3^16, so the key takes
  // the modulo here too; unreduced, such a key counted and placed past
  // the end of the bucket tables.
  auto key2_at = [&](int64_t p) {
#if defined(__AVX512BW__) && defined(__AVX512VL__)
    const uint32_t m = _mm256_testn_epi8_mask(
        _mm256_loadu_si256((const __m256i *)(nib + p)),
        _mm256_set1_epi8(5));
    return (uint32_t)(bitrev64(m) >> 39);  // symbol 0 -> bit 24
#else
    uint32_t h = 0;
    for (uint32_t j = 0; j < KEY_WEIGHT; ++j)
      h = (h << 1) | nib_bit(nib[p + j]);
    return h;
#endif
  };
  auto worker = [&](int t) {
    const int64_t p0 = lim2 * t / T, p1 = lim2 * (t + 1) / T;
    if (p0 >= p1)
      return;
    const int64_t cap = (p1 - p0) / 8 + 64;  // DP keeps >=1 per window of 20
    vk2[t].reserve(cap);
    vp2[t].reserve(cap);
    vkt[t].reserve(cap);
    vka[t].reserve(cap);
    vp3[t].reserve(cap);
    ExcludeWalker ex{exc_s, exc_e, n_exc};
    auto emit = [&](int64_t p) {
      if (ex.skip(p))
        return;
      if (itl[p]) {
        vk2[t].push_back(key2_at(p));
        vp2[t].push_back((uint32_t)p);
      }
      else {
        uint32_t ht = 0, ha = 0;
        for (uint32_t j = 0; j < KEY_WEIGHT_THREE; ++j) {
          ht = ht * 3 + nib_three_ct(nib[p + j]);
          ha = ha * 3 + nib_three_ga(nib[p + j]);
        }
        vkt[t].push_back(ht % HASH_MASK_THREE);
        vka[t].push_back(ha % HASH_MASK_THREE);
        vp3[t].push_back((uint32_t)p);
      }
    };
    int64_t p = p0;
#if defined(__AVX512BW__)
    for (; p + 64 <= p1; p += 64) {
      uint64_t km = _mm512_test_epi8_mask(
          _mm512_loadu_si512((const void *)(keep + p)),
          _mm512_set1_epi8(static_cast<char>(0xFF)));
      while (km) {
        const int j = __builtin_ctzll(km);
        km &= km - 1;
        emit(p + j);
      }
    }
#endif
    for (; p < p1; ++p)
      if (keep[p])
        emit(p);
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < T; ++t)
    ts.emplace_back(worker, t);
  for (auto &t : ts)
    t.join();
  int64_t n2 = 0, n3 = 0;
  for (int t = 0; t < T; ++t) {
    std::memcpy(k2 + n2, vk2[t].data(), vk2[t].size() * 4);
    std::memcpy(p2 + n2, vp2[t].data(), vp2[t].size() * 4);
    n2 += (int64_t)vk2[t].size();
    std::memcpy(k3t + n3, vkt[t].data(), vkt[t].size() * 4);
    std::memcpy(k3a + n3, vka[t].data(), vka[t].size() * 4);
    std::memcpy(p3 + n3, vp3[t].data(), vp3[t].size() * 4);
    n3 += (int64_t)vp3[t].size();
  }
  *out_n2 = n2;
  *out_n3 = n3;
  // masked bucket counts from the compact keys (one table per thread,
  // prefetch-ring deferred increments), replacing numpy bincount's
  // int64 casts and temporaries
  auto count = [](const uint32_t *keys, int64_t m, uint32_t *cnt,
                  int64_t n_buckets) {
    std::memset(cnt, 0, sizeof(uint32_t) * (n_buckets + 1));
    uint32_t ring[32];
    int head = 0, filled = 0;
    for (int64_t i = 0; i < m; ++i) {
      const uint32_t k = keys[i];
      __builtin_prefetch(cnt + k, 1);
      if (filled == 32)
        ++cnt[ring[head]];
      else
        ++filled;
      ring[head] = k;
      head = (head + 1) & 31;
    }
    for (int i = 0; i < filled; ++i)
      ++cnt[ring[(head + 32 - filled + i) & 31]];
  };
  std::thread c1([&]() { count(k2, n2, cnt2, IDX_N_BUCKETS_TWO); });
  std::thread c2t([&]() { count(k3t, n3, cnt3t, IDX_N_BUCKETS_THREE); });
  std::thread c3a([&]() { count(k3a, n3, cnt3a, IDX_N_BUCKETS_THREE); });
  c1.join();
  c2t.join();
  c3a.join();
}

// Counting-sort placement from the captured compact arrays (ascending
// position; forward walk into decrementing cursors = descending position
// within each bucket, the reference's fill order), then the chunked
// per-bucket suffix sorts.  counterX are the final prefix arrays.
void
index_place_and_sort(const uint8_t *nib, const uint32_t *k2,
                     const uint32_t *p2, int64_t n2, const uint32_t *k3t,
                     const uint32_t *k3a, const uint32_t *p3, int64_t n3,
                     const uint32_t *counter2, const uint32_t *counter3t,
                     const uint32_t *counter3a, uint32_t *index2,
                     uint32_t *index_t, uint32_t *index_a, int n_threads) {
  // Each table is placed key-range-parallel: every thread walks the whole
  // compact array but only places keys it owns (bucket ranges balanced by
  // position counts via the prefix array), so the random RMW/store work --
  // the expensive part -- splits T ways while the cheap sequential key
  // reads are duplicated.  Within a bucket the walk order is unchanged,
  // so the descending-position fill order is preserved.
  auto place = [n_threads](const uint32_t *keys, const uint32_t *pos,
                           int64_t m, const uint32_t *counter,
                           int64_t n_buckets, uint32_t *out) {
    const int T = std::max(1, n_threads);
    std::vector<uint32_t> kb(T + 1);
    kb[0] = 0;
    kb[T] = (uint32_t)n_buckets;
    for (int t = 1; t < T; ++t) {
      const uint32_t target = (uint32_t)((int64_t)m * t / T);
      kb[t] = (uint32_t)(std::upper_bound(counter, counter + n_buckets + 1,
                                          target) -
                         counter) -
              1;
    }
    auto worker = [&](int t) {
      const uint32_t klo = kb[t], khi = kb[t + 1];
      if (klo >= khi)
        return;
      std::vector<uint32_t> ctr(counter + klo + 1, counter + khi + 1);
      uint32_t *const c0 = ctr.data() - (int64_t)klo - 1;
      // FIFO-deferred store ring: prefetch the bucket cursor line 32 keys
      // ahead of the read-modify-write (FIFO keeps the order bit-exact)
      struct E {
        uint32_t k, p;
      };
      E ring[32];
      int head = 0, filled = 0;
      for (int64_t i = 0; i < m; ++i) {
        const uint32_t k = keys[i];
        if (k < klo || k >= khi)
          continue;
        __builtin_prefetch(c0 + k + 1, 1);
        if (filled == 32) {
          const E &e = ring[head];
          out[--c0[e.k + 1]] = e.p;
        }
        else
          ++filled;
        ring[head] = E{k, pos[i]};
        head = (head + 1) & 31;
      }
      for (int i = 0; i < filled; ++i) {
        const E &e = ring[(head + 32 - filled + i) & 31];
        out[--c0[e.k + 1]] = e.p;
      }
    };
    std::vector<std::thread> ts;
    for (int t = 0; t < T; ++t)
      ts.emplace_back(worker, t);
    for (auto &t : ts)
      t.join();
  };
  place(k2, p2, n2, counter2, IDX_N_BUCKETS_TWO, index2);
  place(k3t, p3, n3, counter3t, IDX_N_BUCKETS_THREE, index_t);
  place(k3a, p3, n3, counter3a, IDX_N_BUCKETS_THREE, index_a);

  sort_buckets_chunked(nib, counter2, IDX_N_BUCKETS_TWO, index2, 0, n_threads);
  sort_buckets_chunked(nib, counter3t, IDX_N_BUCKETS_THREE, index_t, 1,
                       n_threads);
  sort_buckets_chunked(nib, counter3a, IDX_N_BUCKETS_THREE, index_a, 2,
                       n_threads);
}

}  // extern "C"
