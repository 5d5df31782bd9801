// Native batched mapping engine for abismal-tpu: the per-read decide/align/
// format stage of the mapper, plus a full native seeding path used when no
// device events are available (host fallback units, or pure-native engine).
//
// This is a C++ port of the repo's own golden-validated Python engine
// (abismal_tpu/map/{engine,candidates,seeds,align}.py), which in turn
// re-implements the reference semantics: candidate heaps with libstdc++
// heap-order behavior (abismal.cpp:334-449,775-863), the two-phase seeding
// policy (abismal.cpp:1269-1375), the banded aligner (AbismalAlign.hpp:
// 320-440), the PE mating sweep with its stale-score quirk
// (abismal.cpp:1722-1831), and htslib-compatible SAM record formatting
// (abismal.cpp:481-545,648-773).  Batches are processed by a thread pool;
// output is concatenated in read order so results are byte-deterministic at
// any thread count (better than the reference, whose -t>1 output order is
// nondeterministic).
//
// Exposed to Python via ctypes (see native/__init__.py).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <climits>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// constants (mirrors abismal_tpu/constants.py)
// ---------------------------------------------------------------------------
const int KEY_WEIGHT = 25;
const int KEY_WEIGHT_THREE = 16;
#ifdef ABISMAL_SHORT  // ENABLE_SHORT profile (reference configure.ac:69-73)
const int WINDOW_SIZE = 12;
#else
const int WINDOW_SIZE = 20;
#endif
const uint32_t HASH_MASK = (1u << 25) - 1;
const uint32_t HASH3_MOD = 43046721u;  // 3^16
const int MIN_READ_LENGTH = KEY_WEIGHT + WINDOW_SIZE - 1;
const int SE_MAX = 50;
const int PE_MAX_SMALL = 32;
const int PE_MAX_LARGE = 32768;
const double INVALID_HIT_FRAC = 0.4;
const int GOOD_FRAC_DENOM = 10;
const int MIN_FOLD_SIZE = 10;
const int SAME_POS_TOL = 3;
const int32_t MAX_DIFFS = 32767;

const int16_t ALN_MATCH = 2;
const int16_t ALN_MISMATCH = -3;
const int16_t ALN_INDEL = -4;
const int BANDWIDTH = 61;

const uint32_t CIG_M = 0, CIG_I = 1, CIG_D = 2, CIG_S = 4;
// 2-bit consume flags per op (1 = query, 2 = ref)
const uint8_t CIGAR_TYPE[10] = {3, 1, 2, 2, 1, 0, 0, 3, 3, 0};
const char CIGAR_OPS[11] = "MIDNSHP=XB";

const uint32_t F_PAIRED = 0x1, F_PAIR_MAPPED = 0x2, F_RC = 0x10,
               F_MATE_RC = 0x20, F_TFIRST = 0x40, F_TLAST = 0x80,
               F_SECONDARY = 0x100, F_A_RICH = 0x1000;

// nibble helper tables (utils/dna.py)
struct Tables {
  uint8_t enc_t[256];   // T-rich read encoding
  uint8_t enc_a[256];   // A-rich read encoding
  uint8_t rc[256];      // ASCII reverse complement
  uint8_t bit[16];      // two-letter bit of a nibble
  uint8_t srt_ct[16];   // nt & 5
  uint8_t srt_ga[16];   // nt & 10
  uint8_t three_ct[16];
  uint8_t three_ga[16];
  Tables() {
    std::memset(enc_t, 0, 256);
    std::memset(enc_a, 0, 256);
    auto set2 = [](uint8_t *t, char c, uint8_t v) {
      t[(int)c] = v;
      t[(int)(c - 'A' + 'a')] = v;
    };
    set2(enc_t, 'A', 1); set2(enc_t, 'C', 2); set2(enc_t, 'G', 4);
    set2(enc_t, 'T', 10);
    set2(enc_a, 'A', 5); set2(enc_a, 'C', 2); set2(enc_a, 'G', 4);
    set2(enc_a, 'T', 8);
    std::memset(rc, 'N', 256);
    rc[(int)'A'] = 'T'; rc[(int)'T'] = 'A';
    rc[(int)'C'] = 'G'; rc[(int)'G'] = 'C';
    for (int n = 0; n < 16; ++n) {
      bit[n] = ((n & 5) == 0) ? 1 : 0;
      srt_ct[n] = n & 5;
      srt_ga[n] = n & 10;
      three_ct[n] = (((n & 4) != 0) << 1) | ((n & 1) != 0);
      three_ga[n] = (((n & 8) != 0) << 1) | ((n & 2) != 0);
    }
  }
};
const Tables T;

// ---------------------------------------------------------------------------
// candidate elements + libstdc++ heap algorithms (candidates.py)
// ---------------------------------------------------------------------------
struct Elem {
  int32_t d;
  uint32_t f;
  uint32_t p;
};

inline bool elem_empty(const Elem &e) { return e.p == 0; }
inline bool elem_ambig(const Elem &e) { return (e.f & F_SECONDARY) != 0; }
inline void set_ambig(Elem &e) { e.f |= F_SECONDARY; }

// bits/stl_heap.h behavior, comparator: diffs <
static void sift_up(Elem *v, int64_t hole, int64_t top, Elem value) {
  int64_t parent = (hole - 1) / 2;
  while (hole > top && v[parent].d < value.d) {
    v[hole] = v[parent];
    hole = parent;
    parent = (hole - 1) / 2;
  }
  v[hole] = value;
}

static void push_heap(Elem *v, int64_t n) { sift_up(v, n - 1, 0, v[n - 1]); }

static void adjust_heap(Elem *v, int64_t hole, int64_t length, Elem value) {
  const int64_t top = hole;
  int64_t second = hole;
  while (second < (length - 1) / 2) {
    second = 2 * (second + 1);
    if (v[second].d < v[second - 1].d)
      --second;
    v[hole] = v[second];
    hole = second;
  }
  if ((length & 1) == 0 && second == (length - 2) / 2) {
    second = 2 * (second + 1);
    v[hole] = v[second - 1];
    hole = second - 1;
  }
  sift_up(v, hole, top, value);
}

static void pop_heap(Elem *v, int64_t n) {
  if (n > 1) {
    Elem value = v[n - 1];
    v[n - 1] = v[0];
    adjust_heap(v, 0, n - 1, value);
  }
}

// SE candidate set: fixed 50-slot max-heap + exact-match tracking
// (abismal.cpp:334-449)
struct SECand {
  Elem v[SE_MAX];
  int sz = 1;
  Elem best{MAX_DIFFS, 0, 0};
  int32_t cutoff = 0;
  int32_t good_cutoff = 0;
  bool sure_ambig = false;

  SECand() {
    for (int i = 0; i < SE_MAX; ++i)
      v[i] = Elem{MAX_DIFFS, 0, 0};
  }
  void reset(int readlen) {
    // element flags are NOT reset (se_element::reset, abismal.cpp:286-296)
    best.d = (int32_t)(INVALID_HIT_FRAC * readlen);
    best.p = 0;
    v[0].d = (int32_t)(INVALID_HIT_FRAC * readlen);
    v[0].p = 0;
    cutoff = v[0].d;
    good_cutoff = readlen / GOOD_FRAC_DENOM;
    sure_ambig = false;
    sz = 1;
  }
  void reset_plain() {
    best.d = MAX_DIFFS;
    best.p = 0;
    v[0].d = MAX_DIFFS;
    v[0].p = 0;
    cutoff = v[0].d;
    sure_ambig = false;
    sz = 1;
  }
  bool full() const { return sz == SE_MAX; }
  bool has_exact() const { return !elem_empty(best); }
  bool should_do_sensitive() const {
    return !full() || cutoff > good_cutoff;
  }
  void set_specific() { cutoff = good_cutoff; }
  void set_sensitive() { cutoff = v[0].d; }
  void update(bool specific, int32_t d, uint32_t s, uint32_t p) {
    if (d == 0) {
      // update_exact_match (abismal.cpp:347-355)
      if (elem_empty(best))
        best = Elem{0, s, p};
      else if (best.p != p || best.f != s)
        set_ambig(best);
    }
    else {
      if (full()) {
        pop_heap(v, sz);
        v[sz - 1] = Elem{d, s, p};
      }
      else {
        v[sz] = Elem{d, s, p};
        ++sz;
      }
      push_heap(v, sz);
    }
    sure_ambig = elem_ambig(best) && best.d == 0;
    cutoff = specific ? std::min(cutoff, v[0].d) : v[0].d;
  }
  // sort by (pos, flags) stable + dedup (abismal.cpp:429-439)
  int prepare_for_alignments(Elem *out) {
    std::stable_sort(v, v + sz, [](const Elem &a, const Elem &b) {
      return a.p < b.p || (a.p == b.p && a.f < b.f);
    });
    int n = 0;
    for (int i = 0; i < sz; ++i)
      if (n == 0 || out[n - 1].p != v[i].p || out[n - 1].f != v[i].f)
        out[n++] = v[i];
    sz = n;
    return n;
  }
};

// PE candidate set: heap with capacity growing 32 -> 32768
// (abismal.cpp:775-863)
struct PECand {
  std::vector<Elem> v;
  int sz = 1;
  int capacity = PE_MAX_SMALL;
  int32_t cutoff = 0;
  int32_t good_cutoff = 0;
  bool sure_ambig = false;

  PECand() : v(PE_MAX_LARGE, Elem{MAX_DIFFS, 0, 0}) {}
  void reset(int readlen) {
    v[0].d = (int32_t)(INVALID_HIT_FRAC * readlen);
    v[0].p = 0;
    sure_ambig = false;
    cutoff = v[0].d;
    good_cutoff = readlen / GOOD_FRAC_DENOM;
    sz = 1;
    capacity = PE_MAX_SMALL;
  }
  bool full() const { return sz == capacity; }
  bool should_align() const {
    return sz != PE_MAX_LARGE || cutoff != 0;
  }
  bool should_do_sensitive() const {
    return capacity == PE_MAX_SMALL || cutoff > good_cutoff;
  }
  void set_specific() { cutoff = good_cutoff; }
  void set_sensitive() { cutoff = v[0].d; }
  void update(bool specific, int32_t d, uint32_t s, uint32_t p) {
    if (full()) {
      if (specific && capacity != PE_MAX_LARGE && d <= good_cutoff)
        ++capacity;
      else {
        pop_heap(v.data(), sz);
        --sz;
      }
    }
    v[sz] = Elem{d, s, p};
    ++sz;
    push_heap(v.data(), sz);
    cutoff = specific ? std::min(cutoff, v[0].d) : v[0].d;
    sure_ambig = full() && cutoff == 0;
  }
  // sort by pos stable + dedup by (pos, flags) (abismal.cpp:844-852)
  void prepare_for_mating() {
    std::stable_sort(v.begin(), v.begin() + sz,
                     [](const Elem &a, const Elem &b) { return a.p < b.p; });
    int n = 0;
    for (int i = 0; i < sz; ++i)
      if (n == 0 || v[n - 1].p != v[i].p || v[n - 1].f != v[i].f)
        v[n++] = v[i];
    sz = n;
  }
};

// ---------------------------------------------------------------------------
// banded aligner (align.py / AbismalAlign.hpp:320-440)
// ---------------------------------------------------------------------------
struct Cigar {
  uint32_t ops[512];
  int n = 0;
  void clear() { n = 0; }
  void set_default(int len) {
    ops[0] = (uint32_t)len << 4;
    n = 1;
  }
};

inline int64_t cigar_rseq_ops(const Cigar &c) {
  int64_t r = 0;
  for (int i = 0; i < c.n; ++i)
    if (CIGAR_TYPE[c.ops[i] & 0xF] & 2)
      r += c.ops[i] >> 4;
  return r;
}

inline int64_t cigar_qseq_ops_of(const Cigar &c, uint32_t op) {
  int64_t r = 0;
  for (int i = 0; i < c.n; ++i)
    if ((c.ops[i] & 0xF) == op)
      r += c.ops[i] >> 4;
  return r;
}

// closed-form mismatch recovery (AbismalAlign.hpp:73-89); C++ int division
// truncates toward zero
inline int32_t edit_distance(int32_t scr, int64_t length, const Cigar &c) {
  if (scr == 0)
    return (int32_t)length;
  const int64_t ins = cigar_qseq_ops_of(c, CIG_I);
  const int64_t del = cigar_qseq_ops_of(c, CIG_D);
  const int64_t a = scr - (int64_t)ALN_INDEL * (ins + del);
  const int64_t num = (int64_t)ALN_MATCH * (length - ins) - a;
  const int64_t den = ALN_MATCH - ALN_MISMATCH;
  return (int32_t)(num / den + ins + del);
}

inline int band_width(int32_t diffs, int32_t max_diffs) {
  // IUPAC genome codes can make Hamming distances negative; the reference
  // casts to size_t before min() so the full band wins
  // (AbismalAlign.hpp:332-334)
  const int64_t b = 2 * (int64_t)std::min(diffs, max_diffs) + 1;
  return b < 0 ? BANDWIDTH : (int)std::min<int64_t>(BANDWIDTH, b);
}

// per-stage wall-time accounting (engine_set_profile / engine_stage_ns);
// ~40ns/read overhead when enabled, zero branches beyond the flag when off
bool g_profile = false;

struct StageTimer {
  int64_t *slot;
  std::chrono::steady_clock::time_point t0;
  explicit StageTimer(int64_t *s) : slot(s) {
    if (g_profile)
      t0 = std::chrono::steady_clock::now();
  }
  ~StageTimer() {
    if (g_profile)
      *slot += std::chrono::duration_cast<std::chrono::nanoseconds>(
                 std::chrono::steady_clock::now() - t0)
                 .count();
  }
};

struct Aligner {
  const uint8_t *gnib;
  int64_t *stat = nullptr;  // -> Worker::tns (profiling histogram)
  std::vector<int16_t> table;
  std::vector<int16_t> rowscratch;  // log-scan shift buffer (score-only path)
  std::vector<uint8_t> qpad;        // zero-padded query copy (score-only path)
  std::vector<int8_t> tb;
  int q_sz = 0;
  bool have_tb = false;
  Cigar tb_cigar;
  int64_t tb_len = 0;
  int64_t tb_pos = 0;

  explicit Aligner(const uint8_t *genome_nib) : gnib(genome_nib) {}

  void reset(int max_read_len) {
    const size_t n = (size_t)(max_read_len + BANDWIDTH) * BANDWIDTH;
    if (table.size() < n) {
      table.resize(n);
      tb.resize(n);
    }
    rowscratch.resize(2 * BANDWIDTH);
    qpad.resize((size_t)max_read_len + 2 * BANDWIDTH + 32);
  }

  // Traceback variant: the reference's exact 3-kernel update with arrow
  // capture, including its equal-score arrow-overwrite tie behavior
  // (AbismalAlign.hpp:266-307).  Runs only for winners, so stays scalar.
  int16_t run_tb(const uint8_t *q, int64_t qs, int64_t t_pos, int64_t bw) {
    const int64_t t_shift = qs + bw;
    const int64_t n_cells = t_shift * bw;
    std::memset(table.data(), 0, n_cells * sizeof(int16_t));
    std::memset(tb.data(), -1, n_cells);
    const int64_t t_beg = t_pos - ((bw - 1) / 2);
    const uint8_t *t_itr = gnib + t_beg;
    for (int64_t i = 1; i < t_shift; ++i) {
      const int64_t left = (i < bw) ? bw - i : 0;
      const int64_t right = std::min<int64_t>(bw, t_shift - i);
      int16_t *cur = table.data() + i * bw;
      const int16_t *prev = cur - bw;
      int8_t *trow = tb.data() + i * bw;
      const uint8_t ref_base = t_itr[i - 1];
      const int64_t q0 = i - bw;
      for (int64_t j = left; j < right; ++j) {
        const int16_t sub =
          (q[q0 + j] & ref_base) ? ALN_MATCH : ALN_MISMATCH;
        const int16_t score = (int16_t)(prev[j] + sub);
        if (score > cur[j])
          cur[j] = score;
        if (cur[j] == score)
          trow[j] = (int8_t)CIG_M;
      }
      for (int64_t j = left; j + 1 < right; ++j) {
        const int16_t score = (int16_t)(prev[j + 1] + ALN_INDEL);
        if (score > cur[j])
          cur[j] = score;
        if (cur[j] == score)
          trow[j] = (int8_t)CIG_D;
      }
      for (int64_t j = left + 1; j < right; ++j) {
        const int16_t score = (int16_t)(cur[j - 1] + ALN_INDEL);
        if (score > cur[j])
          cur[j] = score;
        if (cur[j] == score)
          trow[j] = (int8_t)CIG_I;
      }
    }
    int16_t bestv = 0;
    for (int64_t k = 0; k < n_cells; ++k)
      if (table[k] > bestv)
        bestv = table[k];
    return bestv;
  }

  // Score-only variant, restructured for SIMD: the band row lives in two
  // fixed 64-lane i16 buffers (prev/cur) that stay in registers/L1 -- no
  // score table at all.  Every pass is a fixed-bound loop over 64 lanes
  // with no data-dependent conditionals, which GCC turns into a handful of
  // AVX-512 ops per row.  Out-of-band lanes are provably zero (padded
  // query bases are 0-nibbles => mismatch => zero floor), so in-band
  // cells see exactly the inputs of the reference's [left, right) loops.
  // The serial insertion-gap scan (AbismalAlign.hpp from_left) is
  // replaced by an exact log-doubling max-decay prefix scan: after rounds
  // s = 1,2,4,... v[j] = max_{k<=j}(v0[k] - 4*(j-k)), the fixpoint the
  // sequential scan computes.
  template <int LANES>
  int16_t run_score_impl(const uint8_t *q, int64_t qs, int64_t t_pos,
                         int64_t bw) {
    const int64_t t_shift = qs + bw;
    // padded query: row reads qp[i - bw + j] for j in [0, LANES) --
    // padding keeps that in-bounds, and 0-nibble padding bases force
    // mismatches
    std::memset(qpad.data(), 0, bw);
    std::memcpy(qpad.data() + bw, q, qs);
    std::memset(qpad.data() + bw + qs, 0, LANES + 16);
    const uint8_t *qp = qpad.data() + bw;
    const int64_t t_beg = t_pos - ((bw - 1) / 2);
    const uint8_t *t_itr = gnib + t_beg;
    alignas(64) int16_t buf_a[LANES + 1], buf_b[LANES + 1], scr[LANES],
      rmax[LANES];
    for (int j = 0; j < LANES; ++j) {
      buf_a[j] = buf_b[j] = rmax[j] = 0;
    }
    buf_a[LANES] = buf_b[LANES] = 0;  // deletion pass reads prev[j + 1]
    int16_t *prev = buf_a, *cur = buf_b;
    for (int64_t i = 1; i < t_shift; ++i) {
      const int right = (int)std::min<int64_t>(bw, t_shift - i);
      const uint8_t ref_base = t_itr[i - 1];
      const uint8_t *qrow = qp + (i - bw);
      // diagonal with zero floor, then deletion (row above, lane right)
      for (int j = 0; j < LANES; ++j) {
        const int16_t sub = (qrow[j] & ref_base) ? ALN_MATCH : ALN_MISMATCH;
        int16_t v = (int16_t)(prev[j] + sub);
        v = v > 0 ? v : 0;
        const int16_t del = (int16_t)(prev[j + 1] + ALN_INDEL);
        cur[j] = del > v ? del : v;
      }
      // right-of-band lanes must be zero before the insertion scan (the
      // deletion pass reaches one lane past the band)
      for (int j = right; j < LANES; ++j)
        cur[j] = 0;
      // insertion: log-doubling max-decay prefix scan (exact fixpoint of
      // the reference's sequential from_left pass in ceil(log2(bw)) rounds)
      for (int s = 1, pen = -(int)ALN_INDEL; s < (int)bw;
           s <<= 1, pen <<= 1) {
        for (int j = 0; j < s; ++j)
          scr[j] = (int16_t)pen;  // decays to <= 0: out-of-range lanes lose
        for (int j = s; j < LANES; ++j)
          scr[j] = cur[j - s];
        for (int j = 0; j < LANES; ++j) {
          const int16_t v = (int16_t)(scr[j] - (int16_t)pen);
          cur[j] = v > cur[j] ? v : cur[j];
        }
      }
      // scan leak into lanes >= right is bounded by in-band values, so the
      // row max can run over all lanes
      for (int j = 0; j < LANES; ++j)
        rmax[j] = cur[j] > rmax[j] ? cur[j] : rmax[j];
      // zero every lane the next row must see as out-of-band, including
      // lane right-1 when the band shrinks: the reference's deletion loop
      // (j + 1 < right) never reads prev[right], so that lane must be 0
      const int right_next =
        (int)std::min<int64_t>(bw, std::max<int64_t>(t_shift - i - 1, 0));
      for (int j = right_next; j < LANES; ++j)
        cur[j] = 0;
      int16_t *t = prev;
      prev = cur;
      cur = t;
    }
    int16_t bestv = 0;
    for (int j = 0; j < LANES; ++j)
      bestv = rmax[j] > bestv ? rmax[j] : bestv;
    return bestv;
  }

#if defined(__AVX512BW__)
  // One band row per ZMM register (32 i16 lanes): the whole DP state stays
  // in registers, lane shifts are vpermw, the zero floor and band masks
  // are k-masks.  Same recurrence and boundary semantics as
  // run_score_impl (which remains the checked fallback for bw >= 32 and
  // non-AVX512 builds).
  int16_t run_score_zmm(const uint8_t *q, int64_t qs, int64_t t_pos,
                        int64_t bw) {
    const int64_t t_shift = qs + bw;
    std::memset(qpad.data(), 0, bw);
    std::memcpy(qpad.data() + bw, q, qs);
    std::memset(qpad.data() + bw + qs, 0, 48);
    const uint8_t *qp = qpad.data() + bw;
    const int64_t t_beg = t_pos - ((bw - 1) / 2);
    const uint8_t *t_itr = gnib + t_beg;
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vmatch = _mm512_set1_epi16(ALN_MATCH);
    const __m512i vmis = _mm512_set1_epi16(ALN_MISMATCH);
    const __m512i vindel = _mm512_set1_epi16(ALN_INDEL);
    const __m512i iota = _mm512_set_epi16(
      31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17, 16, 15,
      14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
    const __m512i idx_dn1 = _mm512_add_epi16(iota, _mm512_set1_epi16(1));
    // insertion-scan round constants (s = 1, 2, 4, ... < bw)
    __m512i idxs[5], penv[5];
    __mmask32 kms[5];
    int nrounds = 0;
    for (int s = 1, pen = -(int)ALN_INDEL; s < (int)bw; s <<= 1, pen <<= 1) {
      idxs[nrounds] = _mm512_sub_epi16(iota, _mm512_set1_epi16((int16_t)s));
      kms[nrounds] = 0xFFFFFFFFu << s;
      penv[nrounds] = _mm512_set1_epi16((int16_t)pen);
      ++nrounds;
    }
    __m512i prev = vzero, rmaxv = vzero;
    for (int64_t i = 1; i < t_shift; ++i) {
      const int right = (int)std::min<int64_t>(bw, t_shift - i);
      const __mmask32 bandmask = (1u << right) - 1;
      const __m256i qb =
        _mm256_loadu_si256((const __m256i *)(qp + (i - bw)));
      const __m512i qw = _mm512_cvtepu8_epi16(qb);
      const __m512i refv = _mm512_set1_epi16((int16_t)t_itr[i - 1]);
      const __mmask32 mm = _mm512_test_epi16_mask(qw, refv);
      const __m512i sub = _mm512_mask_blend_epi16(mm, vmis, vmatch);
      const __m512i diag =
        _mm512_max_epi16(_mm512_add_epi16(prev, sub), vzero);
      const __m512i prevdn =
        _mm512_maskz_permutexvar_epi16(0x7FFFFFFFu, idx_dn1, prev);
      const __m512i del = _mm512_add_epi16(prevdn, vindel);
      __m512i cur =
        _mm512_maskz_mov_epi16(bandmask, _mm512_max_epi16(diag, del));
      for (int r = 0; r < nrounds; ++r) {
        const __m512i sh =
          _mm512_maskz_permutexvar_epi16(kms[r], idxs[r], cur);
        cur = _mm512_max_epi16(cur, _mm512_sub_epi16(sh, penv[r]));
      }
      rmaxv = _mm512_max_epi16(rmaxv, cur);
      const int right_next =
        (int)std::min<int64_t>(bw, std::max<int64_t>(t_shift - i - 1, 0));
      prev = _mm512_maskz_mov_epi16((1u << right_next) - 1, cur);
    }
    __m256i a = _mm256_max_epi16(_mm512_castsi512_si256(rmaxv),
                                 _mm512_extracti64x4_epi64(rmaxv, 1));
    __m128i b = _mm_max_epi16(_mm256_castsi256_si128(a),
                              _mm256_extracti128_si256(a, 1));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 8));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 4));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 2));
    return (int16_t)_mm_extract_epi16(b, 0);
  }
#endif

#if defined(__AVX512BW__)
  // Traceback variant of run_score_zmm: same recurrence, masks, and
  // boundary semantics, but every row's final scores and arrows are
  // stored for build_traceback.  Arrow capture reproduces the scalar
  // 3-kernel overwrite-on-equal order exactly (run_tb above):
  //   M iff c1 == prev[j] + sub   (then possibly overwritten)
  //   D iff c2 == prev[j+1] - 4   (overwrites M on equality)
  //   I iff c3[j] == c3[j-1] - 4  (final fixpoint values == the scalar
  //                                left-to-right pass's running values)
  // Lanes the scalar kernels never touch can hold scan-leaked phantom
  // values here; they are strictly dominated by an earlier same-row cell,
  // so the strict-'>' row-major argmax in build_traceback never selects
  // them, and no arrow ever points into them (D arrows require a nonzero
  // prev[j+1], which the right_next re-zeroing removes, and I arrows
  // point left).
  int16_t run_tb_zmm(const uint8_t *q, int64_t qs, int64_t t_pos,
                     int64_t bw) {
    const int64_t t_shift = qs + bw;
    std::memset(table.data(), 0, t_shift * bw * sizeof(int16_t));
    std::memset(tb.data(), -1, t_shift * bw);
    std::memset(qpad.data(), 0, bw);
    std::memcpy(qpad.data() + bw, q, qs);
    std::memset(qpad.data() + bw + qs, 0, 48);
    const uint8_t *qp = qpad.data() + bw;
    const int64_t t_beg = t_pos - ((bw - 1) / 2);
    const uint8_t *t_itr = gnib + t_beg;
    const __m512i vzero = _mm512_setzero_si512();
    const __m512i vmatch = _mm512_set1_epi16(ALN_MATCH);
    const __m512i vmis = _mm512_set1_epi16(ALN_MISMATCH);
    const __m512i vindel = _mm512_set1_epi16(ALN_INDEL);
    const __m512i vm1 = _mm512_set1_epi16(-1);
    const __m512i vM = _mm512_set1_epi16((int16_t)CIG_M);
    const __m512i vD = _mm512_set1_epi16((int16_t)CIG_D);
    const __m512i vI = _mm512_set1_epi16((int16_t)CIG_I);
    const __m512i iota = _mm512_set_epi16(
      31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17, 16, 15,
      14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1, 0);
    const __m512i idx_dn1 = _mm512_add_epi16(iota, _mm512_set1_epi16(1));
    const __m512i idx_up1 = _mm512_sub_epi16(iota, _mm512_set1_epi16(1));
    __m512i idxs[5], penv[5];
    __mmask32 kms[5];
    int nrounds = 0;
    for (int s = 1, pen = -(int)ALN_INDEL; s < (int)bw; s <<= 1, pen <<= 1) {
      idxs[nrounds] = _mm512_sub_epi16(iota, _mm512_set1_epi16((int16_t)s));
      kms[nrounds] = 0xFFFFFFFFu << s;
      penv[nrounds] = _mm512_set1_epi16((int16_t)pen);
      ++nrounds;
    }
    const __mmask32 storemask = (__mmask32)((1u << bw) - 1);
    __m512i prev = vzero, rmaxv = vzero;
    for (int64_t i = 1; i < t_shift; ++i) {
      const int right = (int)std::min<int64_t>(bw, t_shift - i);
      const __mmask32 bandmask = (1u << right) - 1;
      const __m256i qb =
        _mm256_loadu_si256((const __m256i *)(qp + (i - bw)));
      const __m512i qw = _mm512_cvtepu8_epi16(qb);
      const __m512i refv = _mm512_set1_epi16((int16_t)t_itr[i - 1]);
      const __mmask32 mm = _mm512_test_epi16_mask(qw, refv);
      const __m512i sub = _mm512_mask_blend_epi16(mm, vmis, vmatch);
      const __m512i subscore = _mm512_add_epi16(prev, sub);
      const __m512i c1 = _mm512_max_epi16(subscore, vzero);
      const __m512i prevdn =
        _mm512_maskz_permutexvar_epi16(0x7FFFFFFFu, idx_dn1, prev);
      const __m512i del = _mm512_add_epi16(prevdn, vindel);
      __m512i cur =
        _mm512_maskz_mov_epi16(bandmask, _mm512_max_epi16(c1, del));
      const __m512i c2 = cur;
      for (int r = 0; r < nrounds; ++r) {
        const __m512i sh =
          _mm512_maskz_permutexvar_epi16(kms[r], idxs[r], cur);
        cur = _mm512_max_epi16(cur, _mm512_sub_epi16(sh, penv[r]));
      }
      // arrows from the final values (in-band lanes only)
      const __m512i c3l =
        _mm512_maskz_permutexvar_epi16(0xFFFFFFFEu, idx_up1, cur);
      const __mmask32 is_i = _mm512_mask_cmpeq_epi16_mask(
        0xFFFFFFFEu, cur, _mm512_add_epi16(c3l, vindel));
      const __mmask32 is_d = _mm512_cmpeq_epi16_mask(c2, del);
      const __mmask32 is_m = _mm512_cmpeq_epi16_mask(c1, subscore);
      __m512i arrow = _mm512_mask_blend_epi16(is_m, vm1, vM);
      arrow = _mm512_mask_blend_epi16(
        _kand_mask32(is_d, bandmask), arrow, vD);
      arrow = _mm512_mask_blend_epi16(is_i, arrow, vI);
      _mm512_mask_storeu_epi16(table.data() + i * bw, storemask, cur);
      _mm256_mask_storeu_epi8(tb.data() + i * bw, storemask,
                              _mm512_cvtepi16_epi8(arrow));
      rmaxv = _mm512_max_epi16(rmaxv, cur);
      const int right_next =
        (int)std::min<int64_t>(bw, std::max<int64_t>(t_shift - i - 1, 0));
      prev = _mm512_maskz_mov_epi16((1u << right_next) - 1, cur);
    }
    __m256i a = _mm256_max_epi16(_mm512_castsi512_si256(rmaxv),
                                 _mm512_extracti64x4_epi64(rmaxv, 1));
    __m128i b = _mm_max_epi16(_mm256_castsi256_si128(a),
                              _mm256_extracti128_si256(a, 1));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 8));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 4));
    b = _mm_max_epi16(b, _mm_srli_si128(b, 2));
    return (int16_t)_mm_extract_epi16(b, 0);
  }
#endif

  int16_t run_score(const uint8_t *q, int64_t qs, int64_t t_pos,
                    int64_t bw) {
#if defined(__AVX512BW__)
    if (bw < 32)
      return run_score_zmm(q, qs, t_pos, bw);
    return run_score_impl<64>(q, qs, t_pos, bw);
#else
    if (bw < 16)
      return run_score_impl<16>(q, qs, t_pos, bw);
    if (bw < 32)
      return run_score_impl<32>(q, qs, t_pos, bw);
    return run_score_impl<64>(q, qs, t_pos, bw);
#endif
  }

  // align.py BandedAligner.align: score (and optional traceback capture)
  int32_t align(int32_t diffs, int32_t max_diffs, const uint8_t *q,
                int64_t qs, int64_t t_pos, bool do_tb) {
    q_sz = (int)qs;
    if (diffs == 0) {
      have_tb = false;
      return (int32_t)(ALN_MATCH * qs);
    }
    const int bw = band_width(diffs, max_diffs);
    if (g_profile && stat) {
      stat[do_tb ? 6 : 4] += 1;
      if (!do_tb) {
        stat[5] += (qs + bw) * bw;
        stat[7] += bw;
        if (bw < 16)
          stat[8] += (qs + bw) * bw;
        else if (bw < 32)
          stat[9] += (qs + bw) * bw;
      }
    }
#if defined(__AVX512BW__)
    const int16_t r = do_tb ? (bw < 32 ? run_tb_zmm(q, qs, t_pos, bw)
                                       : run_tb(q, qs, t_pos, bw))
                            : run_score(q, qs, t_pos, bw);
#else
    const int16_t r =
      do_tb ? run_tb(q, qs, t_pos, bw) : run_score(q, qs, t_pos, bw);
#endif
    if (do_tb) {
      build_traceback(qs, t_pos, bw, r);
      have_tb = true;
    }
    return r;
  }

  // AbismalAlign.hpp:388-440
  void build_traceback(int64_t qs, int64_t t_pos, int64_t bw, int16_t r) {
    const int64_t t_shift = qs + bw;
    const int64_t n_cells = t_shift * bw;
    int64_t best_cell = 0;
    int16_t bestv = -1;
    for (int64_t k = 0; k < n_cells; ++k)
      if (table[k] > bestv) {
        bestv = table[k];
        best_cell = k;
      }
    if (r == 0) {
      tb_cigar.set_default((int)qs);
      tb_len = qs;
      tb_pos = t_pos;
      return;
    }
    int64_t row = best_cell / bw;
    int64_t col = best_cell % bw;
    const int64_t soft_bottom = (qs + bw - 1) - (row + col);

    uint32_t tmp[512];
    int n_ops = 0;
    int8_t prev_arrow = tb[row * bw + col];
    bool is_del = prev_arrow == (int8_t)CIG_D;
    bool is_ins = prev_arrow == (int8_t)CIG_I;
    row -= is_ins ? 0 : 1;
    col -= is_ins ? 1 : 0;
    col += is_del ? 1 : 0;
    uint32_t n = 1;
    while (table[row * bw + col] > 0) {
      const int8_t arrow = tb[row * bw + col];
      is_del = arrow == (int8_t)CIG_D;
      is_ins = arrow == (int8_t)CIG_I;
      row -= is_ins ? 0 : 1;
      col -= is_ins ? 1 : 0;
      col += is_del ? 1 : 0;
      if (arrow != prev_arrow) {
        tmp[n_ops++] = (n << 4) | (uint32_t)prev_arrow;
        n = 0;
      }
      ++n;
      prev_arrow = arrow;
    }
    tmp[n_ops++] = (n << 4) | (uint32_t)prev_arrow;
    const int64_t soft_top = (row + col) - (bw - 1);
    if (soft_top > 0)
      tmp[n_ops++] = ((uint32_t)soft_top << 4) | CIG_S;
    std::reverse(tmp, tmp + n_ops);
    if (soft_bottom > 0)
      tmp[n_ops++] = ((uint32_t)soft_bottom << 4) | CIG_S;
    std::memcpy(tb_cigar.ops, tmp, n_ops * sizeof(uint32_t));
    tb_cigar.n = n_ops;
    tb_len = qs - soft_bottom - soft_top;
    tb_pos = (t_pos - ((bw - 1) / 2)) + row;
  }

  // align.py build_cigar_len_and_pos wrapper semantics
  void cigar_len_pos(int32_t diffs, Cigar &out, int64_t &len, int64_t &pos,
                     int64_t t_pos) {
    if (diffs == 0 || !have_tb) {
      out.set_default(q_sz);
      len = q_sz;
      pos = t_pos;
      return;
    }
    out = tb_cigar;
    len = tb_len;
    pos = tb_pos;
  }
};

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// engine context and per-thread worker state
// ---------------------------------------------------------------------------
struct Events {
  const uint32_t *pos = nullptr;
  const int32_t *diffs = nullptr;
  const int32_t *rank = nullptr;
  const int64_t *start = nullptr;  // per unit
  const int64_t *count = nullptr;  // per unit; -1 => native seeding fallback
  int64_t boundary = 0;            // o_spec * 2 * SLOT
  bool present() const { return pos != nullptr; }

  // device stage-1+2 PE candidate slots (pipeline.py build_stage12pe):
  // per-unit prescored candidate lists in discovery order, replacing both
  // the event stream and the host score pass
  const uint32_t *sl_pos = nullptr;  // (n_units, k2)
  const int32_t *sl_ds = nullptr;    // (diffs << 16) | (score & 0xffff)
  const int32_t *sl_cnt = nullptr;   // per unit; -1 => native seeding
  int64_t k2 = 0;
  bool slots() const { return sl_pos != nullptr; }

  // device mating sweep records (pipeline.py build_stage12pe `mate`):
  // per pair, per orientation, 10 ints [has, scr, pos1, pos2, d1, d2,
  // scr1_stale, scr2, eq_after, 0] -- the LOCAL best_pair sweep result,
  // applied by apply_device_mate with full sequential cross-orientation
  // state kept on the host
  const int32_t *mate = nullptr;  // (n_pairs, m_stride)
  int64_t m_stride = 0;
};

struct Engine {
  const uint8_t *gnib;
  const uint64_t *gwords;
  int64_t gsize;
  const uint32_t *counter2;   // 2^25 + 1
  const uint32_t *counter_t;  // 3^16 + 1
  const uint32_t *counter_a;
  const uint32_t *index2, *index_t, *index_a;
  int64_t max_candidates;
  const uint64_t *starts;  // n_chroms + 1 entries
  int64_t n_chroms;
  std::vector<std::string> names;
  bool allow_ambig;
  double valid_frac;
  int64_t pe_min, pe_max;
  std::string out;
  std::string err;
  std::vector<struct Worker *> workers;
  struct SEPhase *se_phase = nullptr;
  struct PEPhase *pe_phase = nullptr;
};

struct Worker {
  Aligner aln;
  SECand se, se1, se2;
  Elem prep[SE_MAX];
  PECand pe1, pe2;
  std::vector<int32_t> mem_scr1;
  std::string out;
  int64_t st[18];
  // stage ns: seed, align, format, parse; then align-call histogram:
  // n_score_calls, sum_cells, n_tb_calls, sum_bw, cells at bw<16,
  // cells at bw in [16,32), spare x2
  int64_t tns[16] = {0};
  std::vector<uint8_t> buf[8];   // read encodings
  std::vector<uint8_t> rcbuf[2]; // raw revcomp ASCII
  std::vector<uint64_t> packed;  // packed read for native seeding
  std::vector<uint32_t> k2, k3;  // rolling hash scratch

  explicit Worker(const uint8_t *gnib)
      : aln(gnib), mem_scr1(PE_MAX_LARGE, 0) {
    std::memset(st, 0, sizeof(st));
    aln.stat = tns;
  }
};

inline uint32_t strand_code(bool minus, bool a_rich) {
  return (minus ? F_RC : 0) | (a_rich ? F_A_RICH : 0);
}

inline bool conv_is_ga(uint32_t sc) {
  // three_conv_type selection (abismal.cpp:1261-1267)
  return ((sc & F_A_RICH) != 0) ^ ((sc & F_RC) != 0);
}

inline void encode_read(const uint8_t *ascii, int len, bool a_rich,
                        std::vector<uint8_t> &out) {
  const uint8_t *t = a_rich ? T.enc_a : T.enc_t;
  out.resize(len);
  for (int i = 0; i < len; ++i)
    out[i] = t[ascii[i]];
}

inline void revcomp_ascii(const uint8_t *ascii, int len,
                          std::vector<uint8_t> &out) {
  out.resize(len);
  for (int i = 0; i < len; ++i)
    out[i] = T.rc[ascii[len - 1 - i]];
}

// nibbles -> u64 words, tail padded with 0xF match-any (abismal.cpp:1388-1426)
inline int pack_read(const uint8_t *pread, int len,
                     std::vector<uint64_t> &out) {
  const int n_words = (len + 15) / 16;
  out.assign(n_words, 0);
  for (int i = 0; i < len; ++i)
    out[i >> 4] |= (uint64_t)pread[i] << (4 * (i & 15));
  const int tail = n_words * 16 - len;
  if (tail)
    out[n_words - 1] |= ~0ull << (4 * (len & 15));
  return n_words;
}

// ---------------------------------------------------------------------------
// native seeding (seeds.py port; abismal.cpp:1090-1375)
// ---------------------------------------------------------------------------

// Hamming distance of the packed read vs the genome window at pos, with
// the cutoff early exit: stops as soon as the running mismatch count
// exceeds `cutoff` (the partial sum only grows, so the accept decision
// d <= cutoff is unchanged -- the reference's per-word `while (d <=
// cutoff)` loop, abismal.cpp:1105-1122).  On VPOPCNTDQ hardware the whole
// window is summed in one masked 512-bit pass instead (exact d; the
// early exit saves nothing once the lines are already loaded).
inline int32_t full_compare_cut(const Engine &E, const uint64_t *packed,
                                int n_words, uint32_t pos, int32_t cutoff) {
  const int64_t w = pos >> 4;
  const uint64_t sh = (uint64_t)(pos & 15) * 4;
#if defined(__AVX512VPOPCNTDQ__)
  (void)cutoff;
  const __m512i vsh = _mm512_set1_epi64((long long)sh);
  const __m512i vshl = _mm512_set1_epi64((long long)(63 - sh));
  __m512i acc = _mm512_setzero_si512();
  for (int j = 0; j < n_words; j += 8) {
    const __mmask8 k =
      (__mmask8)((1u << std::min(8, n_words - j)) - 1);
    const __m512i g1 = _mm512_maskz_loadu_epi64(k, E.gwords + w + j);
    const __m512i g2 = _mm512_maskz_loadu_epi64(k, E.gwords + w + j + 1);
    const __m512i merged =
      _mm512_or_si512(_mm512_srlv_epi64(g1, vsh),
                      _mm512_slli_epi64(_mm512_sllv_epi64(g2, vshl), 1));
    const __m512i pr = _mm512_maskz_loadu_epi64(k, packed + j);
    acc = _mm512_add_epi64(
      acc, _mm512_popcnt_epi64(_mm512_and_si512(pr, merged)));
  }
  return 16 * n_words - (int32_t)_mm512_reduce_add_epi64(acc);
#else
  int32_t d = 0;
  for (int j = 0; j < n_words; ++j) {
    const uint64_t g1 = E.gwords[w + j];
    const uint64_t g2 = E.gwords[w + j + 1];
    const uint64_t merged = (g1 >> sh) | ((g2 << (63 - sh)) << 1);
    d += 16 - __builtin_popcountll(packed[j] & merged);
    if (d > cutoff)
      return d;
  }
  return d;
#endif
}

template <class Cand>
void check_hits(const Engine &E, const uint64_t *packed, int n_words,
                int offset, const uint32_t *bucket, int64_t cnt, uint32_t sc,
                Cand &res, Worker &w) {
  // compare candidates in bucket order and feed the candidate set
  // (abismal.cpp:1124-1150); genome windows of upcoming candidates are
  // prefetched like the reference's SSE prefetch (abismal.cpp:1134-1137)
  if (cnt == 0 || res.sure_ambig)
    return;
  if (g_profile) {
    w.tns[12] += cnt;
    w.tns[13] += 1;
  }
  // prime the prefetch pipeline: both cache lines of each window (the
  // 8-word window spans up to 2 lines at an unaligned nibble offset)
  static const int PFD = [] {
    const char *e = getenv("ABISMAL_PFD");
    return e ? atoi(e) : 10;
  }();
  for (int64_t i = 0; i < std::min<int64_t>(PFD, cnt); ++i) {
    const uint64_t wd = ((uint64_t)(bucket[i] - (uint32_t)offset)) >> 4;
    __builtin_prefetch(E.gwords + wd);
    __builtin_prefetch(E.gwords + wd + 7);
  }
  for (int64_t i = 0; i < cnt; ++i) {
    if (res.sure_ambig)
      break;
    if (i + PFD < cnt) {
      const uint64_t wd =
        ((uint64_t)(bucket[i + PFD] - (uint32_t)offset)) >> 4;
      __builtin_prefetch(E.gwords + wd);
      __builtin_prefetch(E.gwords + wd + 7);
    }
    const uint32_t pos = bucket[i] - (uint32_t)offset;
    const int32_t d = full_compare_cut(E, packed, n_words, pos, res.cutoff);
    if (d <= res.cutoff)
      res.update(true, d, sc, pos);
  }
}

// binary-search seed extension in a suffix-sorted two-letter bucket
// (abismal.cpp:1163-1194)
inline void find_candidates_two(const Engine &E, const uint8_t *pread,
                                int offset, int read_lim, int64_t &lo,
                                int64_t &hi, int &p_out, Worker &w) {
  const int64_t max_c = E.max_candidates;
  int p = KEY_WEIGHT;
  int64_t prev_lo = lo, prev_hi = hi;
  while (p != read_lim && (hi - lo) > max_c) {
    prev_lo = lo;
    prev_hi = hi;
    if (g_profile) {
      w.tns[10] += 1;            // extension steps
      w.tns[11] += 64 - __builtin_clzll((uint64_t)(hi - lo) | 1);  // probes
    }
    int64_t a = lo, b = hi;
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if (T.bit[E.gnib[E.index2[mid] + p]] < 1)
        a = mid + 1;
      else
        b = mid;
    }
    if (T.bit[pread[offset + p]])
      lo = a;
    else
      hi = a;
    ++p;
  }
  if (lo == hi) {
    --p;
    lo = prev_lo;
    hi = prev_hi;
  }
  p_out = p;
}

// three-letter variant with two lower_bounds (abismal.cpp:1214-1259)
inline void find_candidates_three(const Engine &E, const uint8_t *pread,
                                  int offset, int read_lim, int64_t &lo,
                                  int64_t &hi, int &p_out, bool is_ga,
                                  Worker &w) {
  const int64_t max_c = E.max_candidates;
  const uint32_t *index = is_ga ? E.index_a : E.index_t;
  const uint8_t mask = is_ga ? 10 : 5;
  const uint8_t v1 = is_ga ? 2 : 1, v2 = is_ga ? 8 : 4;
  int p = KEY_WEIGHT_THREE;
  int64_t prev_lo = lo, prev_hi = hi;
  auto lower_bound = [&](int64_t a, int64_t b, uint8_t val, int pp) {
    while (a < b) {
      const int64_t mid = (a + b) >> 1;
      if ((E.gnib[index[mid] + pp] & mask) < val)
        a = mid + 1;
      else
        b = mid;
    }
    return a;
  };
  while (p != read_lim && (hi - lo) > max_c) {
    prev_lo = lo;
    prev_hi = hi;
    if (g_profile) {
      w.tns[10] += 1;
      w.tns[11] += 2 * (64 - __builtin_clzll((uint64_t)(hi - lo) | 1));
    }
    const int64_t first_1 = lower_bound(lo, hi, v1, p);
    const int64_t first_2 = lower_bound(lo, hi, v2, p);
    const uint8_t num = pread[offset + p] & mask;
    if (num == 0)
      hi = first_1;
    else if (num == v1) {
      lo = first_1;
      hi = first_2;
    }
    else
      lo = first_2;
    ++p;
  }
  if (lo == hi) {
    --p;
    lo = prev_lo;
    hi = prev_hi;
  }
  p_out = p;
}

// two-phase seeding policy (abismal.cpp:1269-1375 / seeds.py:220-283)
template <class Cand>
void process_seeds(const Engine &E, Worker &w, const uint8_t *pread, int len,
                   uint32_t sc, Cand &res) {
  const bool is_ga = conv_is_ga(sc);
  const uint32_t *counter3 = is_ga ? E.counter_a : E.counter_t;
  const uint32_t *index3 = is_ga ? E.index_a : E.index_t;
  const uint8_t *three = is_ga ? T.three_ga : T.three_ct;
  const int64_t max_c = E.max_candidates;
  const int n_words = pack_read(pread, len, w.packed);
  const uint64_t *packed = w.packed.data();

  // rolling hashes for every seed offset (seeds.py read_hashes)
  const int lim2 = len - KEY_WEIGHT + 1;
  const int lim3 = len - KEY_WEIGHT_THREE + 1;
  w.k2.assign(std::max(lim2, 0), 0);
  w.k3.assign(std::max(lim3, 0), 0);
  {
    uint32_t k = 0;
    for (int j = 0; j < len; ++j) {
      k = ((k << 1) | T.bit[pread[j]]) & HASH_MASK;
      if (j >= KEY_WEIGHT - 1)
        w.k2[j - (KEY_WEIGHT - 1)] = k;
    }
    uint32_t k3 = 0;
    for (int j = 0; j < len; ++j) {
      k3 = (k3 * 3 + three[pread[j]]) % HASH3_MOD;
      if (j >= KEY_WEIGHT_THREE - 1)
        w.k3[j - (KEY_WEIGHT_THREE - 1)] = k3;
    }
  }

  const int specific_len = std::min(len - WINDOW_SIZE, len >> 1);
  const int specific_lim = std::max(WINDOW_SIZE, len >> 1);

  // the hash keys for every offset were computed above, so the dependent
  // counter-table loads (two random accesses into 128/165 MB arrays per
  // offset per table -- the dominant cache-miss source of the seed stage)
  // can be issued PF offsets ahead
  const int PF = 12;
  auto prefetch_counters = [&](int i, int loop_lim) {
    if (i < loop_lim) {
      if (i < lim2)
        __builtin_prefetch(E.counter2 + w.k2[i]);
      if (i < lim3)
        __builtin_prefetch(counter3 + w.k3[i]);
    }
  };

  // second pipeline stage: read the (already prefetched) counter values a
  // few offsets early and prefetch the bucket heads + the extension's
  // first binary-search probe, so check_hits/find_candidates start from
  // warm lines
  static const int PB = [] {
    const char *e = getenv("ABISMAL_PB");
    return e ? atoi(e) : 8;
  }();
  auto prefetch_buckets = [&](int i, int loop_lim) {
    if (i >= loop_lim)
      return;
    const uint32_t kk = (i < lim2) ? w.k2[i] : 0;
    const int64_t s2 = E.counter2[kk], e2 = E.counter2[kk + 1];
    if (e2 > s2) {
      __builtin_prefetch(E.index2 + s2);
      if (e2 - s2 > max_c)
        __builtin_prefetch(E.index2 + ((s2 + e2) >> 1));
    }
    const uint32_t kk3 = (i < lim3) ? w.k3[i] : 0;
    const int64_t s3 = counter3[kk3], e3 = counter3[kk3 + 1];
    if (e3 > s3) {
      __builtin_prefetch(index3 + s3);
      if (e3 - s3 > max_c)
        __builtin_prefetch(index3 + ((s3 + e3) >> 1));
    }
  };

  // --- specific phase ---
  res.set_specific();
  for (int i = 0; i < std::min(PF, specific_lim); ++i)
    prefetch_counters(i, specific_lim);
  for (int i = 0; i < std::min(PB, specific_lim); ++i)
    prefetch_buckets(i, specific_lim);
  for (int i = 0; i < specific_lim; ++i) {
    if (res.sure_ambig)
      break;
    prefetch_counters(i + PF, specific_lim);
    prefetch_buckets(i + PB, specific_lim);
    const uint32_t kk = (i < lim2) ? w.k2[i] : 0;
    int64_t s2 = E.counter2[kk], e2 = E.counter2[kk + 1];
    int l_two;
    find_candidates_two(E, pread, i, len - i, s2, e2, l_two, w);
    const int64_t d_two = e2 - s2;
    const uint32_t kk3 = (i < lim3) ? w.k3[i] : 0;
    int64_t s3 = counter3[kk3], e3 = counter3[kk3 + 1];
    int l_three;
    find_candidates_three(E, pread, i, len - i, s3, e3, l_three, is_ga, w);
    const int64_t d_three = e3 - s3;
    if (d_two <= max_c || l_two >= specific_len)
      check_hits(E, packed, n_words, i, E.index2 + s2, d_two, sc, res, w);
    if (d_three <= max_c || l_three >= specific_len)
      check_hits(E, packed, n_words, i, index3 + s3, d_three, sc, res, w);
  }

  if (!res.should_do_sensitive())
    return;

  // --- sensitive phase ---
  res.set_sensitive();
  for (int i = 0; i < std::min(PF, lim2); ++i)
    prefetch_counters(i, lim2);
  for (int i = 0; i < std::min(PB, lim2); ++i)
    prefetch_buckets(i, lim2);
  for (int i = 0; i < lim2; ++i) {
    if (res.sure_ambig)
      break;
    prefetch_counters(i + PF, lim2);
    prefetch_buckets(i + PB, lim2);
    const uint32_t kk = w.k2[i];
    const int64_t s2 = E.counter2[kk], e2 = E.counter2[kk + 1];
    const int64_t d_two = e2 - s2;
    const uint32_t kk3 = w.k3[i];
    const int64_t s3 = counter3[kk3], e3 = counter3[kk3 + 1];
    const int64_t d_three = e3 - s3;

    if (d_two != 0 && d_two <= max_c
        && (d_three == 0 || d_two <= MIN_FOLD_SIZE * d_three))
      check_hits(E, packed, n_words, i, E.index2 + s2, d_two, sc, res, w);
    if (d_three != 0 && d_three <= max_c)
      check_hits(E, packed, n_words, i, index3 + s3, d_three, sc, res, w);
  }
}

// device-event replay (pipeline.py replay_events; abismal.cpp:1269-1375)
template <class Cand>
void replay_events(const Events &ev, int64_t u, uint32_t sc, Cand &res) {
  const int64_t s = ev.start[u], c = ev.count[u];
  res.set_specific();
  int64_t i = 0;
  while (i < c && ev.rank[s + i] < ev.boundary) {
    if (res.sure_ambig)
      break;
    const int32_t d = ev.diffs[s + i];
    if (d <= res.cutoff)
      res.update(true, d, sc, ev.pos[s + i]);
    ++i;
  }
  while (i < c && ev.rank[s + i] < ev.boundary)
    ++i;
  if (!res.should_do_sensitive())
    return;
  res.set_sensitive();
  while (i < c) {
    if (res.sure_ambig)
      break;
    const int32_t d = ev.diffs[s + i];
    if (d <= res.cutoff)
      res.update(true, d, sc, ev.pos[s + i]);
    ++i;
  }
}

template <class Cand>
void seeds(const Engine &E, Worker &w, const Events &ev, int64_t unit,
           const uint8_t *pread, int len, uint32_t sc, Cand &res) {
  if (ev.present() && ev.count[unit] >= 0)
    replay_events(ev, unit, sc, res);
  else
    process_seeds(E, w, pread, len, sc, res);
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// output formatting (io/sam.py port; abismal.cpp:481-545, 648-773)
// ---------------------------------------------------------------------------
inline void append_u(std::string &s, uint64_t x) {
  char b[24];
  int i = 24;
  do {
    b[--i] = '0' + (char)(x % 10);
    x /= 10;
  } while (x);
  s.append(b + i, 24 - i);
}

inline void append_i(std::string &s, int64_t x) {
  if (x < 0) {
    s.push_back('-');
    append_u(s, (uint64_t)(-x));
  }
  else
    append_u(s, (uint64_t)x);
}

inline void append_cigar(std::string &s, const Cigar &c) {
  for (int i = 0; i < c.n; ++i) {
    append_u(s, c.ops[i] >> 4);
    s.push_back(CIGAR_OPS[c.ops[i] & 0xF]);
  }
}

// pos -> (ok, chrom_idx, offset) with the read kept inside one chromosome
// (genome.py get_chrom_idx_and_offset_checked; AbismalIndex.cpp:1305-1320)
inline bool chrom_lookup(const Engine &E, uint32_t pos, int64_t r_ops,
                         int64_t &ci, int64_t &off) {
  // upper_bound over starts[0 .. n_chroms]
  int64_t lo = 0, hi = E.n_chroms + 1;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (E.starts[mid] <= pos)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo == 0)
    return false;
  ci = lo - 1;
  off = pos - (int64_t)E.starts[ci];
  return pos + r_ops <= (int64_t)E.starts[ci + 1];
}

inline void append_sam(std::string &s, const Engine &E, const uint8_t *name,
                       int64_t name_len, uint32_t flag, int64_t ci,
                       int64_t pos1, const Cigar &cig, const char *rnext,
                       int64_t pnext1, int64_t isize, const uint8_t *seq,
                       int seq_len, bool rc_seq, int32_t nm, char cv) {
  s.append((const char *)name, name_len);
  s.push_back('\t');
  append_u(s, flag);
  s.push_back('\t');
  s.append(E.names[ci]);
  s.push_back('\t');
  append_i(s, pos1);
  s.append("\t255\t");
  append_cigar(s, cig);
  s.push_back('\t');
  s.append(rnext);
  s.push_back('\t');
  append_i(s, pnext1);
  s.push_back('\t');
  append_i(s, isize);
  s.push_back('\t');
  if (rc_seq)
    for (int i = seq_len - 1; i >= 0; --i)
      s.push_back((char)T.rc[seq[i]]);
  else
    s.append((const char *)seq, seq_len);
  s.append("\t*\tNM:i:");
  append_i(s, nm);
  s.append("\tCV:A:");
  s.push_back(cv);
  s.push_back('\n');
}

const int MAP_UNMAPPED = 0, MAP_UNIQUE = 1, MAP_AMBIG = 2;

// abismal.cpp:481-545 / engine.py _format_se
inline int format_se(const Engine &E, const Elem &best, const Cigar &cig,
                     const uint8_t *name, int64_t name_len,
                     const uint8_t *read, int len, std::string &out) {
  const bool ambig = elem_ambig(best);
  const bool valid = !elem_empty(best);
  if (!E.allow_ambig && ambig)
    return MAP_AMBIG;
  if (!valid)
    return MAP_UNMAPPED;
  const int64_t r_ops = cigar_rseq_ops(cig);
  int64_t ci, r_s;
  if (!chrom_lookup(E, best.p, r_ops, ci, r_s))
    return MAP_UNMAPPED;
  uint32_t flag = 0;
  const bool rc = (best.f & F_RC) != 0;
  if (rc)
    flag |= F_RC;
  if (E.allow_ambig && ambig)
    flag |= F_SECONDARY;
  append_sam(out, E, name, name_len, flag, ci, r_s + 1, cig, "*", 0, 0,
             read, len, rc, best.d, (best.f & F_A_RICH) ? 'A' : 'T');
  return ambig ? MAP_AMBIG : MAP_UNIQUE;
}

// ---------------------------------------------------------------------------
// SE alignment phase (engine.py align_se_candidates; abismal.cpp:1435-1497)
// ---------------------------------------------------------------------------
inline int32_t diffs_cutoff(int readlen, double frac) {
  return (int32_t)(frac * readlen);
}

inline bool valid_len_ok(int64_t aln_len, int readlen) {
  const double min_aln_frac = 1.0 - INVALID_HIT_FRAC;
  return aln_len >= std::max<int64_t>(MIN_READ_LENGTH,
                                      (int64_t)(min_aln_frac * readlen));
}

inline bool valid_hit(int32_t d, int readlen) {
  return d < (int32_t)(INVALID_HIT_FRAC * readlen);
}

inline const uint8_t *pick_pread(const Elem &e, const uint8_t *pt,
                                 const uint8_t *pt_rc, const uint8_t *pa,
                                 const uint8_t *pa_rc) {
  // query encoding selection by hit flags (abismal.cpp:1461-1465)
  if (e.f & F_RC)
    return (e.f & F_A_RICH) ? pt_rc : pa_rc;
  return (e.f & F_A_RICH) ? pa : pt;
}

template <class ScoreFn>
void align_se_candidates_impl(const uint8_t *pt, const uint8_t *pt_rc,
                              const uint8_t *pa, const uint8_t *pa_rc,
                              int readlen, double cutoff, SECand &res,
                              Worker &w, Elem &best_out, Cigar &cig,
                              ScoreFn score_of) {
  const int32_t max_diffs = diffs_cutoff(readlen, cutoff);
  const int32_t max_scr = ALN_MATCH * readlen;
  if (res.has_exact()) {
    best_out = res.best;
    cig.set_default(readlen);
    return;
  }
  Elem best{MAX_DIFFS, 0, 0};
  int32_t best_scr = 0;
  uint32_t best_pos = 0;
  const int n = res.prepare_for_alignments(w.prep);
  int i = 0;
  while (i < n && elem_empty(w.prep[i]))
    ++i;
  for (; i < n; ++i) {
    const Elem &e = w.prep[i];
    if (valid_hit(e.d, readlen)) {
      const uint8_t *q = pick_pread(e, pt, pt_rc, pa, pa_rc);
      const int32_t cand_scr = score_of(e, q, max_diffs);
      if (cand_scr > best_scr) {
        best = e;
        best_scr = cand_scr;
        best_pos = e.p;
      }
      else if (cand_scr == best_scr
               && (cand_scr == max_scr
                     ? e.p != best_pos
                     : std::abs((int64_t)e.p - (int64_t)best_pos)
                         > SAME_POS_TOL)) {
        set_ambig(best);
      }
    }
  }
  cig.clear();
  if (best.p != 0) {
    const uint8_t *q = pick_pread(best, pt, pt_rc, pa, pa_rc);
    w.aln.align(best.d, max_diffs, q, readlen, best.p, true);
    int64_t aln_len, new_pos;
    w.aln.cigar_len_pos(best.d, cig, aln_len, new_pos, best.p);
    best.p = (uint32_t)new_pos;
    best.d = edit_distance(best_scr, aln_len, cig);
    if (!(valid_len_ok(aln_len, readlen) && best.d <= max_diffs))
      best = Elem{MAX_DIFFS, best.f, 0};
  }
  else {
    best = Elem{MAX_DIFFS, best.f, 0};
  }
  best_out = best;
}

void align_se_candidates(const uint8_t *pt, const uint8_t *pt_rc,
                         const uint8_t *pa, const uint8_t *pa_rc, int readlen,
                         double cutoff, SECand &res, Worker &w, Elem &best_out,
                         Cigar &cig) {
  align_se_candidates_impl(
    pt, pt_rc, pa, pa_rc, readlen, cutoff, res, w, best_out, cig,
    [&](const Elem &e, const uint8_t *q, int32_t max_diffs) {
      return w.aln.align(e.d, max_diffs, q, readlen, e.p, false);
    });
}

// ---------------------------------------------------------------------------
// per-read SE mapping (engine.py map_se_reads body)
// ---------------------------------------------------------------------------
struct SEStatsAcc {
  int64_t *st;  // total, unique, ambig, skipped, edits, bases
  void update(bool read_empty, bool valid, bool ambig, int32_t d,
              const Cigar &cig, bool count_ambig_err) {
    st[0] += 1;
    st[1] += (valid && !ambig) ? 1 : 0;
    st[2] += (valid && ambig) ? 1 : 0;
    st[3] += read_empty ? 1 : 0;
    if (valid && (!ambig || count_ambig_err)) {
      st[4] += d;
      st[5] += cigar_rseq_ops(cig);
    }
  }
};

// seed one SE read (2 or 4 units) into w.se; returns the four query
// encodings (pt, pt_rc, pa, pa_rc) in w.buf via `enc`
void se_seed_read(const Engine &E, Worker &w, const Events &ev, int64_t ri,
                  const uint8_t *read, int len, bool a_rich_mode,
                  bool random_pbat, const uint8_t *enc[4]) {
  if (!random_pbat) {
    const bool conv = a_rich_mode;
    encode_read(read, len, conv, w.buf[0]);
    seeds(E, w, ev, 2 * ri, w.buf[0].data(), len, strand_code(false, conv),
          w.se);
    revcomp_ascii(read, len, w.rcbuf[0]);
    encode_read(w.rcbuf[0].data(), len, !conv, w.buf[1]);
    seeds(E, w, ev, 2 * ri + 1, w.buf[1].data(), len,
          strand_code(true, conv), w.se);
    enc[0] = enc[2] = w.buf[0].data();
    enc[1] = enc[3] = w.buf[1].data();
  }
  else {
    // 4-way RPBAT orchestration (abismal.cpp:1602-1704)
    encode_read(read, len, false, w.buf[0]);
    seeds(E, w, ev, 4 * ri, w.buf[0].data(), len, strand_code(false, false),
          w.se);
    encode_read(read, len, true, w.buf[2]);
    seeds(E, w, ev, 4 * ri + 1, w.buf[2].data(), len,
          strand_code(false, true), w.se);
    revcomp_ascii(read, len, w.rcbuf[0]);
    encode_read(w.rcbuf[0].data(), len, false, w.buf[1]);
    seeds(E, w, ev, 4 * ri + 2, w.buf[1].data(), len,
          strand_code(true, true), w.se);
    encode_read(w.rcbuf[0].data(), len, true, w.buf[3]);
    seeds(E, w, ev, 4 * ri + 3, w.buf[3].data(), len,
          strand_code(true, false), w.se);
    enc[0] = w.buf[0].data();
    enc[1] = w.buf[1].data();
    enc[2] = w.buf[2].data();
    enc[3] = w.buf[3].data();
  }
}

void map_one_se(const Engine &E, Worker &w, const Events &ev, int64_t ri,
                const uint8_t *name, int64_t name_len, const uint8_t *read,
                int len, bool a_rich_mode, bool random_pbat) {
  w.se.reset(len);
  Elem best{MAX_DIFFS, 0, 0};
  Cigar cig;
  cig.clear();
  if (len) {
    const uint8_t *enc[4];
    {
      StageTimer t(w.tns + 0);
      se_seed_read(E, w, ev, ri, read, len, a_rich_mode, random_pbat, enc);
    }
    {
      StageTimer t(w.tns + 1);
      align_se_candidates(enc[0], enc[1], enc[2], enc[3], len, E.valid_frac,
                          w.se, w, best, cig);
    }
    StageTimer t(w.tns + 2);
    const int map_type =
      format_se(E, best, cig, name, name_len, read, len, w.out);
    if (map_type == MAP_UNMAPPED) {
      best.d = MAX_DIFFS;
      best.p = 0;
    }
  }
  SEStatsAcc acc{w.st};
  acc.update(len == 0, !elem_empty(best), elem_ambig(best), best.d, cig,
             E.allow_ambig);
}

}  // namespace

namespace {

// ---------------------------------------------------------------------------
// paired-end mapping (engine.py PEBest/_best_pair/_map_fragments/map_pe_reads;
// abismal.cpp:547-631,1715-2185)
// ---------------------------------------------------------------------------
struct PEBest {
  int32_t aln_score = 0;
  Elem r1{MAX_DIFFS, 0, 0}, r2{MAX_DIFFS, 0, 0};
  int32_t max_aln_score = 0;

  void init(int l1, int l2) {
    aln_score = 0;
    r1 = Elem{(int32_t)(INVALID_HIT_FRAC * l1), 0, 0};
    r2 = Elem{(int32_t)(INVALID_HIT_FRAC * l2), 0, 0};
    max_aln_score = ALN_MATCH * (l1 + l2);
  }
  void reset() {
    aln_score = 0;
    r1 = Elem{MAX_DIFFS, r1.f, 0};
    r2 = Elem{MAX_DIFFS, r2.f, 0};
  }
  bool update(int32_t scr, const Elem &s1, const Elem &s2) {
    const int64_t rd = (int64_t)r1.d + r2.d;
    const int64_t sd = (int64_t)s1.d + s2.d;
    if (scr > aln_score || (scr == aln_score && sd < rd)) {
      r1 = s1;
      r2 = s2;
      aln_score = scr;
      return true;
    }
    if (scr == aln_score && sd == rd)
      set_ambig(r1);
    return false;
  }
  bool ambig() const { return elem_ambig(r1); }
  bool empty() const { return elem_empty(r1); }
  bool sure_ambig() const { return ambig() && aln_score == max_aln_score; }
  bool should_report(bool allow) const {
    return !empty() && (allow || !ambig());
  }
};

// concordance sweep with memoized end-1 scores (abismal.cpp:1722-1831).
// score1/score2(j, elem) provide the score-only alignment of candidate j of
// each end; the native wrapper computes them in place, the two-phase device
// path reads them from a pre-scored array (kernels/banded_align.py).
template <class ScoreFn1, class ScoreFn2>
bool best_pair_impl(const Engine &E, Worker &w, PECand &res1, PECand &res2,
                    const uint8_t *pread1, int len1, const uint8_t *pread2,
                    int len2, PEBest &best, bool swap_ends, Cigar &cig1_out,
                    Cigar &cig2_out, ScoreFn1 score1, ScoreFn2 score2) {
  Elem *v1 = res1.v.data();
  Elem *v2 = res2.v.data();
  const int64_t n1 = res1.sz, n2 = res2.sz;
  const int32_t max_diffs1 = diffs_cutoff(len1, E.valid_frac);
  const int32_t max_diffs2 = diffs_cutoff(len2, E.valid_frac);
  for (int64_t k = 0; k < n1; ++k)
    w.mem_scr1[k] = 0;

  int32_t scr1 = 0;
  int32_t best_scr1 = 0, best_scr2 = 0;
  int64_t best_pos1 = 0, best_pos2 = 0;

  int64_t j1 = 0;
  while (j1 != n1 && elem_empty(v1[j1]))
    ++j1;
  int64_t j2 = 0;
  while (j2 != n2 && elem_empty(v2[j2]))
    ++j2;

  const int64_t max_dist = E.pe_max, min_dist = E.pe_min;
  while (j2 != n2 && !best.sure_ambig()) {
    const Elem &s2 = v2[j2];
    int32_t scr2 = 0;
    const int64_t lim = (int64_t)s2.p + len2;
    // rewind to the first possibly-concordant end-1 candidate
    while (j1 == n1 || (j1 != 0 && (int64_t)v1[j1].p + max_dist >= lim))
      --j1;
    while (j1 != n1 && (int64_t)v1[j1].p + max_dist < lim)
      ++j1;
    while (j1 != n1 && (int64_t)v1[j1].p + min_dist <= lim
           && !best.sure_ambig()) {
      const Elem &s1 = v1[j1];
      if (scr2 == 0)
        scr2 = score2(j2, s2);
      if (w.mem_scr1[j1] == 0) {
        scr1 = score1(j1, s1);
        w.mem_scr1[j1] = scr1;
      }
      const int32_t pair_scr = scr2 + w.mem_scr1[j1];
      const bool updated = swap_ends ? best.update(pair_scr, s2, s1)
                                     : best.update(pair_scr, s1, s2);
      if (updated) {
        // NB: scr1 may be stale when the memo was hit -- the reference
        // stores the last *computed* score (abismal.cpp:1793-1799)
        best_scr1 = scr1;
        best_scr2 = scr2;
        best_pos1 = s1.p;
        best_pos2 = s2.p;
      }
      ++j1;
    }
    ++j2;
  }

  if (best_pos1 == 0)
    return false;

  Elem s1 = swap_ends ? best.r2 : best.r1;
  Elem s2 = swap_ends ? best.r1 : best.r2;

  Cigar cigar1, cigar2;
  int64_t aln_len1, aln_len2, np1, np2;
  w.aln.align(s1.d, max_diffs1, pread1, len1, best_pos1, true);
  w.aln.cigar_len_pos(s1.d, cigar1, aln_len1, np1, best_pos1);
  s1.p = (uint32_t)np1;
  s1.d = edit_distance(best_scr1, aln_len1, cigar1);

  w.aln.align(s2.d, max_diffs2, pread2, len2, best_pos2, true);
  w.aln.cigar_len_pos(s2.d, cigar2, aln_len2, np2, best_pos2);
  s2.p = (uint32_t)np2;
  s2.d = edit_distance(best_scr2, aln_len2, cigar2);

  const int64_t frag_end = np2 + aln_len2;
  if (frag_end >= np1 + min_dist && frag_end <= np1 + max_dist) {
    best.r1 = swap_ends ? s2 : s1;
    best.r2 = swap_ends ? s1 : s2;
  }
  else {
    best.reset();
  }
  cig1_out = cigar1;
  cig2_out = cigar2;
  return true;
}

// applies ONE orientation's device-computed local mating sweep
// (pipeline.py build_stage12pe `mate` record) to the running PEBest
// state.  Exact: within one best_pair call the final update is the first
// pair by (score desc, diff-sum asc, traversal order asc) -- updates are
// strict improvements -- eq_after reproduces the tie->ambig rule against
// that winner, rec[6] carries the reference's stale memoized end-1 score
// (abismal.cpp:1793-1799), and the caller replays orientations in order
// so cross-call comparisons see the true post-traceback state (incl. the
// discordant-after-clip reset).
bool apply_device_mate(const Engine &E, Worker &w, const int32_t *rec,
                       const uint8_t *pread1, int len1,
                       const uint8_t *pread2, int len2, uint32_t sc1,
                       uint32_t sc2, PEBest &best, bool swap_ends,
                       Cigar &cig1_out, Cigar &cig2_out) {
  if (!rec[0] || best.sure_ambig())
    return false;
  const Elem e1{rec[4], sc1, (uint32_t)rec[2]};
  const Elem e2{rec[5], sc2, (uint32_t)rec[3]};
  const bool updated = swap_ends ? best.update(rec[1], e2, e1)
                                 : best.update(rec[1], e1, e2);
  if (!updated)
    return false;
  if (rec[8])  // a later pair in this sweep ties the winner
    set_ambig(best.r1);
  // winner traceback + concordance recheck (== best_pair_impl's tail)
  const int32_t max_diffs1 = diffs_cutoff(len1, E.valid_frac);
  const int32_t max_diffs2 = diffs_cutoff(len2, E.valid_frac);
  const int32_t best_scr1 = rec[6], best_scr2 = rec[7];
  const int64_t best_pos1 = (uint32_t)rec[2];
  const int64_t best_pos2 = (uint32_t)rec[3];
  Elem s1 = swap_ends ? best.r2 : best.r1;
  Elem s2 = swap_ends ? best.r1 : best.r2;
  Cigar cigar1, cigar2;
  int64_t aln_len1, aln_len2, np1, np2;
  w.aln.align(s1.d, max_diffs1, pread1, len1, best_pos1, true);
  w.aln.cigar_len_pos(s1.d, cigar1, aln_len1, np1, best_pos1);
  s1.p = (uint32_t)np1;
  s1.d = edit_distance(best_scr1, aln_len1, cigar1);
  w.aln.align(s2.d, max_diffs2, pread2, len2, best_pos2, true);
  w.aln.cigar_len_pos(s2.d, cigar2, aln_len2, np2, best_pos2);
  s2.p = (uint32_t)np2;
  s2.d = edit_distance(best_scr2, aln_len2, cigar2);
  const int64_t frag_end = np2 + aln_len2;
  if (frag_end >= np1 + E.pe_min && frag_end <= np1 + E.pe_max) {
    best.r1 = swap_ends ? s2 : s1;
    best.r2 = swap_ends ? s1 : s2;
  }
  else {
    best.reset();
  }
  cig1_out = cigar1;
  cig2_out = cigar2;
  return true;
}

bool best_pair(const Engine &E, Worker &w, PECand &res1, PECand &res2,
               const uint8_t *pread1, int len1, const uint8_t *pread2,
               int len2, PEBest &best, bool swap_ends, Cigar &cig1_out,
               Cigar &cig2_out) {
  const int32_t md1 = diffs_cutoff(len1, E.valid_frac);
  const int32_t md2 = diffs_cutoff(len2, E.valid_frac);
  return best_pair_impl(
    E, w, res1, res2, pread1, len1, pread2, len2, best, swap_ends, cig1_out,
    cig2_out,
    [&](int64_t, const Elem &s1) {
      return w.aln.align(s1.d, md1, pread1, len1, s1.p, false);
    },
    [&](int64_t, const Elem &s2) {
      return w.aln.align(s2.d, md2, pread2, len2, s2.p, false);
    });
}

// feed PE candidates into the SE fallback set (abismal.cpp:1715-1720)
inline void best_single(const PECand &pres, SECand &res) {
  for (int k = 0; k < pres.sz; ++k) {
    if (res.sure_ambig)
      break;
    const Elem &e = pres.v[k];
    res.update(false, e.d, e.f, e.p);
  }
}

// one map_fragments call (abismal.cpp:1849-1885).  pread bufs b1/b2 receive
// the encodings; returns whether the pair participated.
bool map_fragments(const Engine &E, Worker &w, const Events &ev,
                   const uint8_t *read1, int len1, const uint8_t *read2,
                   int len2, bool conv_a_rich, bool swap_ends, uint32_t sc1,
                   uint32_t sc2, int64_t u1, int64_t u2, PECand &res1,
                   PECand &res2, SECand &res_se1, SECand &res_se2,
                   PEBest &best, Cigar *c_this1, Cigar *c_this2, int b1,
                   int b2, int rcb, const int32_t *mrec = nullptr) {
  res1.reset(len1);
  res2.reset(len2);
  if (!len1 && !len2)
    return false;
  const uint8_t *pread1 = nullptr;
  const uint8_t *pread2 = nullptr;
  // device-prescored candidate slots (pipeline.py build_stage12pe): fill
  // the candidate set directly in discovery order -- exact because the
  // device only emits units whose heap never filled (constant-cutoff
  // acceptance; capacity growth and pop-replacement imply cnt = -1)
  const bool s1ok = ev.slots() && ev.sl_cnt[u1] >= 0;
  const bool s2ok = ev.slots() && ev.sl_cnt[u2] >= 0;
  const auto fill_slots = [&](int64_t u, uint32_t sc, PECand &res) {
    // re-inserts via push_heap so the heap-ARRAY layout (which
    // prepare_for_mating's stable_sort and dedup see for equal-pos
    // duplicates) matches native seeding exactly
    const int n = (int)ev.sl_cnt[u];
    const uint32_t *pp = ev.sl_pos + u * ev.k2;
    const int32_t *dd = ev.sl_ds + u * ev.k2;
    for (int i = 0; i < n; ++i) {
      res.v[res.sz] = Elem{dd[i] >> 16, sc, pp[i]};
      ++res.sz;
      push_heap(res.v.data(), res.sz);
    }
  };
  if (len1) {
    encode_read(read1, len1, conv_a_rich, w.buf[b1]);
    pread1 = w.buf[b1].data();
    if (s1ok)
      fill_slots(u1, sc1, res1);
    else
      seeds(E, w, ev, u1, pread1, len1, sc1, res1);
  }
  if (len2) {
    revcomp_ascii(read2, len2, w.rcbuf[rcb]);
    encode_read(w.rcbuf[rcb].data(), len2, conv_a_rich, w.buf[b2]);
    pread2 = w.buf[b2].data();
    if (s2ok)
      fill_slots(u2, sc2, res2);
    else
      seeds(E, w, ev, u2, pread2, len2, sc2, res2);
  }
  // select_maps (abismal.cpp:1833-1847)
  if (res1.should_align() && res2.should_align()) {
    res1.prepare_for_mating();
    res2.prepare_for_mating();
    Cigar nc1, nc2;
    bool bp;
    if (mrec && mrec[9] == 0 && s1ok && s2ok) {
      // device-resident mating sweep: the local best_pair result was
      // computed on the accelerator over these exact slot tables.
      // mrec[9] flags a max-score tie with differing diff-sums, where the
      // reference's mid-sweep sure-ambig early exit can diverge from the
      // device's min-diff-sum winner -- those take the injected-score
      // sweep below, which replays the exact sequential order
      bp = apply_device_mate(E, w, mrec, pread1, len1, pread2, len2, sc1,
                             sc2, best, swap_ends, nc1, nc2);
      w.tns[14] += 1;  // orientations decided by the device sweep
    }
    else if (s1ok || s2ok) {
      // injected scores from the device slot table, looked up by
      // (pos, diffs); anything not found (or a native-seeded mate) runs
      // the host aligner -- score-identical, the Pallas kernel is
      // int-exact vs the AVX-512 path (tests/test_pipeline.py)
      const int32_t md1 = diffs_cutoff(len1, E.valid_frac);
      const int32_t md2 = diffs_cutoff(len2, E.valid_frac);
      const auto look = [&](int64_t u, const Elem &s) -> int32_t {
        const int n = (int)ev.sl_cnt[u];
        const uint32_t *pp = ev.sl_pos + u * ev.k2;
        const int32_t *dd = ev.sl_ds + u * ev.k2;
        for (int i = 0; i < n; ++i)
          if (pp[i] == s.p && (dd[i] >> 16) == s.d)
            return dd[i] & 0xffff;
        return INT32_MIN;
      };
      bp = best_pair_impl(
        E, w, res1, res2, pread1, len1, pread2, len2, best, swap_ends,
        nc1, nc2,
        [&](int64_t, const Elem &s1) {
          if (s1ok) {
            const int32_t v = look(u1, s1);
            if (v != INT32_MIN)
              return v;
          }
          return w.aln.align(s1.d, md1, pread1, len1, s1.p, false);
        },
        [&](int64_t, const Elem &s2) {
          if (s2ok) {
            const int32_t v = look(u2, s2);
            if (v != INT32_MIN)
              return v;
          }
          return w.aln.align(s2.d, md2, pread2, len2, s2.p, false);
        });
    }
    else {
      bp = best_pair(E, w, res1, res2, pread1, len1, pread2, len2, best,
                     swap_ends, nc1, nc2);
    }
    if (bp) {
      *c_this1 = nc1;
      *c_this2 = nc2;
    }
  }
  best_single(res1, res_se1);
  best_single(res2, res_se2);
  return true;
}

// abismal.cpp:648-773 / engine.py _format_pe
int format_pe(const Engine &E, const PEBest &best, const Cigar &cig1,
              const Cigar &cig2, const uint8_t *name1, int64_t nl1,
              const uint8_t *name2, int64_t nl2, const uint8_t *read1,
              int len1, const uint8_t *read2, int len2, std::string &out) {
  if (best.empty())
    return MAP_UNMAPPED;
  const bool ambig = best.ambig();
  if (!E.allow_ambig && ambig)
    return MAP_AMBIG;
  const int64_t ro1 = cigar_rseq_ops(cig1);
  const int64_t ro2 = cigar_rseq_ops(cig2);
  int64_t ci1, r_s1, ci2, r_s2;
  const bool ok1 = chrom_lookup(E, best.r1.p, ro1, ci1, r_s1);
  const bool ok2 = chrom_lookup(E, best.r2.p, ro2, ci2, r_s2);
  if (!ok1 || !ok2 || ci1 != ci2)
    return MAP_UNMAPPED;
  const int64_t r_e1 = r_s1 + ro1;
  (void)r_e1;
  const int64_t r_e2 = r_s2 + ro2;
  const bool rc = (best.r1.f & F_RC) != 0;
  const int64_t isize = rc ? (r_s1 - r_e2) : (r_e2 - r_s1);

  uint32_t flag1 = F_PAIRED | F_PAIR_MAPPED;
  uint32_t flag2 = F_PAIRED | F_PAIR_MAPPED;
  const bool rc1 = (best.r1.f & F_RC) != 0;
  const bool rc2 = (best.r2.f & F_RC) != 0;
  if (rc1) {
    flag1 |= F_RC;
    flag2 |= F_MATE_RC;
  }
  if (rc2) {
    flag2 |= F_RC;
    flag1 |= F_MATE_RC;
  }
  if (E.allow_ambig && ambig) {
    flag1 |= F_SECONDARY;
    flag2 |= F_SECONDARY;
  }
  flag1 |= F_TFIRST;
  flag2 |= F_TLAST;

  append_sam(out, E, name1, nl1, flag1, ci1, r_s1 + 1, cig1, "=", r_s2 + 1,
             isize, read1, len1, rc1, best.r1.d,
             (best.r1.f & F_A_RICH) ? 'A' : 'T');
  append_sam(out, E, name2, nl2, flag2, ci1, r_s2 + 1, cig2, "=", r_s1 + 1,
             -isize, read2, len2, rc2, best.r2.d,
             (best.r2.f & F_A_RICH) ? 'A' : 'T');
  return ambig ? MAP_AMBIG : MAP_UNIQUE;
}

// engine.py _align_se_fallback
void align_se_fallback(const Engine &E, Worker &w, const uint8_t *pt,
                       const uint8_t *pt_rc, const uint8_t *pa,
                       const uint8_t *pa_rc, SECand &res_se, int readlen,
                       Elem &best, Cigar &cig) {
  if (pt == nullptr && pt_rc == nullptr) {
    best = Elem{MAX_DIFFS, 0, 0};
    cig.clear();
    return;
  }
  align_se_candidates(pt, pt_rc, pa, pa_rc, readlen, E.valid_frac / 2,
                      res_se, w, best, cig);
}

void finish_pe_pair(const Engine &E, Worker &w, PEBest &best, Cigar &cig1,
                    Cigar &cig2, const uint8_t *p1t, const uint8_t *p1t_rc,
                    const uint8_t *p1a, const uint8_t *p1a_rc,
                    const uint8_t *p2t, const uint8_t *p2t_rc,
                    const uint8_t *p2a, const uint8_t *p2a_rc,
                    const uint8_t *name1, int64_t nl1, const uint8_t *read1,
                    int l1, const uint8_t *name2, int64_t nl2,
                    const uint8_t *read2, int l2, bool any_ok);

// one read pair (engine.py map_pe_reads body; abismal.cpp:1887-2185)
void map_one_pe(const Engine &E, Worker &w, const Events &ev, int64_t ri,
                const uint8_t *name1, int64_t nl1, const uint8_t *read1,
                int l1, const uint8_t *name2, int64_t nl2,
                const uint8_t *read2, int l2, bool a_rich_mode,
                bool random_pbat) {
  w.se1.reset(l1);
  w.se2.reset(l2);
  PEBest best;
  best.init(l1, l2);
  Cigar cig1, cig2;
  cig1.clear();
  cig2.clear();

  // per-call pread buffer slots; preads1/preads2 collect the four
  // encodings of each end for the SE fallback (engine.py:517-549)
  const uint8_t *p1t = nullptr, *p1t_rc = nullptr, *p1a = nullptr,
                *p1a_rc = nullptr;
  const uint8_t *p2t = nullptr, *p2t_rc = nullptr, *p2a = nullptr,
                *p2a_rc = nullptr;
  bool any_ok = false;

  // per-orientation device mating records (pipeline.py stage12pe mate)
  const int32_t *mt = ev.mate ? ev.mate + ri * ev.m_stride : nullptr;
  if (!random_pbat) {
    const bool conv = a_rich_mode;
    const bool ok_pm = map_fragments(
      E, w, ev, read1, l1, read2, l2, conv, false, strand_code(false, conv),
      strand_code(true, !conv), 4 * ri, 4 * ri + 1, w.pe1, w.pe2, w.se1,
      w.se2, best, &cig1, &cig2, 0, 1, 0, mt ? mt + 0 : nullptr);
    const bool ok_mp = map_fragments(
      E, w, ev, read2, l2, read1, l1, !conv, true, strand_code(false, !conv),
      strand_code(true, conv), 4 * ri + 2, 4 * ri + 3, w.pe2, w.pe1, w.se2,
      w.se1, best, &cig2, &cig1, 2, 3, 1, mt ? mt + 10 : nullptr);
    const uint8_t *pr1 = l1 ? w.buf[0].data() : nullptr;
    const uint8_t *pr1_rc = l1 ? w.buf[3].data() : nullptr;
    const uint8_t *pr2 = l2 ? w.buf[2].data() : nullptr;
    const uint8_t *pr2_rc = l2 ? w.buf[1].data() : nullptr;
    p1t = pr1; p1t_rc = pr1_rc; p1a = pr1; p1a_rc = pr1_rc;
    p2t = pr2; p2t_rc = pr2_rc; p2a = pr2; p2a_rc = pr2_rc;
    any_ok = ok_pm || ok_mp;
  }
  else {
    // 4-way RPBAT (abismal.cpp:2031-2185)
    const bool ok1 = map_fragments(
      E, w, ev, read1, l1, read2, l2, false, false,
      strand_code(false, false), strand_code(true, true), 8 * ri,
      8 * ri + 1, w.pe1, w.pe2, w.se1, w.se2, best, &cig1, &cig2, 0, 1, 0,
      mt ? mt + 0 : nullptr);
    // event-unit ids follow the _pe_units enumeration: conv=False units
    // are 8ri+0..3 (1fF, 2rF, 2fT, 1rT), conv=True units 8ri+4..7
    // (1fT, 2rT, 2fF, 1rF)
    const bool ok2 = map_fragments(
      E, w, ev, read2, l2, read1, l1, true, true, strand_code(false, true),
      strand_code(true, false), 8 * ri + 2, 8 * ri + 3, w.pe2, w.pe1, w.se2,
      w.se1, best, &cig2, &cig1, 2, 3, 1, mt ? mt + 10 : nullptr);
    const bool ok3 = map_fragments(
      E, w, ev, read1, l1, read2, l2, true, false, strand_code(false, true),
      strand_code(true, false), 8 * ri + 4, 8 * ri + 5, w.pe1, w.pe2, w.se1,
      w.se2, best, &cig1, &cig2, 4, 5, 0, mt ? mt + 20 : nullptr);
    const bool ok4 = map_fragments(
      E, w, ev, read2, l2, read1, l1, false, true,
      strand_code(false, false), strand_code(true, true), 8 * ri + 6,
      8 * ri + 7, w.pe2, w.pe1, w.se2, w.se1, best, &cig2, &cig1, 6, 7, 1,
      mt ? mt + 30 : nullptr);
    p1t = l1 ? w.buf[0].data() : nullptr;
    p1t_rc = l1 ? w.buf[7].data() : nullptr;
    p1a = l1 ? w.buf[4].data() : nullptr;
    p1a_rc = l1 ? w.buf[3].data() : nullptr;
    p2t = l2 ? w.buf[6].data() : nullptr;
    p2t_rc = l2 ? w.buf[1].data() : nullptr;
    p2a = l2 ? w.buf[2].data() : nullptr;
    p2a_rc = l2 ? w.buf[5].data() : nullptr;
    any_ok = ok1 || ok2 || ok3 || ok4;
  }

  finish_pe_pair(E, w, best, cig1, cig2, p1t, p1t_rc, p1a, p1a_rc, p2t,
                 p2t_rc, p2a, p2a_rc, name1, nl1, read1, l1, name2, nl2,
                 read2, l2, any_ok);
}

// decide/fallback/format/stats tail of one PE pair, shared by map_one_pe
// and the two-phase device-align path (abismal.cpp:1981-2029)
void finish_pe_pair(const Engine &E, Worker &w, PEBest &best, Cigar &cig1,
                    Cigar &cig2, const uint8_t *p1t, const uint8_t *p1t_rc,
                    const uint8_t *p1a, const uint8_t *p1a_rc,
                    const uint8_t *p2t, const uint8_t *p2t_rc,
                    const uint8_t *p2a, const uint8_t *p2a_rc,
                    const uint8_t *name1, int64_t nl1, const uint8_t *read1,
                    int l1, const uint8_t *name2, int64_t nl2,
                    const uint8_t *read2, int l2, bool any_ok) {
  if (!any_ok) {
    best.reset();
    w.se1.reset_plain();
    w.se2.reset_plain();
  }

  // valid_pair check (abismal.cpp:624-631,1987-1989)
  {
    const int64_t ro1 = cigar_rseq_ops(cig1);
    const int64_t ro2 = cigar_rseq_ops(cig2);
    if (!(valid_len_ok(ro1, l1) && valid_len_ok(ro2, l2)
          && (int64_t)best.r1.d + best.r2.d
               <= (int64_t)(E.valid_frac * (ro1 + ro2))))
      best.reset();
  }

  Elem best_se1{MAX_DIFFS, 0, 0}, best_se2{MAX_DIFFS, 0, 0};
  Cigar cig_se1, cig_se2;
  cig_se1.clear();
  cig_se2.clear();
  if (!best.should_report(E.allow_ambig)) {
    align_se_fallback(E, w, p1t, p1t_rc, p1a, p1a_rc, w.se1, l1, best_se1,
                      cig_se1);
    align_se_fallback(E, w, p2t, p2t_rc, p2a, p2a_rc, w.se2, l2, best_se2,
                      cig_se2);
    cig1 = cig_se1;
    cig2 = cig_se2;
  }

  // select_output (abismal.cpp:1073-1088)
  std::string pe_lines;
  const int pe_type = format_pe(E, best, cig1, cig2, name1, nl1, name2, nl2,
                                read1, l1, read2, l2, pe_lines);
  std::string se_lines;
  PEBest best_after = best;
  if (!best.should_report(E.allow_ambig) || pe_type == MAP_UNMAPPED) {
    if (pe_type == MAP_UNMAPPED)
      best_after.reset();
    const int t1 =
      format_se(E, best_se1, cig_se1, name1, nl1, read1, l1, se_lines);
    if (t1 == MAP_UNMAPPED) {
      best_se1.d = MAX_DIFFS;
      best_se1.p = 0;
    }
    const int t2 =
      format_se(E, best_se2, cig_se2, name2, nl2, read2, l2, se_lines);
    if (t2 == MAP_UNMAPPED) {
      best_se2.d = MAX_DIFFS;
      best_se2.p = 0;
    }
  }
  w.out += pe_lines;
  w.out += se_lines;

  // stats (abismal.cpp:1034-1057); layout: pair[0..5], end1[6..11],
  // end2[12..17]
  w.st[0] += 1;
  const bool valid = !best_after.empty();
  const bool ambig = best_after.ambig();
  w.st[1] += (valid && !ambig) ? 1 : 0;
  w.st[2] += (valid && ambig) ? 1 : 0;
  w.st[3] += (!l1 || !l2) ? 1 : 0;
  if (best_after.should_report(E.allow_ambig)) {
    w.st[4] += best_after.r1.d + best_after.r2.d;
    w.st[5] += cigar_rseq_ops(cig1) + cigar_rseq_ops(cig2);
  }
  else {
    SEStatsAcc a1{w.st + 6}, a2{w.st + 12};
    a1.update(l1 == 0, !elem_empty(best_se1), elem_ambig(best_se1),
              best_se1.d, cig_se1, false);
    a2.update(l2 == 0, !elem_empty(best_se2), elem_ambig(best_se2),
              best_se2.d, cig_se2, false);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// batch entry points + C API
// ---------------------------------------------------------------------------
namespace {

Worker *get_worker(Engine &E, int i) {
  while ((int)E.workers.size() <= i)
    E.workers.push_back(new Worker(E.gnib));
  return E.workers[i];
}

template <class Fn>
void run_threads(Engine &E, int64_t n_items, int n_threads, Fn fn) {
  n_threads = std::max(1, n_threads);
  if (n_items < n_threads)
    n_threads = std::max<int64_t>(1, n_items);
  const int64_t chunk = (n_items + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) {
    Worker *w = get_worker(E, t);
    w->out.clear();
    std::memset(w->st, 0, sizeof(w->st));
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(n_items, lo + chunk);
    if (lo >= hi)
      continue;
    ts.emplace_back([=, &E]() { fn(*w, lo, hi); });
  }
  for (auto &t : ts)
    t.join();
  E.out.clear();
  for (int t = 0; t < n_threads; ++t)
    if (t < (int)E.workers.size())
      E.out += E.workers[t]->out;
}

// -----------------------------------------------------------------------
// device stage-2 finalize (pipeline.py build_stage12): one 16-byte record
// per read -- status 0 unmapped / 1 exact / 2 aligned / 3 fallback, col0 =
// status | flags<<3, col1 = candidate diffs, col2 = genome pos (u32),
// col3 = winner score.  The device already ran seed + candidate decide +
// score + winner pick; the host does traceback-for-winners, SAM text and
// stats (abismal.cpp:1435-1497 tail), or a full exact re-map for
// REC_FALLBACK reads.
// -----------------------------------------------------------------------
// cig_ops/cig_meta (nullable): device-traceback output for REC_ALIGNED
// rows (pipeline.py build_tb_block) -- run-length ops in WALK order plus
// [n_ops, soft_bottom, soft_top, new_pos]; rows with n_ops < 0 (untraced
// or op-buffer overflow) take the host traceback below, so coverage is
// per-read, never all-or-nothing.
void finalize_one_se(const Engine &E, Worker &w, const int32_t *rec,
                     int64_t ri, const uint8_t *name, int64_t name_len,
                     const uint8_t *read, int len, bool a_rich_mode,
                     bool random_pbat, const int32_t *cig_ops = nullptr,
                     const int32_t *cig_meta = nullptr,
                     int64_t tb_nops = 0) {
  const int status = rec[0] & 7;
  if (status == 3) {
    Events ev{};  // absent -> full native seeding + decide + align
    map_one_se(E, w, ev, ri, name, name_len, read, len, a_rich_mode,
               random_pbat);
    return;
  }
  Elem best{MAX_DIFFS, 0, 0};
  Cigar cig;
  cig.clear();
  if (len) {
    const uint32_t f = (uint32_t)(rec[0] >> 3);
    const int32_t d = rec[1];
    const uint32_t p = (uint32_t)rec[2];
    const int32_t scr = rec[3];
    if (status == 1) {  // exact match: default cigar, no alignment
      best = Elem{0, f, p};
      cig.set_default(len);
    }
    else if (status == 2) {  // aligned winner: traceback + validity
      const int32_t max_diffs = diffs_cutoff(len, E.valid_frac);
      best = Elem{d, f, p};
      int64_t aln_len, new_pos;
      if (cig_ops && cig_meta && cig_meta[4 * ri] >= 0) {
        // device traceback: reverse the walk-order runs, add the
        // geometric soft clips (== build_traceback's assembly)
        const int32_t *mrow = cig_meta + 4 * ri;
        const int32_t *orow = cig_ops + tb_nops * ri;
        const int n_ops = mrow[0];
        const int64_t sb = mrow[1], st_ = mrow[2];
        cig.n = 0;
        if (st_ > 0)
          cig.ops[cig.n++] = ((uint32_t)st_ << 4) | CIG_S;
        for (int k = n_ops - 1; k >= 0; --k)
          cig.ops[cig.n++] = (uint32_t)orow[k];
        if (sb > 0)
          cig.ops[cig.n++] = ((uint32_t)sb << 4) | CIG_S;
        aln_len = len - sb - st_;
        new_pos = (int64_t)(uint32_t)mrow[3];
      }
      else {
        // host traceback: encode the winning query on demand
        // (pick_pread semantics: fw -> encode(read, a_rich);
        // rc -> encode(revcomp, !a_rich))
        const uint8_t *q;
        if (f & F_RC) {
          revcomp_ascii(read, len, w.rcbuf[0]);
          encode_read(w.rcbuf[0].data(), len, (f & F_A_RICH) == 0,
                      w.buf[0]);
          q = w.buf[0].data();
        }
        else {
          encode_read(read, len, (f & F_A_RICH) != 0, w.buf[0]);
          q = w.buf[0].data();
        }
        StageTimer t(w.tns + 1);
        w.aln.align(d, max_diffs, q, len, p, true);
        w.aln.cigar_len_pos(d, cig, aln_len, new_pos, p);
      }
      best.p = (uint32_t)new_pos;
      best.d = edit_distance(scr, aln_len, cig);
      if (!(valid_len_ok(aln_len, len) && best.d <= max_diffs))
        best = Elem{MAX_DIFFS, best.f, 0};
    }
    else {  // unmapped (flags may carry the ambiguous bit)
      best = Elem{MAX_DIFFS, f, 0};
    }
    StageTimer t(w.tns + 2);
    const int map_type =
      format_se(E, best, cig, name, name_len, read, len, w.out);
    if (map_type == MAP_UNMAPPED) {
      best.d = MAX_DIFFS;
      best.p = 0;
    }
  }
  SEStatsAcc acc{w.st};
  acc.update(len == 0, !elem_empty(best), elem_ambig(best), best.d, cig,
             E.allow_ambig);
}

void sum_stats(Engine &E, int64_t *stats_out, int n) {
  for (int i = 0; i < n; ++i) {
    int64_t s = 0;
    for (auto *w : E.workers)
      s += w->st[i];
    stats_out[i] = s;
  }
}

}  // namespace

extern "C" {

// Transparent-hugepage backing for the big random-access tables
// (counters: 2 probes per offset per table into 128/344 MB arrays; gnib:
// binary-search gathers).  MADV_COLLAPSE (Linux 6.1+) synchronously
// collapses the already-RESIDENT numpy-owned pages to 2M -- measured
// +10-27% end-to-end mapping from the saved TLB walks, and collapsing
// resident pages avoids the fresh-THP-fault slow path that makes
// allocate-time madvise pathological on some VMs (which is why numpy's
// own hugepage madvise is disabled in abismal_tpu/__init__.py).  One-time
// engine-init cost; ABISMAL_THP=0 disables.
#ifndef MADV_COLLAPSE
#define MADV_COLLAPSE 25
#endif
void huge_advise(const void *p, size_t n) {
  static const bool off = [] {
    const char *e = getenv("ABISMAL_THP");
    return e && *e == '0';
  }();
  if (off)
    return;
  const size_t page = 4096;
  uintptr_t a = ((uintptr_t)p + page - 1) & ~(page - 1);
  uintptr_t e = ((uintptr_t)p + n) & ~(page - 1);
  if (e <= a)
    return;
  madvise((void *)a, e - a, MADV_HUGEPAGE);
  madvise((void *)a, e - a, MADV_COLLAPSE);
}

void *engine_create(const uint8_t *genome_nib, const uint64_t *genome_words,
                    int64_t genome_size, const uint32_t *counter2,
                    const uint32_t *counter_t, const uint32_t *counter_a,
                    const uint32_t *index2, const uint32_t *index_t,
                    const uint32_t *index_a, int64_t max_candidates,
                    const uint64_t *chrom_starts, int64_t n_chroms,
                    const char *names_blob, int allow_ambig,
                    double valid_frac, int64_t pe_min, int64_t pe_max) {
  Engine *E = new Engine();
  huge_advise(genome_nib, (size_t)genome_size);
  huge_advise(genome_words, (size_t)((genome_size + 15) / 16) * 8);
  huge_advise(counter2, ((size_t)1 << 25) * 4);
  huge_advise(counter_t, (size_t)43046722 * 4);
  huge_advise(counter_a, (size_t)43046722 * 4);
  huge_advise(index2, (size_t)counter2[1 << 25] * 4);
  huge_advise(index_t, (size_t)counter_t[43046721] * 4);
  huge_advise(index_a, (size_t)counter_a[43046721] * 4);
  E->gnib = genome_nib;
  E->gwords = genome_words;
  E->gsize = genome_size;
  E->counter2 = counter2;
  E->counter_t = counter_t;
  E->counter_a = counter_a;
  E->index2 = index2;
  E->index_t = index_t;
  E->index_a = index_a;
  E->max_candidates = max_candidates;
  E->starts = chrom_starts;
  E->n_chroms = n_chroms;
  {
    const char *p = names_blob;
    for (int64_t i = 0; i < n_chroms; ++i) {
      const char *e = std::strchr(p, '\n');
      E->names.emplace_back(p, e ? (size_t)(e - p) : std::strlen(p));
      p = e ? e + 1 : p + E->names.back().size();
    }
  }
  E->allow_ambig = allow_ambig != 0;
  E->valid_frac = valid_frac;
  E->pe_min = pe_min;
  E->pe_max = pe_max;
  return E;
}

namespace {
void se_phase_delete(SEPhase *p);
void pe_phase_delete(struct PEPhase *p);
}  // namespace

void engine_destroy(void *eng) {
  Engine *E = (Engine *)eng;
  for (auto *w : E->workers)
    delete w;
  se_phase_delete(E->se_phase);
  pe_phase_delete(E->pe_phase);
  delete E;
}

// reads_blob/read_offs: concatenated ASCII reads with n+1 offsets; names
// likewise.  ev_* may be null (pure native seeding); ev_count[u] < 0 routes
// unit u to native seeding.  stats_out: 6 counters (total, unique, ambig,
// skipped, edits, bases).
int64_t engine_map_se_batch(void *eng, const uint8_t *reads_blob,
                            const int64_t *read_offs,
                            const uint8_t *names_blob,
                            const int64_t *name_offs, int64_t n_reads,
                            int a_rich_mode, int random_pbat,
                            const uint32_t *ev_pos, const int32_t *ev_diffs,
                            const int32_t *ev_rank, const int64_t *ev_start,
                            const int64_t *ev_count, int64_t ev_boundary,
                            int n_threads, int64_t *stats_out) {
  Engine &E = *(Engine *)eng;
  Events ev{ev_pos, ev_diffs, ev_rank, ev_start, ev_count, ev_boundary};
  int max_len = 1;
  for (int64_t i = 0; i < n_reads; ++i)
    max_len = std::max<int64_t>(max_len, read_offs[i + 1] - read_offs[i]);

  run_threads(E, n_reads, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    w.aln.reset(max_len);
    for (int64_t ri = lo; ri < hi; ++ri) {
      map_one_se(E, w, ev, ri, names_blob + name_offs[ri],
                 name_offs[ri + 1] - name_offs[ri],
                 reads_blob + read_offs[ri],
                 (int)(read_offs[ri + 1] - read_offs[ri]), a_rich_mode != 0,
                 random_pbat != 0);
    }
  });
  sum_stats(E, stats_out, 6);
  return (int64_t)E.out.size();
}

// device stage-2 finalize batch entry: records is (n_reads, 4) int32
int64_t engine_se_finalize(void *eng, const uint8_t *reads_blob,
                           const int64_t *read_offs,
                           const uint8_t *names_blob,
                           const int64_t *name_offs, int64_t n_reads,
                           int a_rich_mode, int random_pbat,
                           const int32_t *records, const int32_t *cig_ops,
                           const int32_t *cig_meta, int64_t tb_nops,
                           int n_threads, int64_t *stats_out) {
  Engine &E = *(Engine *)eng;
  int max_len = 1;
  for (int64_t i = 0; i < n_reads; ++i)
    max_len = std::max<int64_t>(max_len, read_offs[i + 1] - read_offs[i]);

  run_threads(E, n_reads, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    w.aln.reset(max_len);
    for (int64_t ri = lo; ri < hi; ++ri) {
      finalize_one_se(E, w, records + 4 * ri, ri,
                      names_blob + name_offs[ri],
                      name_offs[ri + 1] - name_offs[ri],
                      reads_blob + read_offs[ri],
                      (int)(read_offs[ri + 1] - read_offs[ri]),
                      a_rich_mode != 0, random_pbat != 0, cig_ops,
                      cig_meta, tb_nops);
    }
  });
  sum_stats(E, stats_out, 6);
  return (int64_t)E.out.size();
}

// stats_out: 18 counters (pair[6], end1[6], end2[6])
int64_t engine_map_pe_batch(void *eng, const uint8_t *reads1_blob,
                            const int64_t *read1_offs,
                            const uint8_t *names1_blob,
                            const int64_t *name1_offs,
                            const uint8_t *reads2_blob,
                            const int64_t *read2_offs,
                            const uint8_t *names2_blob,
                            const int64_t *name2_offs, int64_t n_reads,
                            int a_rich_mode, int random_pbat,
                            const uint32_t *ev_pos, const int32_t *ev_diffs,
                            const int32_t *ev_rank, const int64_t *ev_start,
                            const int64_t *ev_count, int64_t ev_boundary,
                            int n_threads, int64_t *stats_out) {
  Engine &E = *(Engine *)eng;
  Events ev{ev_pos, ev_diffs, ev_rank, ev_start, ev_count, ev_boundary};
  int max_len = 1;
  for (int64_t i = 0; i < n_reads; ++i) {
    max_len = std::max<int64_t>(max_len, read1_offs[i + 1] - read1_offs[i]);
    max_len = std::max<int64_t>(max_len, read2_offs[i + 1] - read2_offs[i]);
  }

  run_threads(E, n_reads, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    w.aln.reset(max_len);
    for (int64_t ri = lo; ri < hi; ++ri) {
      map_one_pe(E, w, ev, ri, names1_blob + name1_offs[ri],
                 name1_offs[ri + 1] - name1_offs[ri],
                 reads1_blob + read1_offs[ri],
                 (int)(read1_offs[ri + 1] - read1_offs[ri]),
                 names2_blob + name2_offs[ri],
                 name2_offs[ri + 1] - name2_offs[ri],
                 reads2_blob + read2_offs[ri],
                 (int)(read2_offs[ri + 1] - read2_offs[ri]),
                 a_rich_mode != 0, random_pbat != 0);
    }
  });
  sum_stats(E, stats_out, 18);
  return (int64_t)E.out.size();
}

// PE finalize from device stage-1+2 candidate slots (pipeline.py
// build_stage12pe): per-unit prescored candidate lists replace both the
// event stream and the host score pass; units with cnt < 0 re-seed
// natively.  Output is byte-identical at any fallback rate.
// ---------------------------------------------------------------------------
// dense unit-matrix prep for the fused device programs (pipeline.py
// _se_units_dense/_pe_units_dense): encodes reads into the device upload
// format (two 4-bit bases per byte) without per-read Python work.  Rows
// follow the unit-id enumeration; empty or oversized reads produce
// zero-length rows, oversized ones additionally flag `oversized`.
// ---------------------------------------------------------------------------
namespace {

inline void prep_pack_row(const uint8_t *ascii, int len, bool a_rich,
                          bool rc, std::vector<uint8_t> &nib,
                          std::vector<uint8_t> &rcb, uint8_t *row,
                          int32_t *len_out) {
  const uint8_t *src = ascii;
  if (rc) {
    revcomp_ascii(ascii, len, rcb);
    src = rcb.data();
  }
  encode_read(src, len, a_rich, nib);
  for (int i = 0; i < len; ++i)
    row[i >> 1] |= (uint8_t)(nib[i] << ((i & 1) * 4));
  *len_out = len;
}

}  // namespace

extern "C" void engine_prep_se_units(
  void *eng, const uint8_t *reads_blob, const int64_t *offs,
  int64_t n_reads, int a_rich_mode, int random_pbat, int64_t lmax,
  int64_t stride, uint8_t *pnib, int32_t *lens, uint8_t *oversized,
  int n_threads) {
  Engine &E = *(Engine *)eng;
  const int per = random_pbat ? 4 : 2;
  run_threads(E, n_reads, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    (void)w;
    std::vector<uint8_t> nib, rcb;
    for (int64_t ri = lo; ri < hi; ++ri) {
      const uint8_t *r = reads_blob + offs[ri];
      const int len = (int)(offs[ri + 1] - offs[ri]);
      uint8_t *rows = pnib + (int64_t)per * ri * stride;
      if (len == 0 || len > lmax) {
        oversized[ri] = len > lmax;
        continue;  // rows stay zero, lens stay zero
      }
      int32_t *lo_lens = lens + per * ri;
      if (!random_pbat) {
        prep_pack_row(r, len, a_rich_mode != 0, false, nib, rcb, rows,
                      lo_lens);
        prep_pack_row(r, len, a_rich_mode == 0, true, nib, rcb,
                      rows + stride, lo_lens + 1);
      }
      else {
        prep_pack_row(r, len, false, false, nib, rcb, rows, lo_lens);
        prep_pack_row(r, len, true, false, nib, rcb, rows + stride,
                      lo_lens + 1);
        prep_pack_row(r, len, false, true, nib, rcb, rows + 2 * stride,
                      lo_lens + 2);
        prep_pack_row(r, len, true, true, nib, rcb, rows + 3 * stride,
                      lo_lens + 3);
      }
    }
  });
}

extern "C" void engine_prep_pe_units(
  void *eng, const uint8_t *r1_blob, const int64_t *o1,
  const uint8_t *r2_blob, const int64_t *o2, int64_t n_pairs,
  int a_rich_mode, int random_pbat, int64_t lmax, int64_t stride,
  uint8_t *pnib, int32_t *lens, uint8_t *oversized, int n_threads) {
  Engine &E = *(Engine *)eng;
  const int per = random_pbat ? 8 : 4;
  run_threads(E, n_pairs, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    (void)w;
    std::vector<uint8_t> nib, rcb;
    for (int64_t ri = lo; ri < hi; ++ri) {
      const uint8_t *r1 = r1_blob + o1[ri];
      const int l1 = (int)(o1[ri + 1] - o1[ri]);
      const uint8_t *r2 = r2_blob + o2[ri];
      const int l2 = (int)(o2[ri + 1] - o2[ri]);
      if ((l1 && l1 > lmax) || (l2 && l2 > lmax)) {
        oversized[ri] = 1;
        continue;
      }
      uint8_t *rows = pnib + (int64_t)per * ri * stride;
      int32_t *lp = lens + per * ri;
      const int n_conv = random_pbat ? 2 : 1;
      for (int c = 0; c < n_conv; ++c) {
        const bool conv = random_pbat ? (c != 0) : (a_rich_mode != 0);
        if (l1)
          prep_pack_row(r1, l1, conv, false, nib, rcb, rows, lp);
        if (l2) {
          prep_pack_row(r2, l2, conv, true, nib, rcb, rows + stride,
                        lp + 1);
          prep_pack_row(r2, l2, !conv, false, nib, rcb, rows + 2 * stride,
                        lp + 2);
        }
        if (l1)
          prep_pack_row(r1, l1, !conv, true, nib, rcb, rows + 3 * stride,
                        lp + 3);
        rows += 4 * stride;
        lp += 4;
      }
    }
  });
}

int64_t engine_map_pe_batch_slots(
  void *eng, const uint8_t *reads1_blob, const int64_t *read1_offs,
  const uint8_t *names1_blob, const int64_t *name1_offs,
  const uint8_t *reads2_blob, const int64_t *read2_offs,
  const uint8_t *names2_blob, const int64_t *name2_offs, int64_t n_reads,
  int a_rich_mode, int random_pbat, const uint32_t *sl_pos,
  const int32_t *sl_ds, const int32_t *sl_cnt, int64_t k2,
  const int32_t *mate, int64_t m_stride, int n_threads,
  int64_t *stats_out) {
  Engine &E = *(Engine *)eng;
  Events ev{};
  ev.sl_pos = sl_pos;
  ev.sl_ds = sl_ds;
  ev.sl_cnt = sl_cnt;
  ev.k2 = k2;
  ev.mate = mate;
  ev.m_stride = m_stride;
  int max_len = 1;
  for (int64_t i = 0; i < n_reads; ++i) {
    max_len = std::max<int64_t>(max_len, read1_offs[i + 1] - read1_offs[i]);
    max_len = std::max<int64_t>(max_len, read2_offs[i + 1] - read2_offs[i]);
  }
  run_threads(E, n_reads, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    w.aln.reset(max_len);
    for (int64_t ri = lo; ri < hi; ++ri) {
      map_one_pe(E, w, ev, ri, names1_blob + name1_offs[ri],
                 name1_offs[ri + 1] - name1_offs[ri],
                 reads1_blob + read1_offs[ri],
                 (int)(read1_offs[ri + 1] - read1_offs[ri]),
                 names2_blob + name2_offs[ri],
                 name2_offs[ri + 1] - name2_offs[ri],
                 reads2_blob + read2_offs[ri],
                 (int)(read2_offs[ri + 1] - read2_offs[ri]),
                 a_rich_mode != 0, random_pbat != 0);
    }
  });
  sum_stats(E, stats_out, 18);
  return (int64_t)E.out.size();
}


// ---------------------------------------------------------------------------
// two-phase SE mapping for device-side batched alignment: phase 1 seeds and
// emits alignment jobs (read, encoding, pos, band width, qsz); the caller
// scores them (Pallas banded kernel on the accelerator, or any provider);
// phase 2 replays the exact selection/traceback/format logic with the
// provided scores.  A score of INT32_MIN makes phase 2 compute that job
// natively (used for reads whose queries are not resident on the device).
// ---------------------------------------------------------------------------
namespace {

struct SEState {
  Elem cand[SE_MAX];
  int n_cand = 0;  // -1: no alignment phase (empty read or exact match)
  Elem best{MAX_DIFFS, 0, 0};
  int len = 0;
  std::vector<uint8_t> enc[4];  // pt, pt_rc, pa, pa_rc copies
  std::vector<int32_t> jobs;    // 5 ints per job
  int64_t job_start = 0;
};

struct SEPhase {
  std::vector<SEState> states;
  std::vector<int32_t> jobs;  // flattened, 5 ints per job
  const uint8_t *reads_blob;
  const int64_t *read_offs;
  const uint8_t *names_blob;
  const int64_t *name_offs;
  int64_t n_reads = 0;
  bool a_rich = false, rpbat = false;
};

void se_phase_delete(SEPhase *p) { delete p; }

SEPhase &phase_of(Engine &E) {
  if (!E.se_phase)
    E.se_phase = new SEPhase();
  return *E.se_phase;
}

inline int enc_sel(const Elem &e) {
  // index into (pt, pt_rc, pa, pa_rc), mirroring pick_pread
  if (e.f & F_RC)
    return (e.f & F_A_RICH) ? 1 : 3;
  return (e.f & F_A_RICH) ? 2 : 0;
}

}  // namespace

extern "C" {

int64_t
engine_se_phase1(void *eng, const uint8_t *reads_blob,
                 const int64_t *read_offs, const uint8_t *names_blob,
                 const int64_t *name_offs, int64_t n_reads, int a_rich_mode,
                 int random_pbat, const uint32_t *ev_pos,
                 const int32_t *ev_diffs, const int32_t *ev_rank,
                 const int64_t *ev_start, const int64_t *ev_count,
                 int64_t ev_boundary, int n_threads) {
  Engine &E = *(Engine *)eng;
  Events ev{ev_pos, ev_diffs, ev_rank, ev_start, ev_count, ev_boundary};
  SEPhase &P = phase_of(E);
  P.states.assign(n_reads, SEState());
  P.reads_blob = reads_blob;
  P.read_offs = read_offs;
  P.names_blob = names_blob;
  P.name_offs = name_offs;
  P.n_reads = n_reads;
  P.a_rich = a_rich_mode != 0;
  P.rpbat = random_pbat != 0;

  run_threads(E, n_reads, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    for (int64_t ri = lo; ri < hi; ++ri) {
      SEState &st = P.states[ri];
      const uint8_t *read = reads_blob + read_offs[ri];
      const int len = (int)(read_offs[ri + 1] - read_offs[ri]);
      st.len = len;
      st.n_cand = -1;
      if (!len)
        continue;
      w.se.reset(len);
      const uint8_t *enc[4];
      se_seed_read(E, w, ev, ri, read, len, P.a_rich, P.rpbat, enc);
      st.best = w.se.best;
      // keep the encodings for phase-2 traceback / host-side scoring
      st.enc[0].assign(enc[0], enc[0] + len);
      st.enc[1].assign(enc[1], enc[1] + len);
      if (P.rpbat) {
        st.enc[2].assign(enc[2], enc[2] + len);
        st.enc[3].assign(enc[3], enc[3] + len);
      }
      if (w.se.has_exact())
        continue;
      st.n_cand = w.se.prepare_for_alignments(st.cand);
      const int32_t max_diffs = diffs_cutoff(len, E.valid_frac);
      int i = 0;
      while (i < st.n_cand && elem_empty(st.cand[i]))
        ++i;
      for (; i < st.n_cand; ++i) {
        const Elem &e = st.cand[i];
        if (valid_hit(e.d, len)) {
          st.jobs.push_back((int32_t)ri);
          st.jobs.push_back(enc_sel(e));
          st.jobs.push_back((int32_t)e.p);
          st.jobs.push_back(band_width(e.d, max_diffs));
          st.jobs.push_back(len);
        }
      }
    }
  });
  E.out.clear();  // run_threads collected per-worker text; none is produced

  P.jobs.clear();
  int64_t n_jobs = 0;
  for (auto &st : P.states) {
    st.job_start = n_jobs;
    n_jobs += (int64_t)st.jobs.size() / 5;
    P.jobs.insert(P.jobs.end(), st.jobs.begin(), st.jobs.end());
  }
  return n_jobs;
}

const int32_t *
engine_jobs_ptr(void *eng) {
  return phase_of(*(Engine *)eng).jobs.data();
}

int64_t
engine_se_phase2(void *eng, const int32_t *scores, int n_threads,
                 int64_t *stats_out) {
  Engine &E = *(Engine *)eng;
  SEPhase &P = phase_of(E);
  int max_len = 1;
  for (int64_t i = 0; i < P.n_reads; ++i)
    max_len = std::max(max_len, P.states[i].len);

  run_threads(E, P.n_reads, n_threads,
              [&](Worker &w, int64_t lo, int64_t hi) {
    w.aln.reset(max_len);
    for (int64_t ri = lo; ri < hi; ++ri) {
      SEState &st = P.states[ri];
      const uint8_t *read = P.reads_blob + P.read_offs[ri];
      const uint8_t *name = P.names_blob + P.name_offs[ri];
      const int64_t name_len = P.name_offs[ri + 1] - P.name_offs[ri];
      Elem best{MAX_DIFFS, 0, 0};
      Cigar cig;
      cig.clear();
      if (st.len) {
        // rebuild the candidate set snapshot; prepare_for_alignments is
        // idempotent on the already sorted+deduped list
        w.se.reset(st.len);
        w.se.best = st.best;
        if (st.n_cand >= 0) {
          for (int i = 0; i < st.n_cand; ++i)
            w.se.v[i] = st.cand[i];
          w.se.sz = std::max(st.n_cand, 1);
        }
        const uint8_t *pt = st.enc[0].data();
        const uint8_t *pt_rc = st.enc[1].data();
        const uint8_t *pa = P.rpbat ? st.enc[2].data() : pt;
        const uint8_t *pa_rc = P.rpbat ? st.enc[3].data() : pt_rc;
        int64_t jp = st.job_start;
        align_se_candidates_impl(
          pt, pt_rc, pa, pa_rc, st.len, E.valid_frac, w.se, w, best, cig,
          [&](const Elem &e, const uint8_t *q, int32_t max_diffs) {
            const int32_t s = scores[jp++];
            if (s != INT32_MIN)
              return s;
            return (int32_t)w.aln.align(e.d, max_diffs, q, st.len, e.p,
                                        false);
          });
        const int map_type =
          format_se(E, best, cig, name, name_len, read, st.len, w.out);
        if (map_type == MAP_UNMAPPED) {
          best.d = MAX_DIFFS;
          best.p = 0;
        }
      }
      SEStatsAcc acc{w.st};
      acc.update(st.len == 0, !elem_empty(best), elem_ambig(best), best.d,
                 cig, E.allow_ambig);
    }
  });
  sum_stats(E, stats_out, 6);
  return (int64_t)E.out.size();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// two-phase PE mapping for device-side batched alignment: phase 1 seeds all
// fragment configurations of every pair (2 for directional protocols, 4 for
// RPBAT), snapshots the post-mating candidate lists, and emits one alignment
// job per candidate of each end; the caller scores them (Pallas banded
// kernel); phase 2 replays the exact concordance sweeps -- including the
// memoized/stale-scr1 semantics (abismal.cpp:1793-1799) -- with the provided
// scores, then runs the decide/fallback/format tail.  INT32_MIN scores are
// computed natively in phase 2 (jobs beyond the device cap).
// ---------------------------------------------------------------------------
namespace {

struct PEFragCfg {
  bool read2_first;  // fragment end-1 is the mate (swapped configs)
  bool conv;         // conversion used to encode this fragment's queries
  uint32_t sc1, sc2;
  int du1, du2;      // unit-id offsets within the pair's unit block
  int b1, b2, rcb;   // Worker buffer slots (match map_one_pe exactly)
};

inline int pe_cfgs(bool a_rich, bool rpbat, PEFragCfg *out) {
  if (!rpbat) {
    const bool conv = a_rich;
    out[0] = {false, conv, strand_code(false, conv), strand_code(true, !conv),
              0, 1, 0, 1, 0};
    out[1] = {true, !conv, strand_code(false, !conv), strand_code(true, conv),
              2, 3, 2, 3, 1};
    return 2;
  }
  out[0] = {false, false, strand_code(false, false), strand_code(true, true),
            0, 1, 0, 1, 0};
  out[1] = {true, true, strand_code(false, true), strand_code(true, false),
            2, 3, 2, 3, 1};
  out[2] = {false, true, strand_code(false, true), strand_code(true, false),
            4, 5, 4, 5, 0};
  out[3] = {true, false, strand_code(false, false), strand_code(true, true),
            6, 7, 6, 7, 1};
  return 4;
}

struct PEFragSnap {
  std::vector<Elem> c1, c2;    // post-prepare_for_mating candidate lists
  int64_t js1 = 0, js2 = 0;    // job bases within the pair's job block
  bool swept = false;
  bool ok = false;             // map_fragments participation (len1 || len2)
};

struct PEPairState {
  int l1 = 0, l2 = 0;
  PEFragSnap frag[4];
  SECand se1, se2;             // SE fallback sets after all configs
  std::vector<uint8_t> encb[8];
  std::vector<int32_t> jobs;   // 5 ints per job
  int64_t job_start = 0;
};

struct PEPhase {
  std::vector<PEPairState> states;
  std::vector<int32_t> jobs;
  const uint8_t *r1_blob = nullptr, *n1_blob = nullptr;
  const int64_t *r1_offs = nullptr, *n1_offs = nullptr;
  const uint8_t *r2_blob = nullptr, *n2_blob = nullptr;
  const int64_t *r2_offs = nullptr, *n2_offs = nullptr;
  int64_t n_reads = 0;
  bool a_rich = false, rpbat = false;
};

void pe_phase_delete(PEPhase *p) { delete p; }

PEPhase &pe_phase_of(Engine &E) {
  if (!E.pe_phase)
    E.pe_phase = new PEPhase();
  return *E.pe_phase;
}

}  // namespace

extern "C" {

int64_t
engine_pe_phase1(void *eng, const uint8_t *reads1_blob,
                 const int64_t *read1_offs, const uint8_t *names1_blob,
                 const int64_t *name1_offs, const uint8_t *reads2_blob,
                 const int64_t *read2_offs, const uint8_t *names2_blob,
                 const int64_t *name2_offs, int64_t n_reads, int a_rich_mode,
                 int random_pbat, const uint32_t *ev_pos,
                 const int32_t *ev_diffs, const int32_t *ev_rank,
                 const int64_t *ev_start, const int64_t *ev_count,
                 int64_t ev_boundary, int n_threads) {
  Engine &E = *(Engine *)eng;
  Events ev{ev_pos, ev_diffs, ev_rank, ev_start, ev_count, ev_boundary};
  PEPhase &P = pe_phase_of(E);
  P.states.assign(n_reads, PEPairState());
  P.r1_blob = reads1_blob;
  P.r1_offs = read1_offs;
  P.n1_blob = names1_blob;
  P.n1_offs = name1_offs;
  P.r2_blob = reads2_blob;
  P.r2_offs = read2_offs;
  P.n2_blob = names2_blob;
  P.n2_offs = name2_offs;
  P.n_reads = n_reads;
  P.a_rich = a_rich_mode != 0;
  P.rpbat = random_pbat != 0;
  const int per = P.rpbat ? 8 : 4;
  const int n_slots = P.rpbat ? 8 : 4;

  run_threads(E, n_reads, n_threads, [&](Worker &w, int64_t lo, int64_t hi) {
    PEFragCfg cfg[4];
    const int nf = pe_cfgs(P.a_rich, P.rpbat, cfg);
    for (int64_t ri = lo; ri < hi; ++ri) {
      PEPairState &st = P.states[ri];
      const uint8_t *read1 = reads1_blob + read1_offs[ri];
      const int l1 = (int)(read1_offs[ri + 1] - read1_offs[ri]);
      const uint8_t *read2 = reads2_blob + read2_offs[ri];
      const int l2 = (int)(read2_offs[ri + 1] - read2_offs[ri]);
      st.l1 = l1;
      st.l2 = l2;
      w.se1.reset(l1);
      w.se2.reset(l2);
      for (int s = 0; s < n_slots; ++s)
        w.buf[s].clear();
      for (int f = 0; f < nf; ++f) {
        const PEFragCfg &c = cfg[f];
        PEFragSnap &sn = st.frag[f];
        const uint8_t *ra = c.read2_first ? read2 : read1;
        const int la = c.read2_first ? l2 : l1;
        const uint8_t *rb = c.read2_first ? read1 : read2;
        const int lb = c.read2_first ? l1 : l2;
        PECand &res1 = w.pe1;
        PECand &res2 = w.pe2;
        res1.reset(la);
        res2.reset(lb);
        sn.ok = la || lb;
        if (!sn.ok)
          continue;
        if (la) {
          encode_read(ra, la, c.conv, w.buf[c.b1]);
          seeds(E, w, ev, (int64_t)per * ri + c.du1, w.buf[c.b1].data(), la,
                c.sc1, res1);
        }
        if (lb) {
          revcomp_ascii(rb, lb, w.rcbuf[c.rcb]);
          encode_read(w.rcbuf[c.rcb].data(), lb, c.conv, w.buf[c.b2]);
          seeds(E, w, ev, (int64_t)per * ri + c.du2, w.buf[c.b2].data(), lb,
                c.sc2, res2);
        }
        if (res1.should_align() && res2.should_align()) {
          res1.prepare_for_mating();
          res2.prepare_for_mating();
          sn.swept = true;
          sn.c1.assign(res1.v.begin(), res1.v.begin() + res1.sz);
          sn.c2.assign(res2.v.begin(), res2.v.begin() + res2.sz);
          const int32_t md1 = diffs_cutoff(la, E.valid_frac);
          const int32_t md2 = diffs_cutoff(lb, E.valid_frac);
          sn.js1 = (int64_t)st.jobs.size() / 5;
          for (const Elem &e : sn.c1) {
            st.jobs.push_back((int32_t)ri);
            st.jobs.push_back(c.b1);
            st.jobs.push_back((int32_t)e.p);
            st.jobs.push_back(band_width(e.d, md1));
            st.jobs.push_back(la);
          }
          sn.js2 = (int64_t)st.jobs.size() / 5;
          for (const Elem &e : sn.c2) {
            st.jobs.push_back((int32_t)ri);
            st.jobs.push_back(c.b2);
            st.jobs.push_back((int32_t)e.p);
            st.jobs.push_back(band_width(e.d, md2));
            st.jobs.push_back(lb);
          }
        }
        best_single(res1, c.read2_first ? w.se2 : w.se1);
        best_single(res2, c.read2_first ? w.se1 : w.se2);
      }
      st.se1 = w.se1;
      st.se2 = w.se2;
      for (int s = 0; s < n_slots; ++s)
        st.encb[s] = w.buf[s];
    }
  });
  E.out.clear();  // no text is produced in phase 1

  P.jobs.clear();
  int64_t n_jobs = 0;
  for (auto &st : P.states) {
    st.job_start = n_jobs;
    n_jobs += (int64_t)st.jobs.size() / 5;
    P.jobs.insert(P.jobs.end(), st.jobs.begin(), st.jobs.end());
  }
  return n_jobs;
}

const int32_t *
engine_pe_jobs_ptr(void *eng) {
  return pe_phase_of(*(Engine *)eng).jobs.data();
}

int64_t
engine_pe_phase2(void *eng, const int32_t *scores, int n_threads,
                 int64_t *stats_out) {
  Engine &E = *(Engine *)eng;
  PEPhase &P = pe_phase_of(E);
  int max_len = 1;
  for (auto &st : P.states) {
    max_len = std::max(max_len, st.l1);
    max_len = std::max(max_len, st.l2);
  }

  run_threads(E, P.n_reads, n_threads,
              [&](Worker &w, int64_t lo, int64_t hi) {
    w.aln.reset(max_len);
    PEFragCfg cfg[4];
    const int nf = pe_cfgs(P.a_rich, P.rpbat, cfg);
    for (int64_t ri = lo; ri < hi; ++ri) {
      PEPairState &st = P.states[ri];
      const uint8_t *read1 = P.r1_blob + P.r1_offs[ri];
      const uint8_t *name1 = P.n1_blob + P.n1_offs[ri];
      const int64_t nl1 = P.n1_offs[ri + 1] - P.n1_offs[ri];
      const uint8_t *read2 = P.r2_blob + P.r2_offs[ri];
      const uint8_t *name2 = P.n2_blob + P.n2_offs[ri];
      const int64_t nl2 = P.n2_offs[ri + 1] - P.n2_offs[ri];
      const int l1 = st.l1, l2 = st.l2;

      w.se1 = st.se1;
      w.se2 = st.se2;
      PEBest best;
      best.init(l1, l2);
      Cigar cig1, cig2;
      cig1.clear();
      cig2.clear();
      bool any_ok = false;
      auto enc_of = [&](int slot) -> const uint8_t * {
        return st.encb[slot].empty() ? nullptr : st.encb[slot].data();
      };
      for (int f = 0; f < nf; ++f) {
        const PEFragCfg &c = cfg[f];
        PEFragSnap &sn = st.frag[f];
        any_ok = any_ok || sn.ok;
        if (!sn.swept)
          continue;
        const int la = c.read2_first ? l2 : l1;
        const int lb = c.read2_first ? l1 : l2;
        PECand &res1 = w.pe1;
        PECand &res2 = w.pe2;
        res1.sz = (int)sn.c1.size();
        std::copy(sn.c1.begin(), sn.c1.end(), res1.v.begin());
        res2.sz = (int)sn.c2.size();
        std::copy(sn.c2.begin(), sn.c2.end(), res2.v.begin());
        const uint8_t *pr1 = enc_of(c.b1);
        const uint8_t *pr2 = enc_of(c.b2);
        const int32_t md1 = diffs_cutoff(la, E.valid_frac);
        const int32_t md2 = diffs_cutoff(lb, E.valid_frac);
        const int32_t *s1 = scores + st.job_start + sn.js1;
        const int32_t *s2 = scores + st.job_start + sn.js2;
        Cigar nc1, nc2;
        const bool bp = best_pair_impl(
          E, w, res1, res2, pr1, la, pr2, lb, best, c.read2_first, nc1, nc2,
          [&](int64_t j, const Elem &e) {
            const int32_t v = s1[j];
            if (v != INT32_MIN)
              return v;
            return (int32_t)w.aln.align(e.d, md1, pr1, la, e.p, false);
          },
          [&](int64_t j, const Elem &e) {
            const int32_t v = s2[j];
            if (v != INT32_MIN)
              return v;
            return (int32_t)w.aln.align(e.d, md2, pr2, lb, e.p, false);
          });
        if (bp) {
          *(c.read2_first ? &cig2 : &cig1) = nc1;
          *(c.read2_first ? &cig1 : &cig2) = nc2;
        }
      }

      const uint8_t *p1t, *p1t_rc, *p1a, *p1a_rc;
      const uint8_t *p2t, *p2t_rc, *p2a, *p2a_rc;
      if (!P.rpbat) {
        p1t = p1a = enc_of(0);
        p1t_rc = p1a_rc = enc_of(3);
        p2t = p2a = enc_of(2);
        p2t_rc = p2a_rc = enc_of(1);
      }
      else {
        p1t = enc_of(0);
        p1t_rc = enc_of(7);
        p1a = enc_of(4);
        p1a_rc = enc_of(3);
        p2t = enc_of(6);
        p2t_rc = enc_of(1);
        p2a = enc_of(2);
        p2a_rc = enc_of(5);
      }
      finish_pe_pair(E, w, best, cig1, cig2, p1t, p1t_rc, p1a, p1a_rc, p2t,
                     p2t_rc, p2a, p2a_rc, name1, nl1, read1, l1, name2, nl2,
                     read2, l2, any_ok);
    }
  });
  sum_stats(E, stats_out, 18);
  return (int64_t)E.out.size();
}

}  // extern "C"

const char *engine_out_ptr(void *eng) { return ((Engine *)eng)->out.data(); }

}  // extern "C"

// ===========================================================================
// streaming full-native mapping loop: FASTQ(.gz) -> map -> ordered SAM.
//
// This is the TPU-framework equivalent of the reference's `runner`
// (abismal.cpp:2187-2263): N worker threads claim read batches under a
// read mutex, map them lock-free, and emit records under a write mutex --
// except output here is ordered by batch sequence number (condition
// variable hand-off), so the result is byte-identical at any thread
// count, where the reference is nondeterministic for -t > 1.  Parsing
// (with the reference's read-cleaning rules, abismal.cpp:164-201) and SAM
// writing both live inside this loop, so no Python runs per read.
// ===========================================================================
namespace {

// buffered line reader over gzFile (plain files read transparently)
struct GzLines {
  gzFile f = nullptr;
  std::vector<char> buf;
  int64_t pos = 0, len = 0;
  bool hit_eof = false;
  int64_t line_no = 0;  // 0-based count of lines consumed

  explicit GzLines(const char *path) {
    f = gzopen(path, "rb");
    if (f) {
      gzbuffer(f, 1 << 20);
      buf.resize(1 << 22);
    }
  }
  ~GzLines() {
    if (f)
      gzclose(f);
  }
  bool ok() const { return f != nullptr; }

  // consumes n lines without materializing them (multi-host shard skip)
  void skip_lines(int64_t n) {
    while (n > 0) {
      if (pos >= len) {
        if (hit_eof)
          return;
        len = gzread(f, buf.data(), (unsigned)buf.size());
        pos = 0;
        if (len <= 0) {
          hit_eof = true;
          len = 0;
          return;
        }
      }
      const char *base = buf.data() + pos;
      const char *nl = (const char *)memchr(base, '\n', len - pos);
      if (nl) {
        pos += (nl - base) + 1;
        ++line_no;
        --n;
      }
      else {
        pos = len;
      }
    }
  }

  // appends the next line (no '\n') to out; false at EOF with nothing read
  bool next_line(std::string &out) {
    out.clear();
    for (;;) {
      if (pos >= len) {
        if (hit_eof)
          return !out.empty();
        len = gzread(f, buf.data(), (unsigned)buf.size());
        pos = 0;
        if (len <= 0) {
          hit_eof = true;
          len = 0;
          if (out.empty())
            return false;
          ++line_no;
          return true;
        }
      }
      const char *base = buf.data() + pos;
      const char *nl = (const char *)memchr(base, '\n', len - pos);
      if (nl) {
        out.append(base, nl - base);
        pos += (nl - base) + 1;
        ++line_no;
        return true;
      }
      out.append(base, len - pos);
      pos = len;
    }
  }
  int64_t byte_pos() const { return f ? (int64_t)gzoffset(f) : 0; }
};

struct StreamBatch {
  std::string rblob, nblob;
  std::vector<int64_t> roffs, noffs;
  int64_t n = 0;
  int max_len = 1;
};

// ---------------------------------------------------------------------------
// native BAM output (io/bam.py port): SAM-text -> binary records + BGZF.
// Record layout and aux-type narrowing mirror the Python BamWriter exactly,
// so both paths produce identical uncompressed BAM payloads (BGZF block
// boundaries differ; workers compress their own batches in parallel).
// ---------------------------------------------------------------------------

const uint8_t BGZF_EOF_BLOCK[28] = {
  0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
  0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
  0x00, 0x00, 0x00, 0x00};

// compresses payload into <= 65000-byte BGZF members appended to out
void bgzf_compress(const char *payload, size_t n, std::string &out) {
  size_t off = 0;
  std::vector<unsigned char> cbuf(1 << 17);
  do {
    const size_t chunk = std::min<size_t>(65000, n - off);
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    deflateInit2(&zs, 6, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
    zs.next_in = reinterpret_cast<Bytef *>(const_cast<char *>(payload + off));
    zs.avail_in = (uInt)chunk;
    zs.next_out = cbuf.data();
    zs.avail_out = (uInt)cbuf.size();
    deflate(&zs, Z_FINISH);
    const size_t clen = cbuf.size() - zs.avail_out;
    deflateEnd(&zs);
    const uint32_t crc =
      crc32(crc32(0, nullptr, 0), (const Bytef *)(payload + off),
            (uInt)chunk);
    const uint16_t bsize = (uint16_t)(clen + 25);  // total block size - 1
    char hdr[18] = {0x1f, (char)0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0};
    hdr[10] = 6;  // XLEN
    hdr[12] = 'B';
    hdr[13] = 'C';
    hdr[14] = 2;
    std::memcpy(hdr + 16, &bsize, 2);
    out.append(hdr, 18);
    out.append((const char *)cbuf.data(), clen);
    const uint32_t isize = (uint32_t)chunk;
    out.append((const char *)&crc, 4);
    out.append((const char *)&isize, 4);
    off += chunk;
  } while (off < n);
}

struct Nt16Table {
  uint8_t t[256];
  Nt16Table() {
    const char *s = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 256; ++i)
      t[i] = 15;
    for (int i = 0; i < 16; ++i) {
      t[(uint8_t)s[i]] = (uint8_t)i;
      t[(uint8_t)std::tolower(s[i])] = (uint8_t)i;
    }
  }
};
const Nt16Table NT16;

inline int bam_reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14)
    return (int)(((1 << 15) - 1) / 7 + (beg >> 14));
  if (beg >> 17 == end >> 17)
    return (int)(((1 << 12) - 1) / 7 + (beg >> 17));
  if (beg >> 20 == end >> 20)
    return (int)(((1 << 9) - 1) / 7 + (beg >> 20));
  if (beg >> 23 == end >> 23)
    return (int)(((1 << 6) - 1) / 7 + (beg >> 23));
  if (beg >> 26 == end >> 26)
    return (int)(((1 << 3) - 1) / 7 + (beg >> 26));
  return 0;
}

inline void put_i32(std::string &o, int32_t v) {
  o.append((const char *)&v, 4);
}

// converts one batch of SAM text lines into BAM record payload bytes;
// ref_idx maps RNAME -> refID.  Returns false on a malformed line (cannot
// happen for our own formatter's output; defensive).
bool sam_text_to_bam(const std::string &text,
                     const std::unordered_map<std::string, int> &ref_idx,
                     std::string &payload) {
  const char *p = text.data();
  const char *end = p + text.size();
  std::string name_b;
  while (p < end) {
    const char *nl = (const char *)memchr(p, '\n', end - p);
    if (!nl)
      nl = end;
    // split into 11+ tab fields
    const char *f[14];
    int nf = 0;
    f[nf++] = p;
    for (const char *q = p; q < nl; ++q)
      if (*q == '\t') {
        if (nf == 14)
          return false;  // more aux tags than the field table holds
        f[nf++] = q + 1;
      }
    if (nf < 11)
      return false;
    auto fl = [&](int i) {  // length of field i
      const char *e = (i + 1 < nf) ? f[i + 1] - 1 : nl;
      return (size_t)(e - f[i]);
    };
    auto fint = [&](int i) { return atoll(std::string(f[i], fl(i)).c_str()); };
    const std::string rname(f[2], fl(2));
    int refid = -1;
    if (rname != "*") {
      auto it = ref_idx.find(rname);
      refid = it == ref_idx.end() ? -1 : it->second;
    }
    const int64_t pos0 = fint(3) - 1;
    int next_refid = -1;
    if (fl(6) == 1 && f[6][0] == '=')
      next_refid = refid;
    else if (!(fl(6) == 1 && f[6][0] == '*')) {
      auto it = ref_idx.find(std::string(f[6], fl(6)));
      next_refid = it == ref_idx.end() ? -1 : it->second;
    }
    // cigar
    std::vector<uint32_t> cig;
    int64_t ref_len = 0;
    if (!(fl(5) == 1 && f[5][0] == '*')) {
      uint32_t v = 0;
      for (const char *q = f[5]; q < f[5] + fl(5); ++q) {
        if (*q >= '0' && *q <= '9')
          v = v * 10 + (uint32_t)(*q - '0');
        else {
          static const char *ops = "MIDNSHP=XB";
          const uint32_t op =
            (uint32_t)(strchr(ops, *q) - ops);
          cig.push_back((v << 4) | op);
          if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
            ref_len += v;
          v = 0;
        }
      }
    }
    const int bam_bin =
      bam_reg2bin(pos0, pos0 + std::max<int64_t>(ref_len, 1));
    if (fl(0) > 254)
      return false;  // l_read_name is a u8 (BAM spec)
    name_b.assign(f[0], fl(0));
    name_b.push_back('\0');
    const bool seq_star = fl(9) == 1 && f[9][0] == '*';
    const int32_t l_seq = seq_star ? 0 : (int32_t)fl(9);
    const size_t body_start = payload.size() + 4;
    put_i32(payload, 0);  // block_size placeholder
    put_i32(payload, refid);
    put_i32(payload, (int32_t)pos0);
    const uint8_t bfields[4] = {(uint8_t)name_b.size(),
                                (uint8_t)fint(4),  // mapq
                                (uint8_t)(bam_bin & 0xFF),
                                (uint8_t)(bam_bin >> 8)};
    payload.append((const char *)bfields, 4);
    const uint16_t n_cig = (uint16_t)cig.size();
    const uint16_t flag = (uint16_t)fint(1);
    payload.append((const char *)&n_cig, 2);
    payload.append((const char *)&flag, 2);
    put_i32(payload, l_seq);
    put_i32(payload, next_refid);
    put_i32(payload, (int32_t)(fint(7) - 1));  // next_pos
    put_i32(payload, (int32_t)fint(8));        // tlen
    payload += name_b;
    payload.append((const char *)cig.data(), 4 * cig.size());
    for (int32_t i = 0; i < l_seq; i += 2) {
      uint8_t v = (uint8_t)(NT16.t[(uint8_t)f[9][i]] << 4);
      if (i + 1 < l_seq)
        v |= NT16.t[(uint8_t)f[9][i + 1]];
      payload.push_back((char)v);
    }
    const bool qual_star = fl(10) == 1 && f[10][0] == '*';
    for (int32_t i = 0; i < l_seq; ++i)
      payload.push_back(qual_star ? (char)0xFF
                                  : (char)(f[10][i] - 33));
    // aux tags (same smallest-signed/unsigned narrowing as io/bam.py)
    for (int i = 11; i < nf; ++i) {
      const char *t = f[i];
      const size_t tn = fl(i);
      if (tn < 5)
        return false;
      payload.push_back(t[0]);
      payload.push_back(t[1]);
      if (t[3] == 'i') {
        const int64_t v = atoll(std::string(t + 5, tn - 5).c_str());
        if (v >= 0 && v <= 255) {
          payload.push_back('C');
          payload.push_back((char)(uint8_t)v);
        }
        else if (v >= -128 && v <= 127) {
          payload.push_back('c');
          payload.push_back((char)(int8_t)v);
        }
        else if (v >= 0 && v <= 65535) {
          payload.push_back('S');
          const uint16_t u = (uint16_t)v;
          payload.append((const char *)&u, 2);
        }
        else if (v >= -32768 && v <= 32767) {
          payload.push_back('s');
          const int16_t u = (int16_t)v;
          payload.append((const char *)&u, 2);
        }
        else {
          payload.push_back('i');
          put_i32(payload, (int32_t)v);
        }
      }
      else if (t[3] == 'A') {
        payload.push_back('A');
        payload.push_back(t[5]);
      }
      else {
        payload.push_back('Z');
        payload.append(t + 5, tn - 5);
        payload.push_back('\0');
      }
    }
    const int32_t block_size = (int32_t)(payload.size() - body_start);
    std::memcpy(&payload[body_start - 4], &block_size, 4);
    p = nl + 1;
  }
  return true;
}

// one FASTQ record batch with the reference cleaning rules
// (io/fastq.py clean_read; abismal.cpp:164-201).  0 = ok, -1 = error.
int parse_batch(GzLines &in, const char *path, int64_t batch_size,
                StreamBatch &b, std::string &err) {
  b.rblob.clear();
  b.nblob.clear();
  b.roffs.assign(1, 0);
  b.noffs.assign(1, 0);
  b.n = 0;
  b.max_len = 1;
  std::string line, seq;
  for (int64_t k = 0; k < batch_size; ++k) {
    const int64_t hline = in.line_no;
    if (!in.next_line(line))
      break;
    if (line.empty()) {
      err = "file " + std::string(path) +
            " contains an empty read name at line " + std::to_string(hline);
      return -1;
    }
    size_t cut = line.size() - 1;
    for (size_t i = 1; i < line.size(); ++i)
      if (line[i] == ' ' || line[i] == '\t') {
        cut = i - 1;
        break;
      }
    b.nblob.append(line, 1, cut);
    b.noffs.push_back((int64_t)b.nblob.size());
    if (!in.next_line(seq))
      seq.clear();
    in.next_line(line);  // '+'
    in.next_line(line);  // quality
    if ((int64_t)seq.size() >= 32767) {
      err = "found a read of size " + std::to_string(seq.size()) +
            ", which is too long. Maximum allowed read size = 32767";
      return -1;
    }
    int64_t informative = 0;
    for (char c : seq)
      informative += (c != 'N');
    if (informative < MIN_READ_LENGTH)
      seq.clear();
    else {
      size_t e = seq.size();
      while (e && seq[e - 1] == 'N')
        --e;
      size_t s = 0;
      while (s < e && seq[s] != 'A' && seq[s] != 'C' && seq[s] != 'G' &&
             seq[s] != 'T')
        ++s;
      if (s == e) {
        err = "read has no ACGT bases after trimming";
        return -1;
      }
      if (s || e != seq.size())
        seq = seq.substr(s, e - s);
    }
    b.rblob += seq;
    b.roffs.push_back((int64_t)b.rblob.size());
    b.max_len = std::max<int64_t>(b.max_len, (int64_t)seq.size());
    ++b.n;
  }
  return 0;
}

struct StreamCtl {
  std::mutex read_mtx, write_mtx;
  std::condition_variable cv;
  int64_t next_seq = 0, next_write = 0;
  // read by workers between the two critical sections, so atomic
  // (relaxed suffices: they only ever go false->true)
  std::atomic<bool> done{false}, failed{false};
  std::string err;
  int64_t n_reads = 0;
  int64_t remaining = -1;  // shard read budget; < 0 = unlimited
  FILE *out = nullptr;
  bool bam = false;
  std::unordered_map<std::string, int> ref_idx;  // RNAME -> BAM refID
  // progress
  bool tty = false;
  int verbose = 0;
  int64_t total_bytes = 1;
  int prev_pct = 0;
  int bar_width = 72 - 13 - 3 - 5;
};

void stream_progress(StreamCtl &C, int64_t bpos) {
  if (!C.verbose)
    return;
  if (!C.tty) {
    fprintf(stderr, "[mapped %lld reads]\n", (long long)C.n_reads);
    return;
  }
  const int64_t j = std::min(bpos, C.total_bytes);
  const int pct = (int)(100.0 * j / C.total_bytes + 0.5);
  if (pct <= C.prev_pct)
    return;
  C.prev_pct = pct;
  const int x =
    std::min((int)(C.bar_width * (C.prev_pct / 100.0)), C.bar_width);
  std::string bar(x, '=');
  bar.append(C.bar_width - x, ' ');
  fprintf(stderr, "\r[mapping reads|%s|%3d%%]", bar.c_str(), C.prev_pct);
  if (j >= C.total_bytes)
    fprintf(stderr, "\n");
  fflush(stderr);
}

void stream_init(Engine &E, StreamCtl &C, const char *fq1, FILE *out,
                 int n_threads, int verbose, int out_bam) {
  C.out = out;
  C.verbose = verbose;
  C.bam = out_bam != 0;
  if (C.bam)
    for (int64_t i = 1; i + 1 < E.n_chroms; ++i)
      C.ref_idx.emplace(E.names[i], (int)(i - 1));
  C.tty = verbose && isatty(2);
  struct stat st;
  if (stat(fq1, &st) == 0)
    C.total_bytes = std::max<int64_t>(1, (int64_t)st.st_size);
  for (int t = 0; t < n_threads; ++t)
    get_worker(E, t);
  for (auto *w : E.workers) {
    std::memset(w->st, 0, sizeof(w->st));
    w->out.clear();
  }
}

}  // namespace

extern "C" {

const char *engine_error_ptr(void *eng) { return ((Engine *)eng)->err.c_str(); }

// stage profiling: out4 = summed ns {seed, align, format, parse} across
// workers (see StageTimer); reset clears the counters
void engine_set_profile(void *eng, int on) {
  (void)eng;
  g_profile = on != 0;
}

void engine_stage_ns(void *eng, int64_t *out16, int reset) {
  Engine &E = *(Engine *)eng;
  for (int i = 0; i < 16; ++i)
    out16[i] = 0;
  for (auto *w : E.workers)
    for (int i = 0; i < 16; ++i) {
      out16[i] += w->tns[i];
      if (reset)
        w->tns[i] = 0;
    }
}

// Full SE mapping run: parses fq_path, maps with n_threads workers, writes
// header + records to out_path in read order.  skip_reads/max_reads select
// a read-range shard (multi-host FASTQ sharding: each host maps its range
// and the gather step concatenates shard outputs in rank order);
// max_reads < 0 means to EOF.  Returns total reads processed, or -1 with
// the message in engine_error_ptr().
int64_t engine_run_se(void *eng, const char *fq_path, const char *out_path,
                      const uint8_t *header, int64_t header_len,
                      int a_rich_mode, int random_pbat, int64_t batch_size,
                      int n_threads, int64_t *stats_out, int verbose,
                      int64_t skip_reads, int64_t max_reads, int out_bam) {
  Engine &E = *(Engine *)eng;
  E.err.clear();
  GzLines in(fq_path);
  if (!in.ok()) {
    E.err = std::string("cannot open file: ") + fq_path;
    return -1;
  }
  if (skip_reads > 0)
    in.skip_lines(4 * skip_reads);
  FILE *out = fopen(out_path, "w");
  if (!out) {
    E.err = std::string("cannot open output file: ") + out_path;
    return -1;
  }
  if (out_bam) {
    // `header` holds the uncompressed BAM header payload (magic + text +
    // reference list, built host-side); BGZF-compress it here
    std::string hz;
    bgzf_compress((const char *)header, (size_t)header_len, hz);
    fwrite(hz.data(), 1, hz.size(), out);
  }
  else {
    fwrite(header, 1, header_len, out);
  }
  n_threads = std::max(1, n_threads);
  StreamCtl C;
  stream_init(E, C, fq_path, out, n_threads, verbose, out_bam);
  C.remaining = max_reads;
  const Events ev{};

  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) {
    Worker *wp = E.workers[t];
    ts.emplace_back([&, wp]() {
      Worker &w = *wp;
      StreamBatch b;
      for (;;) {
        int64_t my_seq;
        int64_t bpos = 0;
        {
          std::lock_guard<std::mutex> lk(C.read_mtx);
          if (C.done || C.failed)
            break;
          my_seq = C.next_seq++;
          std::string err;
          int prc;
          const int64_t bs = C.remaining < 0
                               ? batch_size
                               : std::min(batch_size, C.remaining);
          {
            StageTimer pt(w.tns + 3);
            prc = parse_batch(in, fq_path, bs, b, err);
          }
          if (prc != 0) {
            C.failed = true;
            C.err = err;
          }
          else if (b.n == 0)
            C.done = true;
          else if (C.remaining >= 0)
            C.remaining -= b.n;
          bpos = in.byte_pos();
        }
        w.out.clear();
        if (!C.failed && b.n) {
          w.aln.reset(b.max_len);
          const uint8_t *rb = (const uint8_t *)b.rblob.data();
          const uint8_t *nb = (const uint8_t *)b.nblob.data();
          for (int64_t ri = 0; ri < b.n; ++ri)
            map_one_se(E, w, ev, ri, nb + b.noffs[ri],
                       b.noffs[ri + 1] - b.noffs[ri], rb + b.roffs[ri],
                       (int)(b.roffs[ri + 1] - b.roffs[ri]),
                       a_rich_mode != 0, random_pbat != 0);
        }
        std::string bam_blocks;
        bool bam_ok = true;
        if (C.bam && !C.failed && b.n && !w.out.empty()) {
          std::string payload;
          bam_ok = sam_text_to_bam(w.out, C.ref_idx, payload);
          if (bam_ok)
            bgzf_compress(payload.data(), payload.size(), bam_blocks);
        }
        {
          std::unique_lock<std::mutex> lk(C.write_mtx);
          C.cv.wait(lk, [&] { return C.next_write == my_seq; });
          if (!bam_ok && !C.failed) {
            C.failed = true;
            C.err = "BAM conversion failed (read name over 254 chars?)";
          }
          if (!C.failed && b.n) {
            if (C.bam)
              fwrite(bam_blocks.data(), 1, bam_blocks.size(), C.out);
            else
              fwrite(w.out.data(), 1, w.out.size(), C.out);
            C.n_reads += b.n;
            stream_progress(C, bpos);
          }
          ++C.next_write;
          C.cv.notify_all();
        }
      }
    });
  }
  for (auto &t : ts)
    t.join();
  if (C.tty && C.prev_pct < 100) {
    C.prev_pct = 99;  // force the 100% line
    stream_progress(C, C.total_bytes);
  }
  if (C.bam && !C.failed)
    fwrite(BGZF_EOF_BLOCK, 1, sizeof(BGZF_EOF_BLOCK), out);
  fclose(out);
  if (C.failed) {
    E.err = C.err;
    return -1;
  }
  sum_stats(E, stats_out, 6);
  return C.n_reads;
}

// Full PE mapping run; stats_out holds 18 counters (pair, end1, end2).
int64_t engine_run_pe(void *eng, const char *fq1_path, const char *fq2_path,
                      const char *out_path, const uint8_t *header,
                      int64_t header_len, int a_rich_mode, int random_pbat,
                      int64_t batch_size, int n_threads, int64_t *stats_out,
                      int verbose, int64_t skip_reads, int64_t max_reads,
                      int out_bam) {
  Engine &E = *(Engine *)eng;
  E.err.clear();
  GzLines in1(fq1_path), in2(fq2_path);
  if (!in1.ok() || !in2.ok()) {
    E.err = std::string("cannot open file: ") +
            (in1.ok() ? fq2_path : fq1_path);
    return -1;
  }
  if (skip_reads > 0) {
    in1.skip_lines(4 * skip_reads);
    in2.skip_lines(4 * skip_reads);
  }
  FILE *out = fopen(out_path, "w");
  if (!out) {
    E.err = std::string("cannot open output file: ") + out_path;
    return -1;
  }
  if (out_bam) {
    // `header` holds the uncompressed BAM header payload (magic + text +
    // reference list, built host-side); BGZF-compress it here
    std::string hz;
    bgzf_compress((const char *)header, (size_t)header_len, hz);
    fwrite(hz.data(), 1, hz.size(), out);
  }
  else {
    fwrite(header, 1, header_len, out);
  }
  n_threads = std::max(1, n_threads);
  StreamCtl C;
  stream_init(E, C, fq1_path, out, n_threads, verbose, out_bam);
  C.remaining = max_reads;
  const Events ev{};

  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; ++t) {
    Worker *wp = E.workers[t];
    ts.emplace_back([&, wp]() {
      Worker &w = *wp;
      StreamBatch b1, b2;
      for (;;) {
        int64_t my_seq;
        int64_t bpos = 0;
        {
          std::lock_guard<std::mutex> lk(C.read_mtx);
          if (C.done || C.failed)
            break;
          my_seq = C.next_seq++;
          std::string err;
          int prc;
          const int64_t bs = C.remaining < 0
                               ? batch_size
                               : std::min(batch_size, C.remaining);
          {
            StageTimer pt(w.tns + 3);
            prc = (parse_batch(in1, fq1_path, bs, b1, err) != 0 ||
                   parse_batch(in2, fq2_path, bs, b2, err) != 0);
          }
          if (prc) {
            C.failed = true;
            C.err = err;
          }
          else if (b1.n != b2.n) {
            C.failed = true;
            C.err = "paired-end batch sizes differ. Batch 1: " +
                    std::to_string(b1.n) +
                    ", Batch 2: " + std::to_string(b2.n) +
                    ". Are you sure your paired-end inputs have the same "
                    "number of reads?";
          }
          else if (b1.n == 0)
            C.done = true;
          else if (C.remaining >= 0)
            C.remaining -= b1.n;
          bpos = in1.byte_pos();
        }
        w.out.clear();
        if (!C.failed && b1.n) {
          w.aln.reset(std::max(b1.max_len, b2.max_len));
          const uint8_t *r1 = (const uint8_t *)b1.rblob.data();
          const uint8_t *n1 = (const uint8_t *)b1.nblob.data();
          const uint8_t *r2 = (const uint8_t *)b2.rblob.data();
          const uint8_t *n2 = (const uint8_t *)b2.nblob.data();
          for (int64_t ri = 0; ri < b1.n; ++ri)
            map_one_pe(E, w, ev, ri, n1 + b1.noffs[ri],
                       b1.noffs[ri + 1] - b1.noffs[ri], r1 + b1.roffs[ri],
                       (int)(b1.roffs[ri + 1] - b1.roffs[ri]),
                       n2 + b2.noffs[ri], b2.noffs[ri + 1] - b2.noffs[ri],
                       r2 + b2.roffs[ri],
                       (int)(b2.roffs[ri + 1] - b2.roffs[ri]),
                       a_rich_mode != 0, random_pbat != 0);
        }
        std::string bam_blocks;
        bool bam_ok = true;
        if (C.bam && !C.failed && b1.n && !w.out.empty()) {
          std::string payload;
          bam_ok = sam_text_to_bam(w.out, C.ref_idx, payload);
          if (bam_ok)
            bgzf_compress(payload.data(), payload.size(), bam_blocks);
        }
        {
          std::unique_lock<std::mutex> lk(C.write_mtx);
          C.cv.wait(lk, [&] { return C.next_write == my_seq; });
          if (!bam_ok && !C.failed) {
            C.failed = true;
            C.err = "BAM conversion failed (read name over 254 chars?)";
          }
          if (!C.failed && b1.n) {
            if (C.bam)
              fwrite(bam_blocks.data(), 1, bam_blocks.size(), C.out);
            else
              fwrite(w.out.data(), 1, w.out.size(), C.out);
            C.n_reads += b1.n;
            stream_progress(C, bpos);
          }
          ++C.next_write;
          C.cv.notify_all();
        }
      }
    });
  }
  for (auto &t : ts)
    t.join();
  if (C.tty && C.prev_pct < 100) {
    C.prev_pct = 99;
    stream_progress(C, C.total_bytes);
  }
  if (C.bam && !C.failed)
    fwrite(BGZF_EOF_BLOCK, 1, sizeof(BGZF_EOF_BLOCK), out);
  fclose(out);
  if (C.failed) {
    E.err = C.err;
    return -1;
  }
  sum_stats(E, stats_out, 18);
  return C.n_reads;
}

}  // extern "C"
