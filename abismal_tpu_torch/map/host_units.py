"""NumPy-only host helpers of the device pipeline (↔ the module-level
helpers and the static unit-layout helpers of abismal_tpu/map/pipeline.py,
read_hashes / get_conv_is_ga of abismal_tpu/map/seeds.py and strand_code
of abismal_tpu/map/engine.py): the static limits of the device programs,
the candidate-budget estimate from the index's counters, genome packing,
the sharded index's key ranges and the merge of its shards' event
streams, the stage-1 unit layout (prepare_units), the per-unit
strand-code and conversion patterns, the ASCII read matrices and the
pure-native engine factory.  Nothing here touches a torch device."""

from __future__ import annotations

import os

import numpy as np

from ..constants import (
    BSFLAG_A_RICH, KEY_WEIGHT, KEY_WEIGHT_THREE, SAM_RC, WINDOW_SIZE,
)
from ..utils.dna import (
    NIBBLE_TO_BIT, NIBBLE_TO_THREE_CT, NIBBLE_TO_THREE_GA, REVCOMP_TABLE,
)

SLOT = 128  # max candidates checked per (offset, table); > max_candidates
HASH3_MOD = 43046721  # 3^16

# Minimum read length for the device paths.  The specific phase seeds
# offsets up to floor(len/2) (process_seeds, abismal.cpp:1298-1305), and a
# KEY_WEIGHT-symbol seed at that offset stays inside the read only when
# floor(len/2) + KEY_WEIGHT <= len, i.e. len >= 2*KEY_WEIGHT - 1 = 49;
# below that the reference reads past the read end (benign garbage
# upstream, unreproducible on fixed-shape device buffers).  The bound is
# profile-independent (KEY_WEIGHT does not change under ABISMAL_TPU_SHORT),
# so under the SHORT profile 36-48 bp reads -- its target workload -- map
# on the exact host path.
DEVICE_MIN_LEN = 2 * KEY_WEIGHT - 1  # 49

# status codes of the packed per-read records (low 3 bits of rec[0])
REC_UNMAPPED, REC_EXACT, REC_ALIGNED, REC_FALLBACK = 0, 1, 2, 3

# device-traceback cigar buffer: run-length ops per winner.  Real cigars
# hold <= 2*max_diffs+1 non-clip runs (every I/D run costs >= 4 score, so
# a 100 bp read at max_diffs 10 has <= 21); overflowing reads take the
# host traceback for that read alone (n_ops = -1), so the cap trades
# device payload for fallback rate, never correctness.
TB_NOPS = 24


def strand_code(strand: str, a_rich: bool) -> int:
    return (SAM_RC if strand == "-" else 0) | (BSFLAG_A_RICH if a_rich else 0)


def get_conv_is_ga(strand_code: int) -> bool:
    """three_conv_type selection (abismal.cpp:1261-1267)."""
    return bool(strand_code & BSFLAG_A_RICH) ^ bool(strand_code & SAM_RC)


def read_hashes(pread: np.ndarray):
    """Rolling two-letter / three-letter hashes (both conversions) for every
    seed offset of an encoded read.  Offsets beyond the read use 0 nibbles
    (the reference reads one element past the buffer on the final shift; the
    value is never used for in-range lookups)."""
    n = pread.shape[0]
    ext = np.zeros(n + KEY_WEIGHT + 1, dtype=np.uint8)
    ext[:n] = pread
    lim2 = n - KEY_WEIGHT + 1
    lim3 = n - KEY_WEIGHT_THREE + 1
    bits = NIBBLE_TO_BIT[ext]
    k2 = np.zeros(max(lim2, 0), dtype=np.uint32)
    for j in range(KEY_WEIGHT):
        k2 = (k2 << np.uint32(1)) | bits[j : j + lim2]
    three_t = NIBBLE_TO_THREE_CT[ext]
    three_a = NIBBLE_TO_THREE_GA[ext]
    k3t = np.zeros(max(lim3, 0), dtype=np.uint32)
    k3a = np.zeros(max(lim3, 0), dtype=np.uint32)
    for j in range(KEY_WEIGHT_THREE):
        k3t = k3t * np.uint32(3) + three_t[j : j + lim3]
        k3a = k3a * np.uint32(3) + three_a[j : j + lim3]
    k3t %= np.uint32(HASH3_MOD)
    k3a %= np.uint32(HASH3_MOD)
    return k2, k3t, k3a


def o_spec_for(lmax: int) -> int:
    """Static specific-phase offset bound for a padded read length."""
    return max(WINDOW_SIZE, lmax >> 1)


def auto_cand_budget(n_index2: int, n_index3: int, lmax: int) -> int:
    """Global per-unit candidate budget sized to the index's bucket
    density: large genomes have ~genome_size/2^25 positions per two-letter
    bucket, so a toy-genome default would dump every unit onto the host
    fallback path.  Clipped to keep the candidate pass bounded."""
    o_spec = o_spec_for(lmax)
    o_sens = lmax - KEY_WEIGHT + 1
    avg2 = n_index2 / float(1 << KEY_WEIGHT)
    avg3 = n_index3 / float(HASH3_MOD)
    est = int((avg2 + avg3) * (o_spec + o_sens) * 8)
    # the budget is POOLED over the unit batch (global prefix sums), so a
    # few-x margin over the measured mean suffices, and compare/list cost
    # scales linearly with the padded pool
    return max(64, min(8192, (est + 63) & ~63))


def _resolve_cand_budget(cand_per_unit, n_index2, n_index3, lmax):
    if cand_per_unit is None:
        cand_per_unit = auto_cand_budget(n_index2, n_index3, lmax)
    return int(os.environ.get("ABISMAL_TPU_CAND_PER_UNIT", cand_per_unit))


def estimate_cand_budget(counters, max_candidates: int, units, is_ga,
                         lmax: int, sample: int = 512):
    """Workload-informed per-unit candidate budget: replays the seeding
    policy's bucket-size checks in NumPy over a sample of real units
    (keys via rolling hashes, sizes via the counter prefix arrays) and
    sizes the POOLED device budget at ~1.1x the measured mean.  Returns
    (budget, ext_lanes_per_unit): the second term is the measured mean
    of oversized specific-phase buckets per unit, from which the engine
    sizes the extension pool (None when no units were measurable).

    Every per-candidate device op costs time in proportion to the padded
    pool, and the density heuristic (auto_cand_budget) overshoots several
    times over at GB scale because indexed-position counts say little
    about read-weighted bucket sizes.  The pooled budget makes the margin
    safe: units past the pool fall back to the exact host path (overflow
    flag), so an underestimate costs speed, never correctness."""
    c2, ct, ca = (c.astype(np.int64) for c in counters)
    mc = max_candidates
    tot = 0.0
    ext_tot = 0.0
    n = 0
    step = max(1, len(units) // sample)
    for i in range(0, len(units), step):
        u = units[i]
        rl = int(u.shape[0])
        if rl < KEY_WEIGHT + WINDOW_SIZE - 1:
            continue
        k2, k3t, k3a = read_hashes(u)
        k3 = k3a if is_ga[i] else k3t
        c3 = ca if is_ga[i] else ct
        s2 = c2[k2 + 1] - c2[k2]
        s3 = c3[k3 + 1] - c3[k3]
        o_sp = min(max(WINDOW_SIZE, rl >> 1), o_spec_for(lmax))
        # specific phase: small buckets checked as-is, oversized ones
        # extension-capped at SLOT (upper bound; most narrow below mc)
        est = (np.minimum(s2[:o_sp], SLOT).sum()
               + np.minimum(s3[:o_sp], SLOT).sum())
        # sensitive phase: only small buckets; the 2-letter fold rule
        # (d2 <= 10*d3) is ignored (upper bound)
        est += s2[(s2 <= mc)].sum() + s3[(s3 <= mc)].sum()
        tot += float(est)
        # oversized specific-phase buckets are the extension pool's
        # demand (one lane each)
        ext_tot += float((s2[:o_sp] > mc).sum() + (s3[:o_sp] > mc).sum())
        n += 1
    if n == 0:
        return 64, None
    mean = tot / n
    # the pool is GLOBAL over the batch, so the margin only covers batch-
    # to-batch drift of the mean (not per-unit variance); spills cost an
    # exact host remap of tail units, never correctness
    return (int(min(8192, max(64, (int(mean * 1.10) + 15) & ~15))),
            ext_tot / n)


def pack_genome_u32(genome_words_u64: np.ndarray, guard: int = 64):
    """Split the u64-packed genome into u32 words (8 bases each), little
    nibble order preserved, plus zero guard words for gather safety."""
    lo = (genome_words_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (genome_words_u64 >> np.uint64(32)).astype(np.uint32)
    out = np.empty(genome_words_u64.shape[0] * 2 + guard, dtype=np.uint32)
    out[0 : 2 * genome_words_u64.shape[0] : 2] = lo
    out[1 : 2 * genome_words_u64.shape[0] : 2] = hi
    out[2 * genome_words_u64.shape[0]:] = 0
    return out


def ext_iters_for(index) -> int:
    """Static bisection depth for the pooled seed extension: enough
    iterations to converge a binary search over the LARGEST bucket of any
    of the three tables (derived on host from the counter prefix arrays;
    the extension only ever searches within one bucket)."""
    mb = 1
    for c in (index.counter, index.counter_t, index.counter_a):
        if c.shape[0] > 1:
            mb = max(mb, int(np.diff(c.astype(np.int64)).max()))
    return max(2, int(np.ceil(np.log2(mb + 1))) + 1)


def _tp_key_bounds(counter: np.ndarray, n_shards: int) -> np.ndarray:
    """Key-range boundaries (n_shards + 1) splitting a bucket-offset prefix
    array into shards of ~equal position count; every bucket lands on
    exactly one shard."""
    total = int(counter[-1])
    targets = (np.arange(n_shards + 1, dtype=np.int64) * total) // n_shards
    bounds = np.searchsorted(counter, targets, side="left").astype(np.int64)
    bounds[0] = 0
    bounds[-1] = counter.shape[0] - 1
    return bounds


def _merge_tp_streams(ev: np.ndarray, cf: np.ndarray):
    """Merges the per-shard event streams of a sharded-index stage-1 call.

    ev: (2*n_shards, gcap) -- rows (2s, 2s+1) are shard s's compacted
    (pos, meta) stream; cf: (n_shards, B) count|overflow words, every
    shard covering the full unit batch.  Returns the rank-merged stream
    (pos, diffs, rank) plus per-unit (start, count, overflow).  A unit
    flagged overflow on ANY shard falls back to native re-seeding (its
    per-shard offsets may point past that shard's truncated stream)."""
    n_sh = cf.shape[0]
    B = cf.shape[1]
    cnt2d = (cf & 0x3FFFFFFF).astype(np.int64)
    ovf = ((cf >> 30) != 0).any(axis=0)
    within = np.cumsum(cnt2d, axis=1) - cnt2d
    take = np.where(ovf[None, :], 0, cnt2d)
    pos_cat, meta_cat, unit_cat = [], [], []
    for s in range(n_sh):
        c = take[s]
        total = int(c.sum())
        if total == 0:
            continue
        intra = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(c) - c, c)
        src = np.repeat(within[s], c) + intra
        pos_cat.append(ev[2 * s][src])
        meta_cat.append(ev[2 * s + 1][src])
        unit_cat.append(np.repeat(np.arange(B, dtype=np.int64), c))
    m_cnt = take.sum(axis=0)
    m_start = np.cumsum(m_cnt) - m_cnt
    if not pos_cat:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.int32), m_start, m_cnt, ovf)
    pos_all = np.concatenate(pos_cat)
    meta_all = np.concatenate(meta_cat)
    unit_all = np.concatenate(unit_cat)
    rank_all = (meta_all & 0x3FFFFF).astype(np.int32)
    order = np.lexsort((rank_all, unit_all))
    return (pos_all[order],
            (meta_all[order] >> 22).astype(np.int32) - 512,
            rank_all[order], m_start, m_cnt, ovf)


def prepare_units(unit_reads, lmax: int):
    """Host-side layout of encoded unit reads (list of uint8 nibble arrays)
    into the fixed-shape stage-1 inputs: two nibbles per uploaded byte
    (half-size transfers); unpacking and word packing happen on device."""
    B = len(unit_reads)
    preads = np.zeros((B, lmax + 32), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, pr in enumerate(unit_reads):
        n = pr.shape[0]
        lens[i] = n
        preads[i, :n] = pr
    pnib = preads[:, 0::2] | (preads[:, 1::2] << np.uint8(4))
    return pnib, lens


def _se_scode_pattern(a_rich_mode, random_pbat):
    """Per-unit strand codes of a single-end read's units."""
    if not random_pbat:
        return np.array([strand_code("+", a_rich_mode),
                         strand_code("-", a_rich_mode)], dtype=np.int32)
    # RPBAT unit order: (fw,T), (fw,A), (rc as T-rich, strand code
    # a-rich), (rc as A-rich, strand code T-rich) -- the encoding and the
    # reported conversion cross over on the reverse strand
    # (abismal.cpp:1602-1704)
    return np.array([strand_code("+", False), strand_code("+", True),
                     strand_code("-", True), strand_code("-", False)],
                    dtype=np.int32)


def _pe_is_ga_pattern(a_rich_mode, random_pbat):
    """Per-unit conversion (G->A table?) flags of a pair's units."""
    convs = [a_rich_mode] if not random_pbat else [False, True]
    pat = []
    for conv in convs:
        pat += [get_conv_is_ga(strand_code("+", conv)),
                get_conv_is_ga(strand_code("-", not conv)),
                get_conv_is_ga(strand_code("+", not conv)),
                get_conv_is_ga(strand_code("-", conv))]
    return np.array(pat, dtype=bool)


def _ascii_matrices(seqs, lmax):
    """(R, lmax) u8 ASCII matrix, its row-wise reverse complement,
    and per-read lengths, from a list of byte strings.  Callers must
    pre-blank oversized entries (b""); byte-level ljust joins beat
    NumPy scatter layouts ~6x here.  REVCOMP_TABLE maps \\0 -> 'N',
    so the reversed matrix's padding is re-zeroed from the forward
    matrix's zero columns cheaply."""
    R = len(seqs)
    lens = np.fromiter((len(s) if s else 0 for s in seqs),
                       dtype=np.int64, count=R)
    pad = b"\x00" * lmax
    A = np.frombuffer(
        b"".join((s or pad).ljust(lmax, b"\x00") for s in seqs)
        or pad, dtype=np.uint8).reshape(max(R, 1), lmax)
    Arc = REVCOMP_TABLE[np.frombuffer(
        b"".join((s[::-1] or pad).ljust(lmax, b"\x00") for s in seqs)
        or pad, dtype=np.uint8).reshape(max(R, 1), lmax)]
    Arc[A == 0] = 0
    return A, Arc, lens


def make_native_engine_factory(n_threads: int = 1):
    """Pure-native engine: C++ seeding + decide/align/format, no device."""

    def factory(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
        from .native_engine import NativeMappingEngine

        return NativeMappingEngine(index, allow_ambig, valid_frac,
                                   pe_min_dist, pe_max_dist,
                                   n_threads=n_threads)

    factory.is_native = True
    return factory
