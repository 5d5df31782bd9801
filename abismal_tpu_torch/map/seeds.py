"""Seed lookup, extension and bisulfite-aware Hamming filtering.

Re-implements the reference's two-phase seeding policy
(src/abismal.cpp:1090-1375): per seed offset the two-letter and three-letter
buckets are probed; oversized buckets are narrowed by binary-search extension
over the suffix-sorted bucket; surviving candidates are compared with the
packed-word popcount filter.  The popcount compare is vectorized across a
bucket's candidates (the reference's early exit only ever rejects, so a full
sum is equivalent); the candidate-set updates are applied sequentially to
preserve heap/cutoff/sure_ambig semantics.  The rolling hashes
(read_hashes) and the conversion choice (get_conv_is_ga) are host_units'.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    KEY_WEIGHT,
    KEY_WEIGHT_THREE,
    MIN_FOLD_SIZE,
    WINDOW_SIZE,
)
from ..utils.dna import (
    ENCODE_A_RICH,
    ENCODE_T_RICH,
    NIBBLE_TO_BIT,
    NIBBLE_TO_SRT_CT,
    NIBBLE_TO_SRT_GA,
    unpack_nibbles_u64,
)
from .host_units import get_conv_is_ga, read_hashes


def popcount_u64(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x).astype(np.int32)


def prep_read(read: bytes, a_rich: bool) -> np.ndarray:
    """ASCII read -> bisulfite-wildcard nibbles (abismal.cpp:1377-1386)."""
    arr = np.frombuffer(read, dtype=np.uint8)
    return (ENCODE_A_RICH if a_rich else ENCODE_T_RICH)[arr]


def pack_read(pread: np.ndarray) -> np.ndarray:
    """Nibbles -> u64 words, tail padded with 0xF match-any
    (abismal.cpp:1388-1426)."""
    n = pread.shape[0]
    n_words = (n + 15) // 16
    padded = np.full(n_words * 16, 0xF, dtype=np.uint64)
    padded[:n] = pread
    padded = padded.reshape(n_words, 16)
    shifts = (np.uint64(4) * np.arange(16, dtype=np.uint64)).reshape(1, 16)
    return np.bitwise_or.reduce(padded << shifts, axis=1)


class SeedIndexView:
    """Host-side view of the index used by the exact engine."""

    def __init__(self, idx):
        self.counter = idx.counter
        self.counter_t = idx.counter_t
        self.counter_a = idx.counter_a
        self.index = idx.index
        self.index_t = idx.index_t
        self.index_a = idx.index_a
        self.words = idx.genome_words
        self.nib = unpack_nibbles_u64(idx.genome_words, idx.genome_size)
        self.gbits = NIBBLE_TO_BIT[self.nib]
        self.gsrt_ct = NIBBLE_TO_SRT_CT[self.nib]
        self.gsrt_ga = NIBBLE_TO_SRT_GA[self.nib]
        self.max_candidates = idx.max_candidates
        self.cl = idx.cl


def full_compare_batch(view: SeedIndexView, packed_read: np.ndarray,
                       positions: np.ndarray) -> np.ndarray:
    """Hamming distances of the packed read against genome windows at
    `positions` (abismal.cpp:1105-1122), vectorized across positions."""
    w = (positions >> np.uint32(4)).astype(np.int64)
    sh = ((positions & np.uint32(15)) << np.uint32(2)).astype(np.uint64)
    d = np.zeros(positions.shape[0], dtype=np.int32)
    words = view.words
    for j in range(packed_read.shape[0]):
        g1 = words[w + j]
        g2 = words[w + j + 1]
        merged = (g1 >> sh) | ((g2 << (np.uint64(63) - sh)) << np.uint64(1))
        d += 16 - popcount_u64(packed_read[j] & merged)
    return d


def _find_candidates_two(view: SeedIndexView, pread: np.ndarray, offset: int,
                         read_lim: int, lo: int, hi: int):
    """Binary-search seed extension in a suffix-sorted two-letter bucket
    (abismal.cpp:1163-1194).  Returns (p, lo, hi)."""
    max_c = view.max_candidates
    index = view.index
    gbits = view.gbits
    rbits = NIBBLE_TO_BIT[pread]
    p = KEY_WEIGHT
    prev_lo, prev_hi = lo, hi
    while p != read_lim and (hi - lo) > max_c:
        prev_lo, prev_hi = lo, hi
        # first position in [lo, hi) whose genome bit at offset p is 1
        a, b = lo, hi
        while a < b:
            mid = (a + b) >> 1
            if gbits[index[mid] + p] < 1:
                a = mid + 1
            else:
                b = mid
        first_1 = a
        if rbits[offset + p]:
            lo = first_1
        else:
            hi = first_1
        p += 1
    if lo == hi:
        p -= 1
        lo, hi = prev_lo, prev_hi
    return p, lo, hi


def _find_candidates_three(view: SeedIndexView, pread: np.ndarray,
                           offset: int, read_lim: int, lo: int, hi: int,
                           is_ga: bool):
    """Three-letter variant with two lower_bounds splitting the symbol groups
    (abismal.cpp:1214-1259)."""
    max_c = view.max_candidates
    if is_ga:
        index = view.index_a
        gsrt = view.gsrt_ga
        rsym = NIBBLE_TO_SRT_GA[pread]
        v1, v2 = 2, 8
    else:
        index = view.index_t
        gsrt = view.gsrt_ct
        rsym = NIBBLE_TO_SRT_CT[pread]
        v1, v2 = 1, 4
    p = KEY_WEIGHT_THREE
    prev_lo, prev_hi = lo, hi

    def lower_bound(a, b, val, pp):
        while a < b:
            mid = (a + b) >> 1
            if gsrt[index[mid] + pp] < val:
                a = mid + 1
            else:
                b = mid
        return a

    while p != read_lim and (hi - lo) > max_c:
        prev_lo, prev_hi = lo, hi
        first_1 = lower_bound(lo, hi, v1, p)
        first_2 = lower_bound(lo, hi, v2, p)
        num = rsym[offset + p]
        if num == 0:
            hi = first_1
        elif num == v1:
            lo, hi = first_1, first_2
        else:
            lo = first_2
        p += 1
    if lo == hi:
        p -= 1
        lo, hi = prev_lo, prev_hi
    return p, lo, hi


def check_hits(view: SeedIndexView, packed_read: np.ndarray, offset: int,
               positions: np.ndarray, strand_code: int, specific: bool,
               res) -> None:
    """Compare candidates (bucket order) and feed the candidate set
    (abismal.cpp:1124-1150)."""
    if positions.shape[0] == 0 or res.sure_ambig:
        return
    the_pos = positions - np.uint32(offset)
    diffs = full_compare_batch(view, packed_read, the_pos)
    for i in range(the_pos.shape[0]):
        if res.sure_ambig:
            break
        d = int(diffs[i])
        if d <= res.cutoff:
            res.update(specific, d, strand_code, int(the_pos[i]))


def process_seeds(view: SeedIndexView, pread: np.ndarray,
                  packed_read: np.ndarray, strand_code: int, res) -> None:
    """Two-phase seeding policy (abismal.cpp:1269-1375)."""
    readlen = int(pread.shape[0])
    is_ga = get_conv_is_ga(strand_code)
    k2, k3t, k3a = read_hashes(pread)
    k3 = k3a if is_ga else k3t
    counter3 = view.counter_a if is_ga else view.counter_t
    index3 = view.index_a if is_ga else view.index_t
    counter2 = view.counter
    index2 = view.index
    max_c = view.max_candidates

    specific_len = min(readlen - WINDOW_SIZE, readlen >> 1)
    specific_lim = max(WINDOW_SIZE, readlen >> 1)

    # --- specific phase ---
    res.set_specific()
    for i in range(specific_lim):
        if res.sure_ambig:
            break
        kk = int(k2[i]) if i < k2.shape[0] else 0
        s2, e2 = int(counter2[kk]), int(counter2[kk + 1])
        l_two, s2, e2 = _find_candidates_two(
            view, pread, i, readlen - i, s2, e2
        )
        d_two = e2 - s2
        kk3 = int(k3[i]) if i < k3.shape[0] else 0
        s3, e3 = int(counter3[kk3]), int(counter3[kk3 + 1])
        l_three, s3, e3 = _find_candidates_three(
            view, pread, i, readlen - i, s3, e3, is_ga
        )
        d_three = e3 - s3

        if d_two <= max_c or l_two >= specific_len:
            check_hits(view, packed_read, i, index2[s2:e2], strand_code,
                       True, res)
        if d_three <= max_c or l_three >= specific_len:
            check_hits(view, packed_read, i, index3[s3:e3], strand_code,
                       True, res)

    if not res.should_do_sensitive():
        return

    # --- sensitive phase ---
    res.set_sensitive()
    lim_two = readlen - KEY_WEIGHT + 1
    for i in range(lim_two):
        if res.sure_ambig:
            break
        kk = int(k2[i])
        s2, e2 = int(counter2[kk]), int(counter2[kk + 1])
        d_two = e2 - s2
        kk3 = int(k3[i])
        s3, e3 = int(counter3[kk3]), int(counter3[kk3 + 1])
        d_three = e3 - s3

        if (d_two != 0 and d_two <= max_c
                and (d_three == 0 or d_two <= MIN_FOLD_SIZE * d_three)):
            check_hits(view, packed_read, i, index2[s2:e2], strand_code,
                       True, res)
        if d_three != 0 and d_three <= max_c:
            check_hits(view, packed_read, i, index3[s3:e3], strand_code,
                       True, res)
