"""Index construction.

A vectorized re-design of the reference index build
(src/AbismalIndex.cpp:281-331): the five full-genome scans become NumPy
vector passes, the windowed seed-selection DP runs in the native library
(block-parallelizable), and per-bucket suffix sorting becomes one global
lexsort over packed suffix keys.  The result is bit-identical to the
reference's serialized index.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..constants import (
    DEFAULT_MAX_CANDIDATES,
    HASH_MASK_THREE,
    KEY_WEIGHT,
    KEY_WEIGHT_THREE,
    MAX_N_COUNT,
    N_SORTING_POSITIONS,
    WINDOW_SIZE,
)
from ..io.genome import ChromLookup, load_genome
from ..native import get_lib
from ..utils.dna import (
    NIBBLE_TO_BIT,
    NIBBLE_TO_SRT_CT,
    NIBBLE_TO_SRT_GA,
    NIBBLE_TO_THREE_CT,
    NIBBLE_TO_THREE_GA,
    encode_genome_nibbles,
    pack_nibbles_u64,
)

N_BUCKETS_TWO = 1 << KEY_WEIGHT
N_BUCKETS_THREE = HASH_MASK_THREE


@dataclass
class AbismalIndex:
    """In-memory index: packed genome + three hash tables
    (AbismalIndex.hpp:160-190)."""

    cl: ChromLookup
    genome_words: np.ndarray  # uint64, 16 bases/word
    counter: np.ndarray  # uint32[2^25+1] bucket start offsets
    counter_t: np.ndarray  # uint32[3^16+1]
    counter_a: np.ndarray  # uint32[3^16+1]
    index: np.ndarray  # uint32 genome positions (two-letter buckets)
    index_t: np.ndarray  # uint32 (three-letter C->T buckets)
    index_a: np.ndarray  # uint32 (three-letter G->A buckets)
    max_candidates: int = DEFAULT_MAX_CANDIDATES
    exclude: list = field(default_factory=list)

    @property
    def genome_size(self) -> int:
        return self.cl.get_genome_size()


def contiguous_n(genome: np.ndarray):
    """Maximal runs of 'N' as (start, end) pairs (AbismalIndex.cpp:125-145)."""
    is_n = (genome == ord("N")).astype(np.int8)
    d = np.diff(is_n, prepend=np.int8(0), append=np.int8(0))
    starts = np.flatnonzero(d == 1)
    ends = np.flatnonzero(d == -1)
    return list(zip(starts.tolist(), ends.tolist()))


def replace_included_n(genome: np.ndarray, exclude) -> None:
    """Replace N bases outside `exclude` with LCG pseudo-random bases, in
    increasing position order (AbismalIndex.cpp:164-175)."""
    flags = np.zeros(genome.shape[0], dtype=np.int8)
    for s, e in exclude:
        flags[s:e] = 1
    pos = np.flatnonzero((genome == ord("N")) & (flags == 0))
    if pos.shape[0] == 0:
        return
    buf = np.empty(pos.shape[0], dtype=np.uint8)
    get_lib().lcg_random_bases(1, pos.shape[0], buf.ctypes.data)
    genome[pos] = buf


def rolling_hashes(nibbles: np.ndarray):
    """Two-letter 25-bit and three-letter base-3 rolling hash arrays over all
    window start positions (AbismalIndex.hpp:271-305).

    Returns (k2[lim2], k3t[lim3], k3a[lim3]) where lim2 = n - 25 + 1 and
    lim3 = n - 16 + 1.
    """
    n = nibbles.shape[0]
    lim2 = n - KEY_WEIGHT + 1
    lim3 = n - KEY_WEIGHT_THREE + 1

    bits = NIBBLE_TO_BIT[nibbles]
    k2 = np.zeros(lim2, dtype=np.uint32)
    for j in range(KEY_WEIGHT):
        k2 <<= np.uint32(1)
        k2 |= bits[j : j + lim2]

    three_t = NIBBLE_TO_THREE_CT[nibbles]
    three_a = NIBBLE_TO_THREE_GA[nibbles]
    k3t = np.zeros(lim3, dtype=np.uint32)
    k3a = np.zeros(lim3, dtype=np.uint32)
    for j in range(KEY_WEIGHT_THREE):
        k3t *= np.uint32(3)
        k3t += three_t[j : j + lim3]
        k3a *= np.uint32(3)
        k3a += three_a[j : j + lim3]
    k3t %= np.uint32(HASH_MASK_THREE)
    k3a %= np.uint32(HASH_MASK_THREE)
    return k2, k3t, k3a


def included_mask(n: int, exclude) -> np.ndarray:
    """True for positions the reference's counting loops accept.

    The reference advances its exclude iterator only AFTER testing each
    position (AbismalIndex.cpp:355-364), so the position at each interval's
    `second` (the first base after an excluded N run) is still compared
    against that interval's `first` and silently skipped -- it is never
    counted or indexed.  Reproduced here by also masking interval ends."""
    flags = np.ones(n, dtype=bool)
    for s, e in exclude:
        flags[min(s, n) : min(e + 1, n)] = False
    return flags


def covered_mask(n: int, exclude) -> np.ndarray:
    """True for positions covered by the block decomposition (classification
    and the seed-selection DP): everything outside the exclude intervals,
    including each interval's end position."""
    flags = np.ones(n, dtype=bool)
    for s, e in exclude:
        flags[min(s, n) : min(e, n)] = False
    return flags


def get_block_bounds(start_pos: int, step: int, end_pos: int, exclude):
    """Block decomposition skipping exclude intervals
    (AbismalIndex.cpp:438-469)."""
    blocks = []
    bs = start_pos
    i = 0
    while bs < end_pos and i < len(exclude):
        if bs < exclude[i][0]:
            be = min(exclude[i][0], bs + step, end_pos)
            blocks.append((bs, be))
            bs += step
            if bs >= exclude[i][1]:
                bs = exclude[i][1]
                i += 1
        else:
            bs = exclude[i][1]
            i += 1
    while bs < end_pos:
        blocks.append((bs, min(bs + step, end_pos)))
        bs += step
    return blocks


def _suffix_keys_two(bits: np.ndarray, pos: np.ndarray):
    """Pack the two-letter suffix (symbols key_weight..n_sorting_positions-1
    of each position) into u64 chunks whose unsigned comparison equals the
    reference comparator (AbismalIndex.cpp:857-875)."""
    n_sym = N_SORTING_POSITIONS - KEY_WEIGHT  # 231
    chunks = []
    for c in range((n_sym + 63) // 64):
        key = np.zeros(pos.shape[0], dtype=np.uint64)
        base = KEY_WEIGHT + 64 * c
        for j in range(64):
            sym = base + j
            key <<= np.uint64(1)
            if sym < N_SORTING_POSITIONS:
                key |= bits[pos + sym].astype(np.uint64)
        chunks.append(key)
    return chunks


def _suffix_keys_three(srt: np.ndarray, pos: np.ndarray):
    """Pack the three-letter suffix symbols (nibble&5 or nibble&10, 4 bits
    each) into u64 chunks (AbismalIndex.cpp:877-903)."""
    n_sym = N_SORTING_POSITIONS - KEY_WEIGHT_THREE  # 240
    chunks = []
    for c in range(n_sym // 16):
        key = np.zeros(pos.shape[0], dtype=np.uint64)
        base = KEY_WEIGHT_THREE + 16 * c
        for j in range(16):
            key = (key << np.uint64(4)) | srt[pos + base + j].astype(np.uint64)
        chunks.append(key)
    return chunks


def _sorted_bucket_fill(keys: np.ndarray, pos: np.ndarray, suffix_fn,
                        n_buckets: int, chunk_positions: int = 8_000_000):
    """Order positions by (bucket, suffix, descending position) and return
    (counter_starts, index).  Descending position breaks suffix ties exactly
    like the reference's back-to-front counting-sort fill followed by
    stable_sort (AbismalIndex.cpp:545-641,905-978).

    For large genomes the sort runs over key-range groups (buckets are the
    primary key, so groups concatenate in order), bounding the memory used
    by the packed suffix keys."""
    counts = np.bincount(keys, minlength=n_buckets).astype(np.uint32)
    counter = np.zeros(n_buckets + 1, dtype=np.uint32)
    cum = np.cumsum(counts, dtype=np.uint32)
    counter[1:] = cum

    n = pos.shape[0]
    if n <= chunk_positions:
        order = np.lexsort(tuple(
            [np.uint32(0xFFFFFFFF) - pos] + suffix_fn(pos)[::-1] + [keys]))
        return counter, pos[order].astype(np.uint32)

    n_groups = int(np.ceil(n / chunk_positions))
    # bucket-space split points with ~equal positions per group
    targets = (np.arange(1, n_groups) * n) // n_groups
    split_buckets = np.searchsorted(cum, targets, side="left")
    group = np.searchsorted(split_buckets, keys, side="right")
    out = np.empty(n, dtype=np.uint32)
    w = 0
    for g in range(n_groups):
        sel = np.flatnonzero(group == g)
        if sel.shape[0] == 0:
            continue
        p = pos[sel]
        order = np.lexsort(tuple(
            [np.uint32(0xFFFFFFFF) - p] + suffix_fn(p)[::-1] + [keys[sel]]))
        out[w : w + p.shape[0]] = p[order]
        w += p.shape[0]
    return counter, out


def load_target_regions(path: str):
    """3-column BED-like target regions (AbismalIndex.cpp:83-108)."""
    targets = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 3:
                raise RuntimeError("failed parsing target region")
            targets.append((parts[0], int(parts[1]), int(parts[2])))
    return targets


def sort_by_chrom(names, targets):
    """Group targets by the genome's chromosome order, dropping targets on
    unknown chromosomes; targets must be sorted within each chromosome
    (AbismalIndex.cpp:183-204)."""
    out = []
    for name in names:
        group = [t for t in targets if t[0] == name]
        if group != sorted(group):
            raise RuntimeError("target regions not sorted")
        out.extend(group)
    return out


def mask_non_target(targets, genome: np.ndarray) -> None:
    """Mask everything outside target regions to 'N'.  The reference's lazy
    iterator advance keeps the closed interval [start, end] of each target
    (one extra base at the end) -- reproduced here
    (AbismalIndex.cpp:110-123)."""
    keep = np.zeros(genome.shape[0], dtype=bool)
    n = genome.shape[0]
    for s, e in targets:
        if e >= s:
            keep[min(s, n) : min(e + 1, n)] = True
    genome[~keep] = ord("N")


def _stage(verbose: bool, label: str, t0=[None]):
    """Stage wall-clock logging like the reference's delta_seconds timers
    (AbismalIndex.cpp:50-58)."""
    import sys
    import time

    if not verbose:
        return
    now = time.monotonic()
    if t0[0] is not None:
        print(f"[time: {now - t0[0]:.2f}s]", file=sys.stderr)
    if label:
        print(f"[{label}]", end="", file=sys.stderr, flush=True)
        t0[0] = now
    else:
        t0[0] = None


def _build_from_genome_native(genome: np.ndarray, cl, n_threads: int = 1,
                              verbose: bool = False) -> "AbismalIndex":
    """Streaming native build: the five genome scans run as threaded C++
    rolling scans with O(1) temporaries (no full-genome hash arrays), so
    hg38-scale genomes build in bounded memory.  Bit-identical to the
    NumPy build below (the oracle) and hence to the reference."""
    lib = get_lib()
    n = genome.shape[0]

    _stage(verbose, "cleaning reference genome")
    # one native pass (N-run detection + LCG replacement in place); the
    # numpy contiguous_n/replace_included_n pair is the tested oracle but
    # allocates several genome-sized temporaries
    cap = 65536
    while True:
        exc_s = np.empty(cap, dtype=np.int64)
        exc_e = np.empty(cap, dtype=np.int64)
        n_exc = int(lib.index_clean_genome(
            genome.ctypes.data, n, MAX_N_COUNT, exc_s.ctypes.data,
            exc_e.ctypes.data, cap))
        if n_exc <= cap:
            break
        cap = n_exc
    exc_s = exc_s[:n_exc].copy()
    exc_e = exc_e[:n_exc].copy()
    exclude = list(zip(exc_s.tolist(), exc_e.tolist()))

    _stage(verbose, "encoding genome")
    # fused native encode+pack (one pass, threaded; the numpy gather +
    # strided packing are the oracle, kept for the numpy build below)
    from ..utils.dna import ENCODE_GENOME

    nibbles = np.empty(n, dtype=np.uint8)
    genome_words = np.empty((n + 15) // 16, dtype=np.uint64)
    lib.encode_pack_genome(
        genome.ctypes.data, n, np.ascontiguousarray(ENCODE_GENOME).ctypes.data,
        nibbles.ctypes.data, genome_words.ctypes.data, max(1, n_threads))
    del genome

    _stage(verbose, "computing bucket sizes")
    lim2 = n - KEY_WEIGHT + 1
    cnt2 = np.empty(N_BUCKETS_TWO + 1, dtype=np.uint32)
    cnt3t = np.empty(N_BUCKETS_THREE + 1, dtype=np.uint32)
    cnt3a = np.empty(N_BUCKETS_THREE + 1, dtype=np.uint32)
    lib.index_count_hashes(
        nibbles.ctypes.data, n, exc_s.ctypes.data, exc_e.ctypes.data,
        len(exclude), None, None, cnt2.ctypes.data, cnt3t.ctypes.data,
        cnt3a.ctypes.data)

    _stage(verbose, "selecting two-letter positions")
    itl = np.zeros(n, dtype=np.uint8)
    blocks = get_block_bounds(0, 1_000_000, lim2, exclude)
    bstarts = np.asarray([b[0] for b in blocks], dtype=np.int64)
    bends = np.asarray([b[1] for b in blocks], dtype=np.int64)
    lib.index_select_two_letter(
        nibbles.ctypes.data, cnt2.ctypes.data, cnt3t.ctypes.data,
        cnt3a.ctypes.data, bstarts.ctypes.data, bends.ctypes.data,
        len(blocks), itl.ctypes.data, n_threads)

    _stage(verbose, "dynamic programming to optimize seed selection")
    keep = np.zeros(n, dtype=np.uint8)
    lib.compress_dp_blocks_mt(
        nibbles.ctypes.data, cnt2.ctypes.data, cnt3t.ctypes.data,
        cnt3a.ctypes.data, itl.ctypes.data, bstarts.ctypes.data,
        bends.ctypes.data, len(blocks), WINDOW_SIZE, keep.ctypes.data,
        n_threads)

    _stage(verbose, "hashing and sorting buckets")
    # one fused scan captures each kept position's hash keys into compact
    # arrays (work ~ kept positions) and recounts the masked buckets from
    # them; placement and the per-bucket suffix sort then run over the
    # compact arrays instead of re-scanning the genome four more times
    # (masked recount + three fills)
    n23 = np.zeros(2, dtype=np.int64)
    lib.index_count_kept(keep.ctypes.data, itl.ctypes.data, lim2,
                         n23.ctypes.data, n23[1:].ctypes.data, n_threads)
    bound2, bound3 = int(n23[0]), int(n23[1])
    k2c = np.empty(bound2, dtype=np.uint32)
    p2c = np.empty(bound2, dtype=np.uint32)
    k3tc = np.empty(bound3, dtype=np.uint32)
    k3ac = np.empty(bound3, dtype=np.uint32)
    p3c = np.empty(bound3, dtype=np.uint32)
    lib.index_capture_kept(
        nibbles.ctypes.data, n, exc_s.ctypes.data, exc_e.ctypes.data,
        len(exclude), keep.ctypes.data, itl.ctypes.data, k2c.ctypes.data,
        p2c.ctypes.data, k3tc.ctypes.data, k3ac.ctypes.data, p3c.ctypes.data,
        cnt2.ctypes.data, cnt3t.ctypes.data, cnt3a.ctypes.data,
        n23.ctypes.data, n23[1:].ctypes.data, n_threads)
    n2, n3 = int(n23[0]), int(n23[1])

    counter = np.zeros(N_BUCKETS_TWO + 1, dtype=np.uint32)
    np.cumsum(cnt2[:N_BUCKETS_TWO], dtype=np.uint32, out=counter[1:])
    counter_t = np.zeros(N_BUCKETS_THREE + 1, dtype=np.uint32)
    np.cumsum(cnt3t[:N_BUCKETS_THREE], dtype=np.uint32, out=counter_t[1:])
    counter_a = np.zeros(N_BUCKETS_THREE + 1, dtype=np.uint32)
    np.cumsum(cnt3a[:N_BUCKETS_THREE], dtype=np.uint32, out=counter_a[1:])
    del cnt2, cnt3t, cnt3a

    index = np.empty(n2, dtype=np.uint32)
    index_t = np.empty(n3, dtype=np.uint32)
    index_a = np.empty(n3, dtype=np.uint32)
    lib.index_place_and_sort(
        nibbles.ctypes.data, k2c.ctypes.data, p2c.ctypes.data, n2,
        k3tc.ctypes.data, k3ac.ctypes.data, p3c.ctypes.data, n3,
        counter.ctypes.data, counter_t.ctypes.data, counter_a.ctypes.data,
        index.ctypes.data, index_t.ctypes.data, index_a.ctypes.data,
        n_threads)
    del k2c, p2c, k3tc, k3ac, p3c

    _stage(verbose, "")
    return AbismalIndex(
        cl=cl, genome_words=genome_words, counter=counter,
        counter_t=counter_t, counter_a=counter_a, index=index,
        index_t=index_t, index_a=index_a, exclude=exclude,
    )


def _build_from_genome(genome: np.ndarray, cl,
                       verbose: bool = False) -> "AbismalIndex":
    n = genome.shape[0]

    # clean: exclude long N runs, replace short ones (AbismalIndex.cpp:295-304)
    _stage(verbose, "cleaning reference genome")
    exclude = [(s, e) for s, e in contiguous_n(genome) if e - s > MAX_N_COUNT]
    replace_included_n(genome, exclude)

    _stage(verbose, "encoding genome")
    nibbles = encode_genome_nibbles(genome)
    genome_words = pack_nibbles_u64(nibbles)
    del genome

    _stage(verbose, "computing bucket sizes")
    lim2 = n - KEY_WEIGHT + 1
    lim3 = n - KEY_WEIGHT_THREE + 1
    k2, k3t, k3a = rolling_hashes(nibbles)
    incl = included_mask(n, exclude)

    # pass 1: unmasked bucket sizes (AbismalIndex.cpp:333-436)
    cnt2 = np.bincount(k2[incl[:lim2]], minlength=N_BUCKETS_TWO).astype(
        np.uint32)
    cnt3t = np.bincount(k3t[incl[:lim3]], minlength=N_BUCKETS_THREE).astype(
        np.uint32)
    cnt3a = np.bincount(k3a[incl[:lim3]], minlength=N_BUCKETS_THREE).astype(
        np.uint32)

    # two- vs three-letter classification (AbismalIndex.cpp:471-543) runs
    # over the block decomposition, which does cover interval ends:
    # two_letter_cost(c2) <= three_letter_cost(ct, ca) = (ct + ca) >> 1
    _stage(verbose, "selecting two-letter positions")
    itl = np.zeros(n, dtype=np.uint8)
    m = covered_mask(n, exclude)[:lim2]
    covered = np.flatnonzero(m)
    # three_letter_cost sums in 64 bits (AbismalIndex.cpp:417-420)
    three_cost = (cnt3t[k3t[covered]].astype(np.uint64)
                  + cnt3a[k3a[covered]]) >> np.uint64(1)
    itl[covered] = cnt2[k2[covered]] <= three_cost

    _stage(verbose, "dynamic programming to optimize seed selection")
    # seed-selection DP per block (AbismalIndex.cpp:643-855)
    keep = np.zeros(n, dtype=np.uint8)
    blocks = get_block_bounds(0, 1_000_000, lim2, exclude)
    bstarts = np.asarray([b[0] for b in blocks], dtype=np.int64)
    bends = np.asarray([b[1] for b in blocks], dtype=np.int64)
    get_lib().compress_dp_blocks(
        nibbles.ctypes.data, cnt2.ctypes.data, cnt3t.ctypes.data,
        cnt3a.ctypes.data, itl.ctypes.data, bstarts.ctypes.data,
        bends.ctypes.data, len(blocks), WINDOW_SIZE, keep.ctypes.data,
    )

    _stage(verbose, "hashing and sorting buckets")
    # pass 2: masked bucket sizes + fill + suffix sort
    keep_b = keep.view(bool)
    cm = incl[:lim2]  # the fill loops skip interval ends like the counts
    kept2 = np.flatnonzero(cm & keep_b[:lim2] & itl.view(bool)[:lim2])
    kept3 = np.flatnonzero(cm & keep_b[:lim2] & ~itl.view(bool)[:lim2])

    bits = NIBBLE_TO_BIT[nibbles]
    counter, index = _sorted_bucket_fill(
        k2[kept2], kept2.astype(np.uint32),
        lambda p: _suffix_keys_two(bits, p.astype(np.int64)), N_BUCKETS_TWO,
    )
    srt_t = NIBBLE_TO_SRT_CT[nibbles]
    counter_t, index_t = _sorted_bucket_fill(
        k3t[kept3], kept3.astype(np.uint32),
        lambda p: _suffix_keys_three(srt_t, p.astype(np.int64)),
        N_BUCKETS_THREE,
    )
    srt_a = NIBBLE_TO_SRT_GA[nibbles]
    counter_a, index_a = _sorted_bucket_fill(
        k3a[kept3], kept3.astype(np.uint32),
        lambda p: _suffix_keys_three(srt_a, p.astype(np.int64)),
        N_BUCKETS_THREE,
    )

    _stage(verbose, "")
    return AbismalIndex(
        cl=cl, genome_words=genome_words, counter=counter,
        counter_t=counter_t, counter_a=counter_a, index=index,
        index_t=index_t, index_a=index_a, exclude=exclude,
    )


def create_index(genome_file: str, verbose: bool = False,
                 n_threads: int = 1, numpy_build: bool = False
                 ) -> AbismalIndex:
    """Standard index build (AbismalIndex.cpp:281-331).  The default path
    is the streaming native build; `numpy_build` selects the vectorized
    NumPy oracle (small genomes / differential tests)."""
    genome, cl = load_genome(genome_file)
    if numpy_build:
        return _build_from_genome(genome, cl, verbose)
    return _build_from_genome_native(genome, cl, n_threads, verbose)


def create_index_targets(targets_file: str, genome_file: str,
                         verbose: bool = False, n_threads: int = 1,
                         numpy_build: bool = False) -> AbismalIndex:
    """Target-capture index build: mask everything outside the target
    regions before cleaning (AbismalIndex.cpp:206-279)."""
    genome, cl = load_genome(genome_file)
    raw = load_target_regions(targets_file)
    ordered = sort_by_chrom(cl.names, raw)
    flat = []
    for chrom, s, e in ordered:
        flat.append((cl.get_pos(chrom, s), cl.get_pos(chrom, e)))
    mask_non_target(flat, genome)
    if numpy_build:
        return _build_from_genome(genome, cl, verbose)
    return _build_from_genome_native(genome, cl, n_threads, verbose)
