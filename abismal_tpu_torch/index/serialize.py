"""Binary index serialization in the reference's exact on-disk format
(src/AbismalIndex.cpp:980-1146), so indexes interoperate with the reference
binary and the index md5 test passes.

Layout (little endian):
  "AbismalIndex" (12 bytes)
  u32 key_weight, u32 window_size, u32 n_sorting_positions
  ChromLookup: u32 n_chroms; per chrom {u32 name_len; bytes name};
               u32 starts[n_chroms + 1]
  u64 genome_words[ceil(genome_size / 16)]
  u32 max_candidates
  u64 counter_size (= 2^25), u64 counter_size_three (= 3^16)
  u64 index_size, u64 index_size_three
  u32 counter[counter_size + 1]
  u32 counter_t[counter_size_three + 1], u32 counter_a[...]
  u32 index[index_size], u32 index_t[...], u32 index_a[...]
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    HASH_MASK_THREE,
    INTERNAL_IDENTIFIER,
    KEY_WEIGHT,
    N_SORTING_POSITIONS,
    WINDOW_SIZE,
)
from ..io.genome import ChromLookup
from .build import AbismalIndex


def write_index(idx: AbismalIndex, path: str) -> None:
    with open(path, "wb") as f:
        f.write(INTERNAL_IDENTIFIER)
        f.write(np.asarray(
            [KEY_WEIGHT, WINDOW_SIZE, N_SORTING_POSITIONS], dtype="<u4"
        ).tobytes())
        idx.cl.write(f)
        f.write(np.ascontiguousarray(idx.genome_words, dtype="<u8").tobytes())
        f.write(np.uint32(idx.max_candidates).tobytes())
        f.write(np.asarray(
            [idx.counter.shape[0] - 1, idx.counter_t.shape[0] - 1,
             idx.index.shape[0], idx.index_t.shape[0]], dtype="<u8"
        ).tobytes())
        for a in (idx.counter, idx.counter_t, idx.counter_a, idx.index,
                  idx.index_t, idx.index_a):
            f.write(np.ascontiguousarray(a, dtype="<u4").tobytes())


def read_index(path: str) -> AbismalIndex:
    with open(path, "rb") as f:
        magic = f.read(len(INTERNAL_IDENTIFIER))
        if magic != INTERNAL_IDENTIFIER:
            raise RuntimeError(f"index file format problem: {path}")
        kw, ws, nsp = np.frombuffer(f.read(12), dtype="<u4")
        if (kw, ws, nsp) != (KEY_WEIGHT, WINDOW_SIZE, N_SORTING_POSITIONS):
            raise RuntimeError("inconsistent seed parameters in index")
        cl = ChromLookup.read(f)
        n_words = (cl.get_genome_size() + 15) // 16
        genome_words = np.frombuffer(
            f.read(8 * n_words), dtype="<u8"
        ).copy()
        max_candidates = int(np.frombuffer(f.read(4), dtype="<u4")[0])
        cs, cs3, isz, isz3 = np.frombuffer(f.read(32), dtype="<u8")
        if cs != 1 << KEY_WEIGHT or cs3 != HASH_MASK_THREE:
            raise RuntimeError("inconsistent table sizes in index")

        def arr(count):
            return np.frombuffer(f.read(4 * int(count)), dtype="<u4").copy()

        counter = arr(cs + 1)
        counter_t = arr(cs3 + 1)
        counter_a = arr(cs3 + 1)
        index = arr(isz)
        index_t = arr(isz3)
        index_a = arr(isz3)

    return AbismalIndex(
        cl=cl, genome_words=genome_words, counter=counter,
        counter_t=counter_t, counter_a=counter_a, index=index,
        index_t=index_t, index_a=index_a, max_candidates=max_candidates,
    )
