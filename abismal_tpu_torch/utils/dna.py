"""DNA 4-bit nibble encodings and bisulfite read encodings as NumPy tables.

The nibble of a base is its one-hot set {A=1, C=2, G=4, T=8}; IUPAC codes are
unions and N=15 (reference: src/dna_four_bit_bisulfite.hpp:59-165).  Reads
are encoded with bisulfite wildcards: T-rich reads use T=0b1010 (matches C or
T), A-rich reads use A=0b0101 (matches A or G)
(dna_four_bit_bisulfite.hpp:26-57).
"""

import numpy as np

_DECODE = "ZACMGRSVTWYHKDBN"

# ASCII -> genome nibble (dna_four_bit_bisulfite.hpp:156-165).  NB: in the
# reference's encoding table 'N' maps to 0 (the empty base set, matching
# nothing), NOT 15 -- the table comment says 15 but the actual entry at index
# 78 is 0, so N regions of the genome hash as zero nibbles and never match
# any read base.  We reproduce that exactly.
ENCODE_GENOME = np.zeros(256, dtype=np.uint8)
for _c, _v in (("A", 1), ("B", 14), ("C", 2), ("D", 13), ("G", 4),
               ("H", 11), ("K", 12), ("M", 3), ("N", 0), ("R", 5),
               ("S", 6), ("T", 8), ("V", 7), ("W", 9), ("Y", 10)):
    ENCODE_GENOME[ord(_c)] = _v
    ENCODE_GENOME[ord(_c.lower())] = _v

# ASCII -> T-rich read nibble: A=1 C=2 G=4 T=10 (dna_four_bit_bisulfite.hpp:32-41)
ENCODE_T_RICH = np.zeros(256, dtype=np.uint8)
for _c, _v in (("A", 1), ("C", 2), ("G", 4), ("T", 10)):
    ENCODE_T_RICH[ord(_c)] = _v
    ENCODE_T_RICH[ord(_c.lower())] = _v

# ASCII -> A-rich read nibble: A=5 C=2 G=4 T=8 (dna_four_bit_bisulfite.hpp:48-57)
ENCODE_A_RICH = np.zeros(256, dtype=np.uint8)
for _c, _v in (("A", 5), ("C", 2), ("G", 4), ("T", 8)):
    ENCODE_A_RICH[ord(_c)] = _v
    ENCODE_A_RICH[ord(_c.lower())] = _v

# reverse complement over ASCII bytes: A<->T, C<->G, everything else N
# (common.hpp:29-36)
REVCOMP_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("G", "C"), ("T", "A")):
    REVCOMP_TABLE[ord(_a)] = ord(_b)

# two-letter bit of a nibble: 0 for purines {A,G}, 1 for pyrimidines {C,T}
# (AbismalIndex.hpp:254-258: get_bit(nt) = ((nt & 5) == 0))
NIBBLE_TO_BIT = np.array([(n & 5) == 0 for n in range(16)], dtype=np.uint8)

# three-letter number of a nibble (AbismalIndex.hpp:260-269)
#   c_to_t: C=T=0, A=1, G=2       g_to_a: A=G=0, C=1, T=2
NIBBLE_TO_THREE_CT = np.array(
    [(((n & 4) != 0) << 1) | ((n & 1) != 0) for n in range(16)], dtype=np.uint8
)
NIBBLE_TO_THREE_GA = np.array(
    [(((n & 8) != 0) << 1) | ((n & 2) != 0) for n in range(16)], dtype=np.uint8
)

# fast three-letter symbols used for bucket sorting / seed extension
# (AbismalIndex.cpp:877-903, abismal.cpp:1196-1203): nt & 5 resp. nt & 10
NIBBLE_TO_SRT_CT = np.array([n & 5 for n in range(16)], dtype=np.uint8)
NIBBLE_TO_SRT_GA = np.array([n & 10 for n in range(16)], dtype=np.uint8)


def revcomp_bytes(seq: np.ndarray) -> np.ndarray:
    """Reverse complement of an ASCII uint8 array."""
    return REVCOMP_TABLE[seq][::-1]


def revcomp_str(seq: str) -> str:
    return revcomp_bytes(np.frombuffer(seq.encode(), dtype=np.uint8)).tobytes().decode()


def encode_genome_nibbles(ascii_genome: np.ndarray) -> np.ndarray:
    """ASCII uint8 genome -> per-base nibble array (uint8)."""
    return ENCODE_GENOME[ascii_genome]


def pack_nibbles_u64(nibbles: np.ndarray) -> np.ndarray:
    """Pack per-base nibbles into 64-bit words, 16 bases per word, base i at
    bit position 4*(i % 16) (dna_four_bit_bisulfite.hpp:169-187).  Tail
    nibbles of the last word are zero ('Z')."""
    n = nibbles.shape[0]
    n_words = (n + 15) // 16
    # byte k of the little-endian word stream = nib[2k] | nib[2k+1] << 4;
    # two strided passes (O(bytes) traffic) instead of a 16-lane u64
    # broadcast, which matters at hg38 scale
    b = np.zeros(n_words * 8, dtype=np.uint8)
    ev = nibbles[0::2]
    od = nibbles[1::2]
    b[: ev.size] = ev
    b[: od.size] |= od << 4
    return b.view(np.uint64)


def unpack_nibbles_u64(words: np.ndarray, n_bases: int) -> np.ndarray:
    """Inverse of pack_nibbles_u64.  Works on the little-endian byte view
    (low nibble = even base) so memory traffic is O(2 bytes/base) instead
    of the 16x-u64 broadcast (hg38-scale genomes: ~3 GB, not ~25 GB)."""
    b = np.ascontiguousarray(words).view(np.uint8)
    out = np.empty(b.size * 2, dtype=np.uint8)
    np.bitwise_and(b, 0xF, out=out[0::2])
    np.right_shift(b, 4, out=out[1::2])
    return out[:n_bases]
