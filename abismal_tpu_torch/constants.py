"""Shared constants.  Values mirror the reference so that indexes and SAM
output are bit-compatible (reference: src/AbismalIndex.hpp:66-99,
src/AbismalAlign.hpp:50-102, src/common.hpp:108-131, src/abismal.cpp:81-84).

ABISMAL_TPU_SHORT=1 selects the reference's ENABLE_SHORT build profile
(window_size 12 instead of 20, for reads shorter than the default's 44 bp
minimum; the reference configure.ac:69-73, AbismalIndex.hpp:73-77).  It is
an import-time switch because, like the reference's compile-time flag, it
changes the index format (validated on read) and every derived limit; the
native helper is rebuilt with -DABISMAL_SHORT to match.
"""

import os as _os

# --- seed parameters (AbismalIndex.hpp:66-99) ---
SHORT_PROFILE = bool(_os.environ.get("ABISMAL_TPU_SHORT"))
KEY_WEIGHT = 25  # bits in the two-letter hash
KEY_WEIGHT_THREE = 16  # symbols in the three-letter hash
# every window of this size keeps >=1 indexed position
WINDOW_SIZE = 12 if SHORT_PROFILE else 20
N_SORTING_POSITIONS = 256  # suffix length used to sort within buckets
HASH_MASK = (1 << KEY_WEIGHT) - 1
HASH_MASK_THREE = 3**KEY_WEIGHT_THREE  # 43,046,721
PADDING_SIZE = 32767  # int16 max; N padding on both genome ends

# --- index construction (AbismalIndex.hpp:246-250) ---
INTERNAL_IDENTIFIER = b"AbismalIndex"
DEFAULT_MAX_CANDIDATES = 100
MAX_N_COUNT = 256  # N-runs longer than this are excluded, shorter replaced

# --- mapping engine (abismal.cpp) ---
BATCH_SIZE = 1000  # reads per ReadLoader batch (abismal.cpp:207)
MIN_READ_LENGTH = KEY_WEIGHT + WINDOW_SIZE - 1  # 44 (abismal.cpp:211-213)
SE_MAX_CANDIDATES = 50  # se_candidates::max_size (abismal.cpp:448)
PE_MAX_SIZE_SMALL = 32  # pe_candidates (abismal.cpp:861-862)
PE_MAX_SIZE_LARGE = 32 << 10  # 32768
VALID_FRAC_DEFAULT = 0.1  # se_element::valid_frac (abismal.cpp:225)
INVALID_HIT_FRAC = 0.4  # se_element::invalid_hit_frac (abismal.cpp:228)
GOOD_FRAC_DENOM = 10  # good_cutoff = readlen / 10 (abismal.cpp:419-423)
MIN_FOLD_SIZE = 10  # two- vs three-letter seed fold (abismal.cpp:1351)
SAME_POS_TOLERANCE = 3  # same_pos MIN_DIFF_FOR_EQUAL (abismal.cpp:1431)
PE_MIN_DIST_DEFAULT = 32  # pe_element (abismal.cpp:615-618)
PE_MAX_DIST_DEFAULT = 3000
MAX_DIFFS_SENTINEL = 32767  # se_element() default diffs = int16 max

# --- alignment scoring (AbismalAlign.hpp:50-102) ---
ALN_MATCH = 2
ALN_MISMATCH = -3
ALN_INDEL = -4
MAX_OFF_DIAG = 30  # band half width (AbismalAlign.hpp:133)
BANDWIDTH = 2 * MAX_OFF_DIAG + 1  # 61

# --- CIGAR ops (abismal_cigar_utils.hpp:26-56 / SAM spec) ---
CIGAR_MATCH = 0  # M
CIGAR_INS = 1  # I
CIGAR_DEL = 2  # D
CIGAR_REF_SKIP = 3  # N
CIGAR_SOFT = 4  # S
CIGAR_SHIFT = 4
CIGAR_OPS = "MIDNSHP=XB"
# 2-bit consume flags per op (1 = query, 2 = ref)
CIGAR_TYPE = (3, 1, 2, 2, 1, 0, 0, 3, 3, 0)

# --- SAM flags (common.hpp:108-131) ---
SAM_PAIRED = 0x1
SAM_PAIR_MAPPED = 0x2
SAM_UNMAPPED = 0x4
SAM_MATE_UNMAPPED = 0x8
SAM_RC = 0x10
SAM_MATE_RC = 0x20
SAM_TEMPLATE_FIRST = 0x40
SAM_TEMPLATE_LAST = 0x80
SAM_SECONDARY = 0x100
# abismal-internal extra flag bit: read is A-rich (abismal.cpp:81-84)
BSFLAG_A_RICH = 0x1000

VERSION_STRING = "3.3.0"  # reference version used in @PG header parity
