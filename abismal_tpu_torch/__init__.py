"""abismal-tpu-torch: the PyTorch + CUDA port of abismal_tpu (single-end
and paired-end bisulfite read mapping on NVIDIA H100 cards, over a mesh of
devices, beside the host cores or in read-range shards).  The package
stands alone: the device programs and their hand-written CUDA kernels,
and its own host side -- I/O, the index, the native C++ engine, run_map,
the hybrid split, the read simulator.  It imports torch, never JAX and
nothing of abismal_tpu.

Subpackages:
  constants  -- seed / scoring / flag constants (reference parity values)
  utils      -- DNA encodings and small helpers
  io         -- FASTA/FASTQ readers, SAM/BAM writers
  index      -- index build and reference-format serialization
  sim        -- WGBS read simulator (bit-compatible with `abismal sim`)
  native     -- the C++ host libraries and their g++ build
  map        -- the device pipeline, the native engine, the mapping loop
  kernels    -- the CUDA kernels' wrappers, plain versions and nvcc build
  parallel   -- mesh and read-range sharding
"""

import os as _os

# numpy madvises allocations >= 4 MB to transparent hugepages by default;
# on hosts where a fresh 2M THP fault is slow (VM memory ballooning, direct
# compaction under madvise-mode defrag) that makes every big allocation
# many times slower than plain 4K faults and run-to-run timing noisy.
# Always disabled here; the native engine instead MADV_COLLAPSEs its big
# RESIDENT tables at init (ABISMAL_THP=0 turns that off).  Set
# NUMPY_MADVISE_HUGEPAGE=1 explicitly to restore numpy's behavior.
if _os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0") == "0":
    try:
        import numpy as _np

        try:
            _np._core.multiarray._set_madvise_hugepage(False)
        except AttributeError:  # numpy < 2
            _np.core.multiarray._set_madvise_hugepage(False)
    except Exception:
        pass
