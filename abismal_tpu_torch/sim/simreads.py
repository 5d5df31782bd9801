"""WGBS read simulator, output-compatible with `abismal sim`
(reference: src/simreads.cpp).

The sequential sampling loop runs in the native library so that the RNG
stream (std::mt19937 + the libstdc++ uniform-distribution mappings, plus the
deterministic LCG used for filler bases) is consumed in exactly the
reference's order, making the FASTQ outputs byte-identical for a given seed.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from ..io.genome import load_genome
from ..native import get_lib


@dataclass
class SimConfig:
    output_prefix: str
    n_reads: int = 100
    read_length: int = 100
    min_frag_len: int = 100
    max_frag_len: int = 250
    mutation_rate: float = 0.0
    substitution_rate: float = 1.0
    insertion_rate: float = 1.0
    deletion_rate: float = 1.0
    bs_conv: float = 1.0
    strand: str = "b"
    pbat: bool = False
    random_pbat: bool = False
    single_end: bool = False
    fasta_format: bool = False
    show_cigar_matches: bool = True
    require_valid: bool = False
    locations_file: str = ""
    seed: int = 1


_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[ord("a"):ord("z") + 1] -= 32


def simulate_reads(genome_file: str, cfg: SimConfig) -> None:
    genome, cl = load_genome(genome_file)
    genome = np.ascontiguousarray(_UPPER[genome])  # simreads.cpp:548-549

    ext = ".fa" if cfg.fasta_format else ".fq"
    read1_path = cfg.output_prefix + "_1" + ext
    read2_path = cfg.output_prefix + "_2" + ext

    starts = np.ascontiguousarray(cl.starts, dtype=np.uint32)
    names_blob = "\n".join(cl.names).encode()

    lib = get_lib()
    ret = lib.simreads_native(
        genome.ctypes.data, genome.shape[0],
        starts.ctypes.data, len(cl.names),
        names_blob,
        cfg.n_reads, cfg.read_length,
        cfg.min_frag_len, cfg.max_frag_len,
        cfg.strand.encode()[:1],
        int(cfg.pbat), int(cfg.random_pbat),
        int(cfg.require_valid),
        cfg.mutation_rate, cfg.substitution_rate, cfg.insertion_rate,
        cfg.deletion_rate,
        cfg.bs_conv,
        ctypes.c_uint64(cfg.seed),
        int(cfg.single_end), int(cfg.fasta_format),
        int(cfg.show_cigar_matches),
        read1_path.encode(), read2_path.encode(),
        cfg.locations_file.encode(),
    )
    if ret != 0:
        raise RuntimeError("simreads_native failed (bad output path?)")
