"""ctypes loader for the native host-side helper libraries, building them
with g++ on first use.  A library lands in build/abismal_tpu_torch/ at the
repository root, keyed by a content hash of its source (never committed,
never trusted by mtime), so a fresh checkout or a source edit always
triggers a rebuild and a stale binary compiled for a different CPU can
never be loaded.  Concurrent builds (test workers, shard processes) each
compile to a temporary file of their own and rename it into place."""

import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "abismal_tpu_torch")
_LOCK = threading.Lock()
_LIBS = {}


def _load(stem: str) -> ctypes.CDLL:
    """Builds (if needed) and loads <stem>.cpp as <stem>-<srchash>.so.
    The ENABLE_SHORT profile (constants.SHORT_PROFILE) compiles a separate
    artifact with -DABISMAL_SHORT, keyed into the filename."""
    from ..constants import SHORT_PROFILE

    src = os.path.join(_HERE, stem + ".cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    suffix = "-short" if SHORT_PROFILE else ""
    so = os.path.join(BUILD_DIR, f"{stem}-{digest}{suffix}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = so + f".tmp{os.getpid()}"
        cmd = [
            "g++", "-std=c++17", "-O3", "-fPIC", "-shared", "-march=native",
            "-pthread", "-o", tmp, src, "-lz",
        ]
        if SHORT_PROFILE:
            cmd.insert(1, "-DABISMAL_SHORT")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def get_lib() -> ctypes.CDLL:
    with _LOCK:
        if "_native" in _LIBS:
            return _LIBS["_native"]
        lib = _load("_native")

        lib.lcg_random_bases.restype = ctypes.c_uint32
        lib.lcg_random_bases.argtypes = [
            ctypes.c_uint32, ctypes.c_int64, ctypes.c_void_p,
        ]

        lib.index_clean_genome.restype = ctypes.c_int64
        lib.index_clean_genome.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # genome, n, max
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # exc out, cap
        ]

        lib.encode_pack_genome.restype = None
        lib.encode_pack_genome.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # ascii/n/table
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # nib/words/thr
        ]

        lib.compress_dp_blocks.restype = None
        lib.compress_dp_blocks.argtypes = [
            ctypes.c_void_p,  # nibbles
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # counters
            ctypes.c_void_p,  # itl
            ctypes.c_void_p, ctypes.c_void_p,  # block starts/ends
            ctypes.c_int64,  # n_blocks
            ctypes.c_uint32,  # window
            ctypes.c_void_p,  # keep out
        ]

        lib.banded_align_score.restype = ctypes.c_int16
        lib.banded_align_score.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # genome nibbles, query
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # q_sz, pos, bw
            ctypes.c_void_p,  # scratch
        ]

        lib.banded_align_traceback.restype = ctypes.c_int64
        lib.banded_align_traceback.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,  # scratch, tb scratch
            ctypes.c_void_p,  # cigar out
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # len/pos/score
        ]

        lib.index_count_hashes.restype = None
        lib.index_count_hashes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,  # nibbles, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # exclude
            ctypes.c_void_p, ctypes.c_void_p,  # keep, itl (null = unmasked)
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # counts
        ]

        lib.index_select_two_letter.restype = None
        lib.index_select_two_letter.argtypes = [
            ctypes.c_void_p,  # nibbles
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # counts
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # blocks
            ctypes.c_void_p, ctypes.c_int,  # itl out, n_threads
        ]

        lib.compress_dp_blocks_mt.restype = None
        lib.compress_dp_blocks_mt.argtypes = (
            lib.compress_dp_blocks.argtypes + [ctypes.c_int]
        )

        lib.index_fill_and_sort.restype = None
        lib.index_fill_and_sort.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,  # nibbles, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # exclude
            ctypes.c_void_p, ctypes.c_void_p,  # keep, itl
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # counters
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indexes out
            ctypes.c_int,  # n_threads
        ]

        lib.index_count_kept.restype = None
        lib.index_count_kept.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # keep/itl/lim
            ctypes.c_void_p, ctypes.c_void_p,  # out_n2, out_n3
            ctypes.c_int,  # n_threads
        ]

        lib.index_capture_kept.restype = None
        lib.index_capture_kept.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,  # nibbles, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # exclude
            ctypes.c_void_p, ctypes.c_void_p,  # keep, itl
            ctypes.c_void_p, ctypes.c_void_p,  # k2, p2 out
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # k3t/k3a/p3
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cnt out
            ctypes.c_void_p, ctypes.c_void_p,  # out_n2, out_n3
            ctypes.c_int,  # n_threads
        ]

        lib.index_place_and_sort.restype = None
        lib.index_place_and_sort.argtypes = [
            ctypes.c_void_p,  # nibbles
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # k2, p2, n2
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # k3t/k3a/p3
            ctypes.c_int64,  # n3
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # counters
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indexes out
            ctypes.c_int,  # n_threads
        ]

        lib.simreads_native.restype = ctypes.c_int
        lib.simreads_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,  # genome, size
            ctypes.c_void_p, ctypes.c_int64,  # chrom starts, n_chroms
            ctypes.c_char_p,  # names joined
            ctypes.c_int64, ctypes.c_int64,  # n_reads, read_length
            ctypes.c_int64, ctypes.c_int64,  # min/max frag
            ctypes.c_char,  # strand code
            ctypes.c_int, ctypes.c_int,  # pbat, random_pbat
            ctypes.c_int,  # require_valid
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double,  # mutation, sub, ins, del
            ctypes.c_double,  # bs_conv
            ctypes.c_uint64,  # seed
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # single, fasta, show
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,  # paths
        ]

        _LIBS["_native"] = lib
        return lib


def get_engine_lib() -> ctypes.CDLL:
    """The batched native mapping engine (_engine.cpp)."""
    with _LOCK:
        if "_engine" in _LIBS:
            return _LIBS["_engine"]
        lib = _load("_engine")

        lib.engine_create.restype = ctypes.c_void_p
        lib.engine_create.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # nib/words/sz
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # counters
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # indexes
            ctypes.c_int64,  # max_candidates
            ctypes.c_void_p, ctypes.c_int64,  # chrom starts, n_chroms
            ctypes.c_char_p,  # names blob
            ctypes.c_int, ctypes.c_double,  # allow_ambig, valid_frac
            ctypes.c_int64, ctypes.c_int64,  # pe_min, pe_max
        ]
        lib.engine_destroy.restype = None
        lib.engine_destroy.argtypes = [ctypes.c_void_p]

        _ev = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pos/d/rank
            ctypes.c_void_p, ctypes.c_void_p,  # start/count
            ctypes.c_int64,  # boundary
        ]
        lib.engine_map_se_batch.restype = ctypes.c_int64
        lib.engine_map_se_batch.argtypes = (
            [ctypes.c_void_p]
            + [ctypes.c_void_p] * 4  # reads blob/offs, names blob/offs
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + _ev + [ctypes.c_int, ctypes.c_void_p]
        )
        # the finalize pool: a submit returns a job, read by engine_job_*
        lib.engine_se_finalize_submit.restype = ctypes.c_void_p
        lib.engine_se_finalize_submit.argtypes = (
            [ctypes.c_void_p]
            + [ctypes.c_void_p] * 4  # reads blob/offs, names blob/offs
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p]  # records (n_reads, 4) i32
            + [ctypes.c_void_p] * 2  # device cigar ops/meta (nullable)
            + [ctypes.c_int64]  # tb_nops (ops row stride)
            + [ctypes.c_int]  # n_threads
        )
        lib.engine_map_pe_batch.restype = ctypes.c_int64
        lib.engine_map_pe_batch.argtypes = (
            [ctypes.c_void_p]
            + [ctypes.c_void_p] * 8  # two ends x (reads, offs, names, offs)
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + _ev + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.engine_pe_slots_submit.restype = ctypes.c_void_p
        lib.engine_pe_slots_submit.argtypes = (
            [ctypes.c_void_p]
            + [ctypes.c_void_p] * 8  # two ends x (reads, offs, names, offs)
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 3  # slot pos / ds / cnt
            + [ctypes.c_int64]       # k2 (slots per unit)
            + [ctypes.c_void_p, ctypes.c_int64]  # mate records, stride
            + [ctypes.c_int]  # n_threads
        )
        lib.engine_job_done.restype = ctypes.c_int
        lib.engine_job_wait.restype = ctypes.c_int64
        lib.engine_job_wait.argtypes = [ctypes.c_void_p] * 3  # stats_out
        lib.engine_job_out_ptr.restype = ctypes.c_void_p
        lib.engine_job_first.restype = ctypes.c_int64
        lib.engine_job_release.restype = None
        for name in ("engine_job_done", "engine_job_out_ptr",
                     "engine_job_first", "engine_job_release"):
            getattr(lib, name).argtypes = [ctypes.c_void_p] * 2
        lib.engine_out_ptr.restype = ctypes.c_void_p
        lib.engine_out_ptr.argtypes = [ctypes.c_void_p]
        # the device's unit rows, on the calling thread: 0, or -1 where
        # the two ends' read counts differ
        _end = [ctypes.c_void_p] * 2 + [ctypes.c_int64]  # blob, offs, n
        _enc = ([ctypes.c_int, ctypes.c_int]  # modes
                + [ctypes.c_int64] * 2  # lmax, row stride
                + [ctypes.c_void_p] * 4)  # pnib, lens, oversized, counts
        lib.encode_se_units.restype = ctypes.c_int64
        lib.encode_se_units.argtypes = _end + _enc
        lib.encode_pe_units.restype = ctypes.c_int64
        lib.encode_pe_units.argtypes = _end * 2 + _enc

        lib.engine_se_phase1.restype = ctypes.c_int64
        lib.engine_se_phase1.argtypes = (
            [ctypes.c_void_p]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + _ev + [ctypes.c_int]
        )
        lib.engine_jobs_ptr.restype = ctypes.c_void_p
        lib.engine_jobs_ptr.argtypes = [ctypes.c_void_p]
        lib.engine_se_phase2.restype = ctypes.c_int64
        lib.engine_se_phase2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]

        lib.engine_pe_phase1.restype = ctypes.c_int64
        lib.engine_pe_phase1.argtypes = (
            [ctypes.c_void_p]
            + [ctypes.c_void_p] * 8
            + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + _ev + [ctypes.c_int]
        )
        lib.engine_pe_jobs_ptr.restype = ctypes.c_void_p
        lib.engine_pe_jobs_ptr.argtypes = [ctypes.c_void_p]
        lib.engine_pe_phase2.restype = ctypes.c_int64
        lib.engine_pe_phase2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]

        lib.engine_error_ptr.restype = ctypes.c_char_p
        lib.engine_error_ptr.argtypes = [ctypes.c_void_p]
        lib.engine_set_profile.restype = None
        lib.engine_set_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.engine_stage_ns.restype = None
        lib.engine_stage_ns.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.engine_run_se.restype = ctypes.c_int64
        lib.engine_run_se.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,  # fq, out
            ctypes.c_char_p, ctypes.c_int64,  # header, header_len
            ctypes.c_int, ctypes.c_int,  # a_rich_mode, random_pbat
            ctypes.c_int64, ctypes.c_int,  # batch_size, n_threads
            ctypes.c_void_p, ctypes.c_int,  # stats_out, verbose
            ctypes.c_int64, ctypes.c_int64,  # skip_reads, max_reads
            ctypes.c_int,  # out_bam
        ]
        lib.engine_run_pe.restype = ctypes.c_int64
        lib.engine_run_pe.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p,  # fq1, fq2, out
            ctypes.c_char_p, ctypes.c_int64,  # header, header_len
            ctypes.c_int, ctypes.c_int,  # a_rich_mode, random_pbat
            ctypes.c_int64, ctypes.c_int,  # batch_size, n_threads
            ctypes.c_void_p, ctypes.c_int,  # stats_out, verbose
            ctypes.c_int64, ctypes.c_int64,  # skip_reads, max_reads
            ctypes.c_int,  # out_bam
        ]

        lib.fastq_open.restype = ctypes.c_void_p
        lib.fastq_open.argtypes = [ctypes.c_char_p]
        lib.fastq_close.restype = None
        lib.fastq_close.argtypes = [ctypes.c_void_p]
        lib.fastq_skip.restype = ctypes.c_int64
        lib.fastq_skip.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.fastq_next_batch.restype = ctypes.c_int64
        lib.fastq_next_batch.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        for name in ("fastq_rblob_ptr", "fastq_roffs_ptr", "fastq_nblob_ptr",
                     "fastq_noffs_ptr"):
            getattr(lib, name).restype = ctypes.c_void_p
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        for name in ("fastq_bytes_parsed", "fastq_byte_pos"):
            getattr(lib, name).restype = ctypes.c_int64
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.fastq_error_ptr.restype = ctypes.c_char_p
        lib.fastq_error_ptr.argtypes = [ctypes.c_void_p]

        _LIBS["_engine"] = lib
        return lib
