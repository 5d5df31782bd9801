"""Python front end of the native batched mapping engine (_engine.cpp).

The native library implements the complete per-read decide/align/format
stage (candidate heaps, banded alignment, PE mating, SAM records, stats)
plus a full native seeding path, multithreaded over the reads of a batch
with read-order output (deterministic at any thread count).  This class
feeds it read batches and, optionally, device stage-1 event streams; the
companion `TorchNativeEngine` in pipeline.py supplies those events from the
accelerator.

Semantics are identical to the pure-Python `MappingEngine` oracle
(map/engine.py), which is parity-validated byte-for-byte against the
reference (src/abismal.cpp:1435-2185)."""

from __future__ import annotations

import contextlib
import ctypes
from collections import deque

import numpy as np

from ..constants import (
    PE_MAX_DIST_DEFAULT,
    PE_MIN_DIST_DEFAULT,
    VALID_FRAC_DEFAULT,
)
from ..io.fastq import ReadLoader
from ..io.sam import make_sam_header
from ..tracing import Tracer
from .stats import PEStats, SEStats

_SE_FIELDS = ("total_reads", "reads_mapped_unique", "reads_mapped_ambiguous",
              "reads_skipped", "edit_distance", "total_bases")


def _blob(items):
    """list of bytes -> (blob ascii array, int64 offsets)."""
    offs = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum(np.fromiter(map(len, items), np.int64, len(items)),
              out=offs[1:])
    blob = np.frombuffer(b"".join(items), dtype=np.uint8)
    if blob.size == 0:
        blob = np.zeros(1, dtype=np.uint8)
    return blob, offs


def seq_blob(reads):
    """The sequences of (name, sequence) reads as one blob: (ascii u8
    array, int64 offsets).  The device route builds it once a batch, for
    the unit encoder (encode_units) and the finalize."""
    return _blob([s for _, s in reads])


def _name_blob(reads):
    return _blob([n.encode() for n, _ in reads])


def _pair_blobs(reads1, reads2, seqs=None):
    """The read and name blobs of both ends: (reads 1, offsets, names 1,
    offsets, then the same of end 2); seqs, the two ends' seq_blob where
    the caller has them."""
    seqs = seqs or (seq_blob(reads1), seq_blob(reads2))
    return seqs[0] + _name_blob(reads1) + seqs[1] + _name_blob(reads2)


def units_per(paired, random_pbat):
    """The device units of a read (single-end) or of a pair: a unit a
    strand and conversion the mapper tries."""
    return (8 if random_pbat else 4) if paired else (4 if random_pbat else 2)


def _check_pair_sizes(n1, n2):
    if n1 != n2:
        raise RuntimeError(
            f"paired-end batch sizes differ. Batch 1: {n1}, "
            f"Batch 2: {n2}. Are you sure your paired-end "
            "inputs have the same number of reads?")


def encode_units(lmax, seqs, a_rich_mode, random_pbat):
    """(pnib, lens_u, per, oversized, n_rows, n_long): every read's
    (pair's) `per` device units as packed nibble rows (lmax + 32 nibbles,
    two a byte), their lengths, the reads (pairs) over lmax, the rows
    written with bases and the reads (mates) over lmax, encoded by the
    native library (encode_se_units / encode_pe_units) on the calling
    thread.  seqs is (seq_blob(reads),) for single-end reads, an end's
    seq_blob each for pairs; ends of different read counts raise.  The
    rows are the JAX package's (_se_units_mat / _pe_units_mat); empty
    reads and oversized reads (pairs) go up as zero-length rows."""
    from ..native import get_engine_lib

    paired = len(seqs) == 2
    per = units_per(paired, random_pbat)
    ns = [offs.shape[0] - 1 for _, offs in seqs]
    if paired:
        _check_pair_sizes(*ns)
    R = ns[0]
    pnib = np.zeros((per * max(R, 1), (lmax + 32) // 2), np.uint8)
    # as JAX's: an empty batch's rows are one zero block, its lengths
    # that block's for pairs and none for single-end reads
    lens_u = np.zeros(per * (max(R, 1) if paired else R), np.int32)
    oversized = np.zeros(R, dtype=bool)
    counts = np.zeros(2, np.int64)
    lib = get_engine_lib()
    encode = lib.encode_pe_units if paired else lib.encode_se_units
    rc = encode(*(a for (blob, offs), n in zip(seqs, ns)
                  for a in (_ptr(blob), _ptr(offs), n)),
                int(a_rich_mode), int(random_pbat), lmax, pnib.shape[1],
                _ptr(pnib), _ptr(lens_u), _ptr(oversized), _ptr(counts))
    assert rc == 0, rc
    return pnib, lens_u, per, oversized, int(counts[0]), int(counts[1])


def _ptr(a):
    return a.ctypes.data if a is not None else None


def _add_stats(stats, raw):
    """Adds the library's raw counters (6 SE, 18 PE: pair, end 1, end 2)
    to stats (SEStats, or PEStats)."""
    blocks = ((stats,) if raw.size == 6 else
              (stats.read_pair_stats, stats.end1_stats, stats.end2_stats))
    for blk, dst in enumerate(blocks):
        for i, f in enumerate(_SE_FIELDS):
            setattr(dst, f, getattr(dst, f) + int(raw[6 * blk + i]))


class NativeMappingEngine:
    """Drop-in engine for run_map: map_se_reads / map_pe_reads over the
    native library, with internal threading (`n_threads`).  tracer (a
    tracing.Tracer, its own by default; TorchNativeEngine hands it its
    own) times each batch call's input blobs (pack), the library's call
    (native) and the SAM text out (write), and reads the library's
    worker counters.

    The device route's finalize (_finalize_se, _call_pe_slots) hands each
    batch to the library's finalize pool as a job and returns; _write_jobs
    writes the finished jobs in batch order, each to the out and stats it
    came with."""

    supports_pipeline = True

    def __init__(self, index, allow_ambig=False,
                 valid_frac=VALID_FRAC_DEFAULT,
                 pe_min_dist=PE_MIN_DIST_DEFAULT,
                 pe_max_dist=PE_MAX_DIST_DEFAULT, n_threads: int = 1,
                 tracer: Tracer | None = None):
        from ..native import get_engine_lib
        from ..utils.dna import unpack_nibbles_u64

        self.lib = get_engine_lib()
        self.index = index
        self.cl = index.cl
        self.n_threads = max(1, n_threads)
        self.allow_ambig = allow_ambig
        self.pe_min_dist = int(pe_min_dist)
        self.pe_max_dist = int(pe_max_dist)
        # pinned arrays: the native context aliases their memory
        self._nib = np.ascontiguousarray(
            unpack_nibbles_u64(index.genome_words, index.genome_size))
        self._words = np.ascontiguousarray(index.genome_words,
                                           dtype=np.uint64)
        self._c2 = np.ascontiguousarray(index.counter, dtype=np.uint32)
        self._ct = np.ascontiguousarray(index.counter_t, dtype=np.uint32)
        self._ca = np.ascontiguousarray(index.counter_a, dtype=np.uint32)
        self._i2 = np.ascontiguousarray(index.index, dtype=np.uint32)
        self._it = np.ascontiguousarray(index.index_t, dtype=np.uint32)
        self._ia = np.ascontiguousarray(index.index_a, dtype=np.uint32)
        self._starts = np.ascontiguousarray(index.cl.starts, dtype=np.uint64)
        names_blob = "\n".join(index.cl.names).encode()
        self._ctx = self.lib.engine_create(
            _ptr(self._nib), _ptr(self._words), int(index.genome_size),
            _ptr(self._c2), _ptr(self._ct), _ptr(self._ca),
            _ptr(self._i2), _ptr(self._it), _ptr(self._ia),
            int(index.max_candidates),
            _ptr(self._starts), len(index.cl.names), names_blob,
            int(allow_ambig), float(valid_frac), int(pe_min_dist),
            int(pe_max_dist),
        )
        self.tracer = Tracer() if tracer is None else tracer
        self.tracer.bind_native(self)
        # the finalize pool's jobs, oldest first: (job, raw stats size,
        # stats, out, the arrays the library reads until it is released)
        self._jobs = deque()

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self.lib.engine_destroy(ctx)
            self._ctx = None

    @property
    def n_device_mated(self) -> int:
        """Orientations whose mating decision came from the device-resident
        sweep (apply_device_mate; tns slot 14)."""
        ns = np.zeros(16, dtype=np.int64)
        self.lib.engine_stage_ns(self._ctx, _ptr(ns), 0)
        return int(ns[14])

    # ---- event plumbing (None for the pure-native engine) -----------------
    def _event_args(self, events):
        if events is None:
            return (None, None, None, None, None, 0)
        ev_pos, ev_diffs, ev_rank, start, count, boundary = events
        return (_ptr(ev_pos), _ptr(ev_diffs), _ptr(ev_rank), _ptr(start),
                _ptr(count), int(boundary))

    def _emit(self, n, out):
        """The library's last n bytes of SAM text (or BAM records) to out."""
        with self.tracer.span("write"):
            out.write(ctypes.string_at(self.lib.engine_out_ptr(self._ctx),
                                       n).decode())

    # ---- batch calls -------------------------------------------------------
    def _call_se(self, reads, a_rich_mode, random_pbat, stats, out, events):
        tr = self.tracer
        with tr.span("pack"):
            rblob, roffs = seq_blob(reads)
            nblob, noffs = _name_blob(reads)
            st = np.zeros(6, dtype=np.int64)
        with tr.span("native"):
            n = self.lib.engine_map_se_batch(
                self._ctx, _ptr(rblob), _ptr(roffs), _ptr(nblob),
                _ptr(noffs), len(reads), int(a_rich_mode), int(random_pbat),
                *self._event_args(events), self.n_threads, _ptr(st))
        self._emit(n, out)
        _add_stats(stats, st)

    def _call_pe(self, reads1, reads2, a_rich_mode, random_pbat, stats, out,
                 events):
        _check_pair_sizes(len(reads1), len(reads2))
        tr = self.tracer
        with tr.span("pack"):
            (r1b, r1o, n1b, n1o, r2b, r2o, n2b,
             n2o) = _pair_blobs(reads1, reads2)
            st = np.zeros(18, dtype=np.int64)
        with tr.span("native"):
            n = self.lib.engine_map_pe_batch(
                self._ctx, _ptr(r1b), _ptr(r1o), _ptr(n1b), _ptr(n1o),
                _ptr(r2b), _ptr(r2o), _ptr(n2b), _ptr(n2o),
                len(reads1), int(a_rich_mode), int(random_pbat),
                *self._event_args(events), self.n_threads, _ptr(st))
        self._emit(n, out)
        _add_stats(stats, st)

    def _call_pe_slots(self, reads1, reads2, a_rich_mode, random_pbat,
                       stats, out, sl_pos, sl_ds, sl_cnt, mate, seqs):
        """PE finalize from device stage-1+2 candidate slots (pipeline.py
        build_stage12pe): per-unit prescored candidate lists replace the
        event stream and the host score pass; units with cnt < 0 re-seed
        natively (byte-identical at any fallback rate).  mate: the
        device's mate rows, or None; seqs: the two ends' seq_blob, as the
        dispatch encoded them.  A job on the
        finalize pool (_submit)."""
        _check_pair_sizes(len(reads1), len(reads2))
        with self.tracer.span("pack"):
            blobs = _pair_blobs(reads1, reads2, seqs)
            sl_pos = np.ascontiguousarray(sl_pos, dtype=np.uint32)
            sl_ds = np.ascontiguousarray(sl_ds, dtype=np.int32)
            sl_cnt = np.ascontiguousarray(sl_cnt, dtype=np.int32)
            if mate is not None:
                mate = np.ascontiguousarray(mate, dtype=np.int32)
        self._submit(
            self.lib.engine_pe_slots_submit,
            (*map(_ptr, blobs), len(reads1), int(a_rich_mode),
             int(random_pbat), _ptr(sl_pos), _ptr(sl_ds), _ptr(sl_cnt),
             sl_pos.shape[1], _ptr(mate),
             mate.shape[1] if mate is not None else 0),
            (blobs, sl_pos, sl_ds, sl_cnt, mate), 18, stats, out)

    # ---- device stage-2 finalize (pipeline.py build_stage12) ---------------
    def _finalize_se(self, reads, a_rich_mode, random_pbat, records, stats,
                     out, seqs, cig_ops=None, cig_meta=None):
        """records: (n_reads, 4) int32 per-read device decisions; the
        native side does traceback-for-winners + SAM + stats, or a full
        exact re-map for REC_FALLBACK rows.  cig_ops/cig_meta (optional):
        device-traceback output (kernels.banded_align, K3) -- aligned rows
        with meta n_ops >= 0 skip the host aligner entirely.  seqs: the
        reads' seq_blob, as the dispatch encoded it.  A job on the
        finalize pool (_submit)."""
        with self.tracer.span("pack"):
            blobs = seqs + _name_blob(reads)
            records = np.ascontiguousarray(records, dtype=np.int32)
            tb_nops = 0
            if cig_ops is not None:
                cig_ops = np.ascontiguousarray(cig_ops, dtype=np.int32)
                cig_meta = np.ascontiguousarray(cig_meta, dtype=np.int32)
                tb_nops = cig_ops.shape[1]
        self._submit(
            self.lib.engine_se_finalize_submit,
            (*map(_ptr, blobs), len(reads), int(a_rich_mode),
             int(random_pbat), _ptr(records), _ptr(cig_ops), _ptr(cig_meta),
             tb_nops),
            (blobs, records, cig_ops, cig_meta), 6, stats, out)

    # ---- the finalize pool -------------------------------------------------
    def _submit(self, submit, args, refs, n_raw, stats, out):
        """Hands a batch to the library's finalize pool (submit: its
        submit entry, args: what follows the context, n_threads added)
        and returns; refs, the arrays the library reads, live on the job
        until _write_jobs releases it.  Counts the job (pool_jobs) and the
        items the card handed back, which the pool claims first
        (pool_first)."""
        tr = self.tracer
        with tr.span("native"):
            job = submit(self._ctx, *args, self.n_threads)
        self._jobs.append((job, n_raw, stats, out, refs))
        tr.count("pool_jobs")
        tr.count("pool_first", self.lib.engine_job_first(self._ctx, job))

    def _write_jobs(self, keep: int) -> None:
        """Writes the pool's finished jobs, oldest first, each to the out
        and stats it came with, and stops at the first unfinished job once
        at most keep are left; above keep it waits for that job
        (finish/native_wait), and a call that waited counts once
        (pool_waits).  keep 0 writes every job."""
        lib, ctx, tr = self.lib, self._ctx, self.tracer
        waited = False
        while self._jobs:
            job, n_raw, stats, out, _refs = self._jobs[0]
            if not lib.engine_job_done(ctx, job):
                if len(self._jobs) <= keep:
                    break
                waited = True
                with tr.span("native_wait"):
                    lib.engine_job_wait(ctx, job, None)
            st = np.zeros(n_raw, dtype=np.int64)
            n = lib.engine_job_wait(ctx, job, _ptr(st))
            with tr.span("write"):
                out.write(ctypes.string_at(lib.engine_job_out_ptr(ctx, job),
                                           n).decode())
            self._jobs.popleft()
            lib.engine_job_release(ctx, job)
            _add_stats(stats, st)
        if waited:
            tr.count("pool_waits")

    def drop_jobs(self) -> None:
        """Waits for the pool's jobs and releases them unwritten: what a
        map that raised leaves behind never reaches a later map."""
        while self._jobs:
            job = self._jobs.popleft()[0]
            self.lib.engine_job_wait(self._ctx, job, None)
            self.lib.engine_job_release(self._ctx, job)

    # ---- two-phase SE interface for device-side batched alignment ---------
    def _phase1_se(self, reads, a_rich_mode, random_pbat, events):
        """Seeds the batch and emits alignment jobs; returns (n_jobs, jobs)
        where jobs is int32 (n_jobs, 5): read, enc_sel, pos, bw, qsz.  The
        input blobs are pinned on self until _phase2_se runs."""
        rblob, roffs = seq_blob(reads)
        nblob, noffs = _name_blob(reads)
        self._phase_refs = (rblob, roffs, nblob, noffs, events)
        with self.tracer.span("native"):
            n_jobs = self.lib.engine_se_phase1(
                self._ctx, _ptr(rblob), _ptr(roffs), _ptr(nblob),
                _ptr(noffs), len(reads), int(a_rich_mode), int(random_pbat),
                *self._event_args(events), self.n_threads)
        jobs = np.zeros((0, 5), dtype=np.int32)
        if n_jobs:
            ptr = self.lib.engine_jobs_ptr(self._ctx)
            jobs = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)),
                shape=(int(n_jobs), 5)).copy()
        return int(n_jobs), jobs

    def _phase2_se(self, scores, stats, out):
        st = np.zeros(6, dtype=np.int64)
        scores = np.ascontiguousarray(scores, dtype=np.int32)
        with self.tracer.span("native"):
            n = self.lib.engine_se_phase2(self._ctx, _ptr(scores),
                                          self.n_threads, _ptr(st))
        self._emit(n, out)
        _add_stats(stats, st)
        self._phase_refs = None

    # ---- two-phase PE interface for device-side batched alignment ---------
    def _phase1_pe(self, reads1, reads2, a_rich_mode, random_pbat, events):
        """Seeds every fragment configuration of the batch and emits
        alignment jobs (read, unit_offset, pos, bw, qsz); pins the input
        blobs on self until _phase2_pe runs."""
        _check_pair_sizes(len(reads1), len(reads2))
        r1b, r1o, n1b, n1o, r2b, r2o, n2b, n2o = _pair_blobs(reads1, reads2)
        self._phase_refs = (r1b, r1o, n1b, n1o, r2b, r2o, n2b, n2o, events)
        with self.tracer.span("native"):
            n_jobs = self.lib.engine_pe_phase1(
                self._ctx, _ptr(r1b), _ptr(r1o), _ptr(n1b), _ptr(n1o),
                _ptr(r2b), _ptr(r2o), _ptr(n2b), _ptr(n2o),
                len(reads1), int(a_rich_mode), int(random_pbat),
                *self._event_args(events), self.n_threads)
        jobs = np.zeros((0, 5), dtype=np.int32)
        if n_jobs:
            ptr = self.lib.engine_pe_jobs_ptr(self._ctx)
            jobs = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)),
                shape=(int(n_jobs), 5)).copy()
        return int(n_jobs), jobs

    def _phase2_pe(self, scores, stats, out):
        st = np.zeros(18, dtype=np.int64)
        scores = np.ascontiguousarray(scores, dtype=np.int32)
        with self.tracer.span("native"):
            n = self.lib.engine_pe_phase2(self._ctx, _ptr(scores),
                                          self.n_threads, _ptr(st))
        self._emit(n, out)
        _add_stats(stats, st)
        self._phase_refs = None

    # ---- fully-native streaming loop (engine_run_se/pe) --------------------
    # FASTQ parse, mapping threads, and ordered SAM writing all run inside
    # the native library; no Python executes per read.  Only usable for
    # SAM-text output (BAM goes through the Python BGZF writer).
    supports_streaming = True

    def run_range(self, reads_file1, reads_file2, out_path, hdr: bytes,
                  a_rich_mode, random_pbat, skip_reads=0, max_reads=-1,
                  bam=False, verbose=False, batch_size=1000) -> np.ndarray:
        """The library's streaming loop (engine_run_se / engine_run_pe) over
        reads [skip_reads, skip_reads + max_reads) of the FASTQ(s)
        (max_reads < 0: to the end) into out_path, hdr (the SAM header,
        or BAM header payload, as bytes; may be empty) written first.
        Returns the raw stats counters (6 SE, 18 PE); raises on the
        library's error."""
        if reads_file2 is None:
            raw = np.zeros(6, dtype=np.int64)
            n = self.lib.engine_run_se(
                self._ctx, reads_file1.encode(), out_path.encode(), hdr,
                len(hdr), int(a_rich_mode), int(random_pbat),
                int(batch_size), self.n_threads, _ptr(raw), int(verbose),
                int(skip_reads), int(max_reads), int(bam))
        else:
            raw = np.zeros(18, dtype=np.int64)
            n = self.lib.engine_run_pe(
                self._ctx, reads_file1.encode(), reads_file2.encode(),
                out_path.encode(), hdr, len(hdr), int(a_rich_mode),
                int(random_pbat), int(batch_size), self.n_threads, _ptr(raw),
                int(verbose), int(skip_reads), int(max_reads), int(bam))
        if n < 0:
            raise RuntimeError(self.lib.engine_error_ptr(self._ctx).decode())
        return raw

    def run_streaming(self, reads_file1, reads_file2, out_path, header: str,
                      a_rich_mode, random_pbat, stats, batch_size=1000,
                      verbose=False, skip_reads=0, max_reads=-1, bam=False):
        if bam:
            # native BAM: pass the uncompressed BAM header payload; the
            # library BGZF-compresses it and emits binary records
            from ..io.bam import bam_header_payload

            hdr = bam_header_payload(header)
        else:
            hdr = header.encode()
        st = self.run_range(reads_file1, reads_file2, out_path, hdr,
                            a_rich_mode, random_pbat, skip_reads, max_reads,
                            bam, verbose, batch_size)
        blocks = ((stats,) if reads_file2 is None else
                  (stats.read_pair_stats, stats.end1_stats, stats.end2_stats))
        for blk, dst in enumerate(blocks):
            for i, f in enumerate(_SE_FIELDS):
                setattr(dst, f, getattr(dst, f) + int(st[6 * blk + i]))

    # ---- pipelined interface (dispatch/finish; no-op split here) -----------
    def dispatch_se(self, reads, a_rich_mode, random_pbat):
        return (reads, a_rich_mode, random_pbat, None)

    def finish_se(self, handle, stats, out):
        reads, arm, rp, events = handle
        self._call_se(reads, arm, rp, stats, out, events)
        return len(reads)

    def dispatch_pe(self, reads1, reads2, a_rich_mode, random_pbat):
        return (reads1, reads2, a_rich_mode, random_pbat, None)

    def finish_pe(self, handle, stats, out):
        reads1, reads2, arm, rp, events = handle
        self._call_pe(reads1, reads2, arm, rp, stats, out, events)
        return len(reads1)

    # ---- MappingEngine-compatible entry points -----------------------------
    def map_se_reads(self, reads, a_rich_mode, random_pbat, stats, out):
        self._call_se(reads, a_rich_mode, random_pbat, stats, out, None)

    def map_pe_reads(self, reads1, reads2, a_rich_mode, random_pbat, stats,
                     out):
        self._call_pe(reads1, reads2, a_rich_mode, random_pbat, stats, out,
                      None)


@contextlib.contextmanager
def _jobs_dropped_on_error(engine):
    """A map that raises drops the jobs it left on the engine's finalize
    pool (drop_jobs), so that none is written into a later map."""
    try:
        yield
    except BaseException:
        drop = getattr(engine, "drop_jobs", None)
        if drop is not None:
            drop()
        raise


def run_map_pipelined(engine, index, reads_file1, reads_file2, out_path,
                      command_line, a_rich=False, pbat=False,
                      random_pbat=False, bam=False, verbose=False,
                      skip=0, count=None, write_header=True):
    """Batch loop for engines with the dispatch/finish interface: batch k+1's
    device work (if any) is dispatched before batch k is finished, so the
    accelerator overlaps the native decide/align/format stage.

    skip/count restrict the run to the read-range shard [skip, skip+count)
    and write_header=False omits the SAM header (hybrid-split / multi-host
    shard output; the gather step concatenates shards in rank order).

    The engine's tracer (tracing.Tracer) times the loop (map) and each
    batch's FASTQ reading (read), and counts reads and batches; verbose
    turns it on for this map and prints its table (trace_table).  Reads
    longer than the engine's lmax (its n_oversized) are named in one line
    on standard error at the end, verbose or not."""
    import sys
    import time as _time

    from ..io.sam import open_sam_output

    from collections import deque

    paired = reads_file2 is not None

    # fully-native loop: for SAM-text output from the pure-native engine,
    # the whole read->map->write stream runs inside the C++ library
    if getattr(engine, "supports_streaming", False):
        assert skip == 0 and count is None and write_header, \
            "shard-range options require a dispatch/finish engine"
        import sys as _sys
        import time as _t

        if verbose:
            engine.lib.engine_set_profile(engine._ctx, 1)
        start = _t.monotonic()
        stats = PEStats() if paired else SEStats()
        a_rich_mode = (pbat if paired else (a_rich or pbat))
        engine.run_streaming(
            reads_file1, reads_file2, out_path,
            make_sam_header(index.cl, command_line), a_rich_mode,
            random_pbat, stats, verbose=verbose, bam=bam)
        if verbose:
            total = _t.monotonic() - start
            ns = np.zeros(16, dtype=np.int64)
            engine.lib.engine_stage_ns(engine._ctx, _ptr(ns), 1)
            cpu = max(1, int(ns[:4].sum()))
            for name, v in zip(("seed", "align", "format", "parse"), ns[:4]):
                print(f"[stage {name}: {v / 1e9:.2f}s cpu "
                      f"({100 * int(v) // cpu}%)]", file=_sys.stderr)
            print(f"[total mapping time: {total:.2f}s]", file=_sys.stderr)
        return stats

    depth = max(1, getattr(engine, "pipeline_depth", 1))
    # a device engine's preferred_read_batch fills one chunk of unit_batch
    # units (unit_batch // units a read, at least 250 reads), so a batch is
    # one replay of its device program; other engines read 1000
    prb = getattr(engine, "preferred_read_batch", None)
    batch_size = prb(paired, random_pbat) if prb else 1000
    tr = engine.tracer
    was_on = tr.on
    long0 = getattr(engine, "n_oversized", 0)
    if verbose:  # -v: this map's spans and counters
        tr.reset()
        tr.on = True
    start_time = _time.monotonic()
    n_processed = 0
    bar = None
    if verbose:
        from ..utils.progress import file_progress

        bar = file_progress(reads_file1)
    with tr.span("map"), _jobs_dropped_on_error(engine), open_sam_output(
            out_path, bam, bam_emit_header=write_header) as out:
        if write_header or bam:
            # BAM sinks always consume the header text: with write_header
            # False it only builds the tid dictionary, emitting nothing
            out.write(make_sam_header(index.cl, command_line))
        if not paired:
            stats = SEStats()
            a_rich_mode = a_rich or pbat
            rl = ReadLoader(reads_file1, batch_size, skip=skip, count=count)
            q = deque()
            while rl:
                with tr.span("read"):
                    batch = rl.load_batch()
                if batch:
                    tr.count("reads", len(batch))
                    tr.count("batches")
                    q.append(engine.dispatch_se(batch, a_rich_mode,
                                                random_pbat))
                while len(q) > (depth if rl else 0):
                    n_processed += engine.finish_se(q.popleft(), stats, out)
                    if bar is not None:
                        b = rl.current_byte
                        if bar.time_to_report(b):
                            bar.report(sys.stderr, b)
                    elif verbose:
                        print(f"[mapped {n_processed} reads]",
                              file=sys.stderr)
            while q:
                n_processed += engine.finish_se(q.popleft(), stats, out)
            tr.count("read_bytes", rl.bytes_parsed)
        else:
            stats = PEStats()
            rl1 = ReadLoader(reads_file1, batch_size, skip=skip, count=count)
            rl2 = ReadLoader(reads_file2, batch_size, skip=skip, count=count)
            q = deque()
            while rl1 and rl2:
                with tr.span("read"):
                    b1 = rl1.load_batch()
                    b2 = rl2.load_batch()
                if b1 or b2:
                    tr.count("reads", len(b1) + len(b2))
                    tr.count("batches")
                    # PE ignores -A; conversion mode is pbat only
                    q.append(engine.dispatch_pe(b1, b2, pbat, random_pbat))
                while len(q) > (depth if (rl1 and rl2) else 0):
                    n_processed += engine.finish_pe(q.popleft(), stats, out)
                    if bar is not None:
                        b = rl1.current_byte
                        if bar.time_to_report(b):
                            bar.report(sys.stderr, b)
                    elif verbose:
                        print(f"[mapped {n_processed} read pairs]",
                              file=sys.stderr)
            while q:
                n_processed += engine.finish_pe(q.popleft(), stats, out)
            tr.count("read_bytes", rl1.bytes_parsed + rl2.bytes_parsed)

    if bar is not None and bar.prev < 100:
        bar.report(sys.stderr, bar.total)
    if verbose:
        tr.on = was_on
        fb = getattr(engine, "n_fallback", None)
        if fb is not None:
            print(f"[device stage-1 fallback units: {fb}/"
                  f"{getattr(engine, 'n_units', 0)}]", file=sys.stderr)
        units = units_per(paired, random_pbat) * n_processed
        for line in trace_table(tr.summary(), units):
            print(line, file=sys.stderr)
        print(f"[total mapping time: "
              f"{_time.monotonic() - start_time:.2f}s]", file=sys.stderr)
    n_long = getattr(engine, "n_oversized", 0) - long0
    if n_long:
        print(f"{n_long} reads longer than --lmax {engine.lmax} were mapped "
              f"on the host; set --lmax to at least the longest read to "
              f"keep them on the card", file=sys.stderr)
    return stats


def trace_table(summary: dict, units: int = 0) -> list[str]:
    """The -v lines of a tracer summary: each span's calls, total and self
    seconds and its share of the map's total, then the counters, the
    finalize pool's engagement (1 - pool_waits / pool_jobs) where it ran
    jobs, and the native unit encoder's (the rows it wrote with bases,
    encoded_units, over the map's units, per a read or pair) where it
    ran, with the conversions: the A-rich share of those rows
    (a_rich_units) and, where the fused single-end route counted winners,
    theirs (cv_a_winners over cv_a_winners + cv_t_winners)."""
    spans = summary["spans"]
    whole = max((t for p, (_, t, _s) in spans.items() if "/" not in p),
                default=0.0) or 1.0
    lines = [f"[{'span':32s} {'calls':>7s} {'total s':>9s} {'self s':>9s} "
             f"{'of map':>7s}]"]
    for path in sorted(spans):
        calls, total, self_s = spans[path]
        lines.append(f"[{path:32s} {calls:7d} {total:9.3f} {self_s:9.3f} "
                     f"{100 * total / whole:6.1f}%]")
    c = summary["counters"]
    lines.append("[counters: " + ", ".join(
        f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in c.items()) + "]")
    if c.get("pool_jobs"):
        lines.append(f"[finalize pool: {c['pool_jobs']} jobs, "
                     f"{c['pool_waits']} finish calls waited, engagement "
                     f"{1 - c['pool_waits'] / c['pool_jobs']:.3f}, "
                     f"{c['pool_first']} items first]")
    if units and c.get("encoded_units"):
        lines.append(f"[unit encoder: {c['encoded_units']} of {units} unit "
                     f"rows, engagement {c['encoded_units'] / units:.3f}]")
    if c.get("encoded_units"):
        line = (f"[conversions: {c['a_rich_units']} of {c['encoded_units']} "
                f"unit rows A-rich "
                f"({c['a_rich_units'] / c['encoded_units']:.3f})")
        cv_a, cv_t = c["cv_a_winners"], c["cv_t_winners"]
        if cv_a + cv_t:
            line += (f"; winners CV:A {cv_a}, CV:T {cv_t} "
                     f"(CV:A {cv_a / (cv_a + cv_t):.3f})")
        lines.append(line + "]")
    return lines
