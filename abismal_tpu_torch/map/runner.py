"""Parallel host mapping runners (↔ abismal_tpu/map/runner.py).

The reference scales with `-t` worker threads pulling read batches from a
shared stream, which makes its output order nondeterministic for t > 1
(abismal.cpp:2187-2263).  Here worker processes map whole batches and the
parent writes results in global batch order, so output is byte-identical
to the single-worker run at any worker count.  Statistics are plain
counters and merge exactly.

The workers are forked, so the index is shared copy-on-write instead of
pickled into each.  In run_map_hybrid the parent holds a CUDA context when
it forks: the workers' engine (EventReplayEngine) and their initializer
touch nothing of torch.cuda, and the event caches they get are NumPy
arrays.
"""

from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from io import StringIO

from ..io.fastq import ReadLoader
from ..io.sam import make_sam_header, open_sam_output
from .engine import MappingEngine
from .stats import PEStats, SEStats

_WORKER_ENGINE = None


def _init_worker(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
    global _WORKER_ENGINE
    _WORKER_ENGINE = MappingEngine(index, allow_ambig, valid_frac,
                                   pe_min_dist, pe_max_dist)


def _map_se_batch(args):
    batch, a_rich_mode, random_pbat = args
    out = StringIO()
    stats = SEStats()
    _WORKER_ENGINE.map_se_reads(batch, a_rich_mode, random_pbat, stats, out)
    return out.getvalue(), stats.__dict__


def _map_pe_batch(args):
    b1, b2, a_rich_mode, random_pbat = args
    out = StringIO()
    stats = PEStats()
    _WORKER_ENGINE.map_pe_reads(b1, b2, a_rich_mode, random_pbat, stats, out)
    return out.getvalue(), {
        "read_pair_stats": stats.read_pair_stats.__dict__,
        "end1_stats": stats.end1_stats.__dict__,
        "end2_stats": stats.end2_stats.__dict__,
    }


def _merge_counters(dst, src_dict):
    for k, v in src_dict.items():
        setattr(dst, k, getattr(dst, k) + v)


def run_map_parallel(index, reads_file1, reads_file2, out_path, command_line,
                     n_workers, a_rich=False, pbat=False, random_pbat=False,
                     allow_ambig=False, valid_frac=0.1, pe_min_dist=32,
                     pe_max_dist=3000, window=4, bam=False):
    """Maps with n_workers processes; returns the stats object.  Output is
    identical to the sequential engine's."""
    paired = reads_file2 is not None
    a_rich_mode = a_rich or pbat

    ctx = mp.get_context("fork")
    pool = ProcessPoolExecutor(
        max_workers=n_workers, mp_context=ctx,
        initializer=_init_worker,
        initargs=(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist),
    )
    stats = PEStats() if paired else SEStats()
    try:
        with open_sam_output(out_path, bam) as out:
            out.write(make_sam_header(index.cl, command_line))
            futures = []
            max_outstanding = window * n_workers

            def drain(limit):
                while len(futures) > limit:
                    text, st = futures.pop(0).result()
                    out.write(text)
                    if paired:
                        _merge_counters(stats.read_pair_stats,
                                        st["read_pair_stats"])
                        _merge_counters(stats.end1_stats, st["end1_stats"])
                        _merge_counters(stats.end2_stats, st["end2_stats"])
                    else:
                        _merge_counters(stats, st)

            if not paired:
                rl = ReadLoader(reads_file1)
                while rl:
                    batch = rl.load_batch()
                    if batch:
                        futures.append(pool.submit(
                            _map_se_batch, (batch, a_rich_mode, random_pbat)))
                    drain(max_outstanding)
            else:
                rl1 = ReadLoader(reads_file1)
                rl2 = ReadLoader(reads_file2)
                while rl1 and rl2:
                    b1 = rl1.load_batch()
                    b2 = rl2.load_batch()
                    if len(b1) != len(b2):
                        raise RuntimeError(
                            f"paired-end batch sizes differ. Batch 1: "
                            f"{len(b1)}, batch 2: {len(b2)}. Are you sure "
                            "your paired-end inputs have the same number of "
                            "reads?")
                    if b1 or b2:
                        # PE ignores -A; conversion mode is pbat only
                        # (abismal.cpp:2477-2480), matching run_map and
                        # run_map_hybrid
                        futures.append(pool.submit(
                            _map_pe_batch,
                            (b1, b2, pbat, random_pbat)))
                    drain(max_outstanding)
            drain(0)
    finally:
        pool.shutdown()
    return stats


# --- hybrid device + multi-process runner -------------------------------

_HYBRID_ENGINE = None


def _init_hybrid_worker(index, allow_ambig, valid_frac, pe_min_dist,
                        pe_max_dist):
    global _HYBRID_ENGINE
    from .pipeline import EventReplayEngine

    _HYBRID_ENGINE = EventReplayEngine(index, allow_ambig, valid_frac,
                                       pe_min_dist, pe_max_dist)


def _hybrid_se_batch(args):
    batch, a_rich_mode, random_pbat, cache, o_spec = args
    out = StringIO()
    stats = SEStats()
    _HYBRID_ENGINE.set_cache(cache, o_spec)
    _HYBRID_ENGINE.map_se_reads(batch, a_rich_mode, random_pbat, stats, out)
    return out.getvalue(), stats.__dict__


def _hybrid_pe_batch(args):
    b1, b2, a_rich_mode, random_pbat, cache, o_spec = args
    out = StringIO()
    stats = PEStats()
    _HYBRID_ENGINE.set_cache(cache, o_spec)
    _HYBRID_ENGINE.map_pe_reads(b1, b2, a_rich_mode, random_pbat, stats, out)
    return out.getvalue(), {
        "read_pair_stats": stats.read_pair_stats.__dict__,
        "end1_stats": stats.end1_stats.__dict__,
        "end2_stats": stats.end2_stats.__dict__,
    }


def run_map_hybrid(index, reads_file1, reads_file2, out_path, command_line,
                   n_workers, a_rich=False, pbat=False, random_pbat=False,
                   allow_ambig=False, valid_frac=0.1, pe_min_dist=32,
                   pe_max_dist=3000, window=3, bam=False,
                   engine_factory=None):
    """Device stage-1 in this process (the replay engine engine_factory
    builds, by default TorchMappingEngine on cuda); sequential
    decide/align/format in forked workers; output written in global batch
    order (deterministic and byte-identical to the sequential engines)."""
    paired = reads_file2 is not None
    a_rich_mode = a_rich or pbat

    if engine_factory is None:
        from .pipeline import make_torch_engine_factory

        engine_factory = make_torch_engine_factory()
    dev_engine = engine_factory(index, allow_ambig, valid_frac,
                                pe_min_dist, pe_max_dist)

    ctx = mp.get_context("fork")
    pool = ProcessPoolExecutor(
        max_workers=n_workers, mp_context=ctx,
        initializer=_init_hybrid_worker,
        initargs=(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist),
    )
    stats = PEStats() if paired else SEStats()
    try:
        with open_sam_output(out_path, bam) as out:
            out.write(make_sam_header(index.cl, command_line))
            futures = []
            max_outstanding = window * n_workers

            def drain(limit):
                while len(futures) > limit:
                    text, st = futures.pop(0).result()
                    out.write(text)
                    if paired:
                        _merge_counters(stats.read_pair_stats,
                                        st["read_pair_stats"])
                        _merge_counters(stats.end1_stats, st["end1_stats"])
                        _merge_counters(stats.end2_stats, st["end2_stats"])
                    else:
                        _merge_counters(stats, st)

            # two-deep batch pipeline: batch k+1's device work is
            # dispatched before batch k's results are pulled, overlapping
            # accelerator execution with host collection and worker decode
            prev = None

            def flush_prev(submit_fn, args_fn):
                nonlocal prev
                if prev is not None:
                    payload, disp = prev
                    cache = dev_engine._collect_units(disp)
                    futures.append(pool.submit(submit_fn,
                                               args_fn(payload, cache)))
                    prev = None

            if not paired:
                rl = ReadLoader(reads_file1)

                def se_args(batch, cache):
                    return (batch, a_rich_mode, random_pbat, cache,
                            dev_engine.o_spec)

                while rl:
                    batch = rl.load_batch()
                    cur = None
                    if batch:
                        units = dev_engine._se_units(
                            batch, a_rich_mode, random_pbat)
                        cur = (batch, dev_engine._dispatch_units(units))
                    flush_prev(_hybrid_se_batch, se_args)
                    prev = cur
                    drain(max_outstanding)
                flush_prev(_hybrid_se_batch, se_args)
            else:
                rl1 = ReadLoader(reads_file1)
                rl2 = ReadLoader(reads_file2)

                def pe_args(payload, cache):
                    b1, b2 = payload
                    return (b1, b2, pbat, random_pbat, cache,
                            dev_engine.o_spec)

                while rl1 and rl2:
                    b1 = rl1.load_batch()
                    b2 = rl2.load_batch()
                    if len(b1) != len(b2):
                        raise RuntimeError(
                            f"paired-end batch sizes differ. Batch 1: "
                            f"{len(b1)}, batch 2: {len(b2)}. Are you sure "
                            "your paired-end inputs have the same number of "
                            "reads?")
                    cur = None
                    if b1 or b2:
                        # PE ignores -A; conversion mode is pbat only
                        units = dev_engine._pe_units(b1, b2, pbat,
                                                     random_pbat)
                        cur = ((b1, b2), dev_engine._dispatch_units(units))
                    flush_prev(_hybrid_pe_batch, pe_args)
                    prev = cur
                    drain(max_outstanding)
                flush_prev(_hybrid_pe_batch, pe_args)
            drain(0)
    finally:
        pool.shutdown()
    return stats
