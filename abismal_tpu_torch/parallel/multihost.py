"""Multi-host mapping (↔ abismal_tpu/parallel/multihost.py): the FASTQ
splits into contiguous read-range shards, one process per shard loads
its own index replica and maps its range, with TorchNativeEngine on a
card (engine "torch") or with the native C++ engine on the host cores
(engine "native"), and the shard SAMs are concatenated in rank order, so
the output equals a one-process run byte for byte.

The same code runs on separate machines: `map --shard I:N` on each host,
then concatenate the shard outputs in rank order."""

from __future__ import annotations

import os
import shutil

from ..io.genome import open_maybe_gzip

_SE_FIELDS = ("total_reads", "reads_mapped_unique", "reads_mapped_ambiguous",
              "reads_skipped", "edit_distance", "total_bases")


def count_reads(fastq_path: str) -> int:
    """Number of FASTQ records (lines / 4), gz-aware.  A final line with
    no trailing newline still counts (the native parser accepts it)."""
    n = 0
    last = b"\n"
    with open_maybe_gzip(fastq_path) as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            n += chunk.count(b"\n")
            last = chunk[-1:]
    if last != b"\n":
        n += 1
    return n // 4


def shard_bounds(total_reads: int, n_shards: int):
    """[(skip, count)] per shard; counts differ by at most one."""
    bounds = [(i * total_reads) // n_shards for i in range(n_shards + 1)]
    return [(bounds[i], bounds[i + 1] - bounds[i]) for i in range(n_shards)]


def gather(shard_paths, out_path: str):
    """Concatenates shard SAM files in rank order."""
    with open(out_path, "wb") as out:
        for p in shard_paths:
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out, 1 << 22)


def _apply_stats(raw, paired, stats):
    """Adds a shard's raw counters (6 ints SE, 18 PE) into stats."""
    if not paired:
        for i, f in enumerate(_SE_FIELDS):
            setattr(stats, f, getattr(stats, f) + int(raw[i]))
    else:
        for blk, dst in enumerate((stats.read_pair_stats, stats.end1_stats,
                                   stats.end2_stats)):
            for i, f in enumerate(_SE_FIELDS):
                setattr(dst, f, getattr(dst, f) + int(raw[6 * blk + i]))


def map_shard(index_path: str, reads_file1: str, reads_file2,
              out_shard: str, shard_i: int, n_shards: int,
              command_line: str, skip: int, count: int, a_rich=False,
              pbat=False, random_pbat=False, allow_ambig=False,
              valid_frac=0.1, pe_min_dist=32, pe_max_dist=3000,
              threads: int = 1, bam: bool = False, verbose: bool = False,
              lmax: int = 128, device=None, engine: str = "torch"):
    """One host's work: load the index, map reads [skip, skip + count) and
    write the records (shard 0 also writes the header).  Returns the
    shard's raw stats counters (6 ints SE, 18 PE).

    engine="torch" (↔ the JAX map_shard's device branch) maps with
    TorchNativeEngine on device, by default cuda:{shard_i %
    device_count}; without a card a CUDA device raises and nothing falls
    back to the CPU.  engine="native" (↔ its native branch) maps with the
    native C++ engine's streaming loop on the host cores and touches no
    device; lmax and device do not apply to it.

    BAM shards are each a complete BGZF stream (shard 0 also starts with
    the compressed header): the shards concatenated in rank order are a
    BAM whose decompressed payload equals a one-process run's."""
    from ..index.serialize import read_index

    if engine == "native":
        return _map_shard_native(
            read_index(index_path), reads_file1, reads_file2, out_shard,
            shard_i, command_line, skip, count, a_rich, pbat, random_pbat,
            allow_ambig, valid_frac, pe_min_dist, pe_max_dist, threads, bam,
            verbose)
    if engine != "torch":
        raise ValueError(f"engine must be torch or native, not {engine!r}")

    import torch

    from ..device import require_cuda
    from ..map.native_engine import run_map_pipelined
    from ..map.pipeline import TorchNativeEngine
    from ..map.stats import PEStats

    if device is None:
        require_cuda()
        device = f"cuda:{shard_i % torch.cuda.device_count()}"
    index = read_index(index_path)
    eng = TorchNativeEngine(index, allow_ambig, valid_frac, pe_min_dist,
                            pe_max_dist, lmax=lmax, n_threads=threads,
                            device=device)
    stats = run_map_pipelined(
        eng, index, reads_file1, reads_file2, out_shard, command_line,
        a_rich=a_rich, pbat=pbat, random_pbat=random_pbat, bam=bam,
        verbose=verbose, skip=skip, count=count,
        write_header=(shard_i == 0))
    if isinstance(stats, PEStats):
        return [int(getattr(blk, f)) for blk in
                (stats.read_pair_stats, stats.end1_stats, stats.end2_stats)
                for f in _SE_FIELDS]
    return [int(getattr(stats, f)) for f in _SE_FIELDS]


def _map_shard_native(index, reads_file1, reads_file2, out_shard, shard_i,
                      command_line, skip, count, a_rich, pbat, random_pbat,
                      allow_ambig, valid_frac, pe_min_dist, pe_max_dist,
                      threads, bam, verbose):
    """map_shard's native branch: the native engine's streaming loop over
    [skip, skip + count), its raw counters returned."""
    from ..io.bam import bam_header_payload
    from ..io.sam import make_sam_header
    from ..map.native_engine import NativeMappingEngine

    eng = NativeMappingEngine(index, allow_ambig, valid_frac, pe_min_dist,
                              pe_max_dist, n_threads=threads)
    header = (make_sam_header(index.cl, command_line) if shard_i == 0
              else "")
    hdr = (bam_header_payload(header) if bam and shard_i == 0
           else header.encode())
    paired = reads_file2 is not None
    a_rich_mode = pbat if paired else (a_rich or pbat)
    return eng.run_range(reads_file1, reads_file2, out_shard, hdr,
                         a_rich_mode, random_pbat, skip, count, bam,
                         verbose).tolist()


def run_map_multihost(index_path: str, reads_file1: str, reads_file2,
                      out_path: str, command_line: str, n_hosts: int,
                      threads_per_host: int = 1, device=None,
                      engine: str = "torch", **map_kwargs):
    """Coordinator (↔ the JAX run_map_multihost): shards the reads by
    count, maps each shard in its own spawned process with map_shard
    (engine "torch": on device, by default shard i on cuda:{i %
    device_count}; engine "native": on the host cores), gathers the shard
    SAMs in rank order and returns the merged stats.  For CUDA the kernel
    library is built here once, before the processes start."""
    import multiprocessing as mp

    from ..map.stats import PEStats, SEStats

    if engine == "torch":
        import torch

        from ..device import require_cuda
        from ..kernels import _build

        if device is None or torch.device(device).type == "cuda":
            require_cuda()
            _build.load()
    elif engine != "native":
        raise ValueError(f"engine must be torch or native, not {engine!r}")
    paired = reads_file2 is not None
    shards = shard_bounds(count_reads(reads_file1), n_hosts)
    shard_paths = [f"{out_path}.shard{i}" for i in range(n_hosts)]
    verbose = bool(map_kwargs.pop("verbose", False))
    ctx = mp.get_context("spawn")
    with ctx.Pool(n_hosts) as pool:
        results = [
            pool.apply_async(
                map_shard,
                (index_path, reads_file1, reads_file2, shard_paths[i], i,
                 n_hosts, command_line, skip, cnt),
                # progress from rank 0 only: the shards' stderr interleaves
                dict(threads=threads_per_host, verbose=(verbose and i == 0),
                     device=device, engine=engine, **map_kwargs))
            for i, (skip, cnt) in enumerate(shards)
        ]
        raws = [r.get() for r in results]
    stats = PEStats() if paired else SEStats()
    for raw in raws:
        _apply_stats(raw, paired, stats)
    gather(shard_paths, out_path)
    for p in shard_paths:
        os.unlink(p)
    return stats
