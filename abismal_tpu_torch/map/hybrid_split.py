"""Hybrid-split mapping: host cores and the accelerator map disjoint
read-range shards of one input CONCURRENTLY, and the shard outputs are
gathered in rank order -- so total throughput is the SUM of the native
engine's and the device engine's rates, with output byte-identical to a
single-engine run (reference `map` semantics, abismal.cpp:2295-2504).

The native C++ streaming engine maps reads [0, k) on the host thread pool
(the ctypes call releases the GIL), while this thread drives the
device-resident stage-1+2 pipeline over reads [k, n).  The split point is
chosen from the two engines' calibrated rates (device_share), so both
finish together: every card AND every spare host core contributes.
(↔ abismal_tpu/map/hybrid_split.py, with TorchNativeEngine as the device
engine.)
"""

from __future__ import annotations

import os
import threading


def _shard_server_main(conn, index_path, allow_ambig, valid_frac,
                       pe_min_dist, pe_max_dist, threads):
    """Worker process: load an index replica once, then serve map-range
    requests until the pipe closes."""
    from ..index.serialize import read_index
    from .native_engine import NativeMappingEngine

    index = read_index(index_path)
    eng = NativeMappingEngine(index, allow_ambig, valid_frac, pe_min_dist,
                              pe_max_dist, n_threads=threads)
    conn.send("ready")
    while True:
        req = conn.recv()
        if req is None:
            return
        (fq1, fq2, out, hdr, a_rich_mode, rpbat, skip, count, bam,
         verbose) = req
        try:
            raw = eng.run_range(fq1, fq2 or None, out, hdr, a_rich_mode,
                                rpbat, skip, count, bam, verbose)
            conn.send((0, raw.tolist(), None))
        except Exception as e:  # relayed to the parent, which raises
            conn.send((-1, [], str(e)))


class NativeShardServer:
    """Persistent native-engine worker in its OWN process: the host-core
    shard of a hybrid split runs free of the device runtime's threads and
    memory footprint.  The worker loads its index replica from disk once
    and serves any number of map-range requests -- the same worker shape
    as a multi-host rank."""

    def __init__(self, index_path: str, allow_ambig=False, valid_frac=0.1,
                 pe_min_dist=32, pe_max_dist=3000, threads: int = 1):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(
            target=_shard_server_main,
            args=(child, index_path, allow_ambig, valid_frac, pe_min_dist,
                  pe_max_dist, threads),
            daemon=True)
        self._proc.start()
        child.close()
        assert self._conn.recv() == "ready"

    def map_range(self, fq1, fq2, out, hdr: bytes, a_rich_mode, rpbat,
                  skip, count, bam, verbose):
        self._conn.send((fq1, fq2, out, hdr, a_rich_mode, rpbat, skip,
                         count, bam, verbose))

    def wait(self):
        n, raw, err = self._conn.recv()
        if n < 0:
            raise RuntimeError(err or "native shard worker failed")
        return raw

    def close(self):
        try:
            self._conn.send(None)
        except (BrokenPipeError, OSError):
            pass
        self._proc.join(timeout=10)


def run_map_hybrid_split(index, reads_file1: str, reads_file2,
                         out_path: str, command_line: str,
                         device_share: float | None = None,
                         threads: int | None = None,
                         a_rich=False, pbat=False, random_pbat=False,
                         allow_ambig=False, valid_frac=0.1,
                         pe_min_dist=32, pe_max_dist=3000, lmax: int = 128,
                         bam: bool = False, verbose: bool = False,
                         native_engine=None, tpu_engine=None,
                         native_server=None, stats_out=None,
                         total_reads: int | None = None):
    """Maps reads_file1 (and reads_file2 for PE) with the native engine on
    [0, k) and the device engine (tpu_engine, by default a
    TorchNativeEngine on cuda; the keyword keeps the JAX package's name)
    on [k, n) concurrently; k is set so the native share is
    (1 - device_share).  Returns merged stats; output at out_path is
    byte-identical to a single-engine run."""
    from ..io.bam import bam_header_payload
    from ..io.sam import make_sam_header
    from ..parallel.multihost import _apply_stats, count_reads, gather
    from .native_engine import NativeMappingEngine, run_map_pipelined
    from .pipeline import TorchNativeEngine

    paired = reads_file2 is not None
    total = total_reads if total_reads is not None else \
        count_reads(reads_file1)
    if device_share is None:
        device_share = float(os.environ.get("ABISMAL_DEVICE_SHARE", "0.15"))
    n_dev = min(total, max(0, int(total * device_share)))
    k = total - n_dev  # native maps [0, k); device maps [k, total)
    threads = threads or (os.cpu_count() or 1)

    dev = tpu_engine or TorchNativeEngine(
        index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist,
        lmax=lmax, n_threads=1)

    header = make_sam_header(index.cl, command_line)
    hdr = bam_header_payload(header) if bam else header.encode()
    shard0 = out_path + ".hsplit0"
    shard1 = out_path + ".hsplit1"
    a_rich_mode = (pbat if paired else (a_rich or pbat))

    if native_server is not None:
        # host shard in its own pristine worker process (the deployment
        # shape: one native rank per host + one process feeding the device)
        native_server.map_range(reads_file1, reads_file2, shard0, hdr,
                                a_rich_mode, random_pbat, 0, k, bam,
                                verbose)
        stats = run_map_pipelined(
            dev, index, reads_file1, reads_file2, shard1, command_line,
            a_rich=a_rich, pbat=pbat, random_pbat=random_pbat, bam=bam,
            verbose=False, skip=k, count=n_dev, write_header=False)
        raw_list = native_server.wait()
        _apply_stats(raw_list, paired, stats)
        gather([shard0, shard1], out_path)
        os.unlink(shard0)
        os.unlink(shard1)
        if stats_out is not None:
            stats_out.update(n_native=k, n_device=n_dev)
        return stats

    nat = native_engine or NativeMappingEngine(
        index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist,
        n_threads=threads)
    raw, errors = [], []

    def native_work():
        try:
            raw.extend(nat.run_range(reads_file1, reads_file2, shard0, hdr,
                                     a_rich_mode, random_pbat, 0, k, bam,
                                     verbose).tolist())
        except Exception as e:  # surfaced after join
            errors.append(e)

    t = threading.Thread(target=native_work, name="native-shard")
    t.start()
    try:
        stats = run_map_pipelined(
            dev, index, reads_file1, reads_file2, shard1, command_line,
            a_rich=a_rich, pbat=pbat, random_pbat=random_pbat, bam=bam,
            verbose=False, skip=k, count=n_dev, write_header=False)
    finally:
        t.join()
    if errors:
        raise errors[0]
    _apply_stats(raw, paired, stats)
    gather([shard0, shard1], out_path)
    os.unlink(shard0)
    os.unlink(shard1)
    if stats_out is not None:
        stats_out.update(n_native=k, n_device=n_dev)
    return stats
