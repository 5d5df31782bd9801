"""Command line of the port: `python -m abismal_tpu_torch map ...` maps
single-end reads, or read pairs given two FASTQs, with the PyTorch engine
on --device (default cuda), and scales out as abismal_tpu's CLI does:
--mesh splits each chunk over several devices, --index-shards splits the
index over them, --engine hybrid maps a share of the reads on the host
cores at the same time, and --hosts / --shard map read ranges in separate
processes or on separate machines.  ABISMAL_TPU_STAGE2=0 takes the
event-stream route (the device seeds, the native engine decides), and
--device-align then scores its alignments on the device.  --engine
native and exact map on the host alone (the C++ engine, the Python
reference engine), torch-replay replays the device's events in the
Python engine.  `idx` and `sim` are host-only.  Options accept single- or
double-dash long names and the reference's short names, and the SAM @PG
CL: header records argv exactly as the reference does (the subcommand
plus its arguments)."""

from __future__ import annotations

import argparse
import sys
import time


class _DashArgumentParser(argparse.ArgumentParser):
    """Accepts reference-style single-dash long options (-seed, -single)."""

    def _get_option_tuples(self, option_string):
        if option_string.startswith("-") and not option_string.startswith("--"):
            alt = "--" + option_string[1:]
            if alt in self._option_string_actions:
                action = self._option_string_actions[alt]
                return [(action, alt, None, None)]
        return super()._get_option_tuples(option_string)

    def parse_known_args(self, args=None, namespace=None):
        if args is None:
            args = sys.argv[1:]
        args = [
            ("--" + a[1:]) if (
                len(a) > 2 and a.startswith("-") and not a.startswith("--")
                and ("--" + a[1:]) in self._option_string_actions
            ) else a
            for a in args
        ]
        return super().parse_known_args(args, namespace)


def _log(msg: str) -> None:
    print(f"[{time.asctime()}] {msg}", file=sys.stderr)


def cmd_idx(argv):
    p = _DashArgumentParser(prog="abismal-tpu-torch idx")
    p.add_argument("-A", "--targets", default="")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("genome_fasta")
    p.add_argument("index_file")
    a = p.parse_args(argv)

    from .index.build import create_index, create_index_targets
    from .index.serialize import write_index

    if a.targets:
        idx = create_index_targets(a.targets, a.genome_fasta,
                                   verbose=a.verbose, n_threads=a.threads)
    else:
        idx = create_index(a.genome_fasta, verbose=a.verbose,
                           n_threads=a.threads)
    write_index(idx, a.index_file)
    return 0


def cmd_sim(argv):
    p = _DashArgumentParser(prog="abismal-tpu-torch sim")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--single", action="store_true")
    p.add_argument("--loc", default="")
    p.add_argument("-l", "--read-len", type=int, default=100)
    p.add_argument("--min-fraglen", type=int, default=100)
    p.add_argument("--max-fraglen", type=int, default=250)
    p.add_argument("-n", "--n-reads", type=int, default=100)
    p.add_argument("-m", "--mut", type=float, default=0.0)
    p.add_argument("-b", "--bis", type=float, default=1.0)
    p.add_argument("-c", "--changes", default="")
    p.add_argument("-M", "--max-mut", type=int, default=None,
                   help="accepted for compatibility; unused upstream too")
    p.add_argument("-a", "--pbat", action="store_true")
    p.add_argument("-R", "--random-pbat", action="store_true")
    p.add_argument("-s", "--strand", default="b")
    p.add_argument("--show-matches", dest="show_matches",
                   action="store_false", default=True,
                   help="toggle match symbols in loc cigars off (the "
                        "reference's bool options toggle their default)")
    p.add_argument("--require-valid", action="store_true",
                   help="resample fragments per the reference's "
                        "require-valid loop (RNG-consumption compatible)")
    p.add_argument("--fasta", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("genome_fasta")
    a = p.parse_args(argv)

    from .sim.simreads import SimConfig, simulate_reads

    sub, ins, dele = 1.0, 1.0, 1.0
    if a.changes:
        parts = a.changes.split(",")
        sub, ins, dele = (float(parts[0]), float(parts[1]), float(parts[2]))
    seed = a.seed if a.seed is not None else int(time.time())
    cfg = SimConfig(
        output_prefix=a.out, n_reads=a.n_reads, read_length=a.read_len,
        min_frag_len=a.min_fraglen, max_frag_len=a.max_fraglen,
        mutation_rate=a.mut, substitution_rate=sub, insertion_rate=ins,
        deletion_rate=dele, bs_conv=a.bis, strand=a.strand, pbat=a.pbat,
        random_pbat=a.random_pbat, single_end=a.single, fasta_format=a.fasta,
        show_cigar_matches=a.show_matches, require_valid=a.require_valid,
        locations_file=a.loc, seed=seed,
    )
    simulate_reads(a.genome_fasta, cfg)
    return 0


def cmd_map(argv):
    p = _DashArgumentParser(prog="abismal-tpu-torch map")
    p.add_argument("-i", "--index", default="")
    p.add_argument("-g", "--genome", default="")
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("-B", "--bam", action="store_true")
    p.add_argument("-s", "--stats", default="")
    p.add_argument("-j", "--json", action="store_true")
    p.add_argument("-c", "--max-candidates", type=int, default=0)
    p.add_argument("-l", "--min-frag", type=int, default=32)
    p.add_argument("-L", "--max-frag", type=int, default=3000)
    p.add_argument("-m", "--max-distance", type=float, default=0.1)
    p.add_argument("-a", "--ambig", action="store_true")
    p.add_argument("-P", "--pbat", action="store_true")
    p.add_argument("-R", "--random-pbat", action="store_true")
    p.add_argument("-A", "--a-rich", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--lmax", type=int, default=128,
                   help="padded read length for the device pipeline; reads "
                        "longer than this use the host path")
    p.add_argument("--device", default="cuda",
                   help="torch device of the device pipeline (cuda, cuda:N "
                        "or cpu)")
    p.add_argument("--engine",
                   choices=["torch", "hybrid", "native", "exact",
                            "torch-replay"], default="torch",
                   help="torch (device stage-1+2 + native finalize, "
                        "default), hybrid (the native engine on the host "
                        "cores AND the torch engine, on disjoint read "
                        "shards at once; their rates add), native (C++ "
                        "host engine, no device), exact (Python reference "
                        "engine, no device) or torch-replay (device "
                        "stage-1 + Python replay; with -t N the replay "
                        "runs in N worker processes)")
    p.add_argument("--device-share", dest="device_share", type=float,
                   default=None,
                   help="--engine hybrid: fraction of reads routed to the "
                        "device (default $ABISMAL_DEVICE_SHARE or 0.15; "
                        "pick ~= dev_rate / (dev_rate + host_rate))")
    p.add_argument("--device-align", dest="device_align", default=None,
                   action="store_true",
                   help="on the event-stream route (ABISMAL_TPU_STAGE2=0) "
                        "score the native engine's alignment jobs on the "
                        "device too (default $ABISMAL_TPU_DEVICE_ALIGN; the "
                        "fused default route scores every job on the device "
                        "already; not with --mesh)")
    p.add_argument("--mesh", default=None,
                   help="map over the first N local CUDA devices, or "
                        "'all', each with its own copy of the index and "
                        "2048 units per chunk (with --device cpu: N CPU "
                        "slots)")
    p.add_argument("--index-shards", dest="index_shards", default=None,
                   help="split the index's position lists by bucket-key "
                        "range over the first N local CUDA devices, or "
                        "'all'; every device maps every chunk and the host "
                        "merges their events (the event-stream route; with "
                        "--device cpu: N CPU slots)")
    p.add_argument("--hosts", type=int, default=0,
                   help="multi-host run: shard the FASTQ by read range over "
                        "N processes (each loads its own index; --engine "
                        "torch puts shard i on cuda:i mod the card count, "
                        "--engine native maps on the host cores) and "
                        "gather the shard SAMs in rank order; output is "
                        "byte-identical to a one-process run (requires -i)")
    p.add_argument("--shard", default="",
                   help="map only read-range shard I:N of the input (one "
                        "host of a real multi-host run; shard 0 alone "
                        "writes the header; concatenate the shard outputs "
                        "in rank order to gather; requires -i)")
    p.add_argument("reads_files", nargs="+")
    a = p.parse_args(argv)

    if bool(a.index) == bool(a.genome):
        print("Select one of index file (-i) or genome file (-g)",
              file=sys.stderr)
        return 0
    if len(a.reads_files) > 2:
        print("expected <reads-fq1> [<reads-fq2>]", file=sys.stderr)
        return 0
    if a.lmax < 64:
        print("--lmax must be at least 64", file=sys.stderr)
        return 1
    for opt, val in (("--mesh", a.mesh), ("--index-shards", a.index_shards)):
        if val is not None and a.engine != "torch":
            print(f"{opt} cannot be combined with --engine {a.engine}",
                  file=sys.stderr)
            return 1
        if val is not None and a.device_align:
            print(f"--device-align cannot be combined with {opt}",
                  file=sys.stderr)
            return 1
    if a.mesh is not None and a.index_shards is not None:
        print("--index-shards cannot be combined with --mesh",
              file=sys.stderr)
        return 1
    if a.device_align and a.engine not in ("torch", "hybrid"):
        print(f"--device-align cannot be combined with --engine {a.engine}",
              file=sys.stderr)
        return 1

    command_line = "map " + " ".join(argv)
    reads2 = a.reads_files[1] if len(a.reads_files) == 2 else None
    if a.hosts or a.shard:
        # every shard process loads its own index replica, so the
        # coordinator never loads one
        if not a.index:
            print("--hosts/--shard require a prebuilt index (-i)",
                  file=sys.stderr)
            return 0
        if (a.engine not in ("torch", "native") or a.mesh is not None
                or a.index_shards):
            print("--hosts/--shard run the torch engine, one device per "
                  "shard, or the native engine: not with --engine hybrid "
                  "or --mesh, nor with another --engine or --index-shards",
                  file=sys.stderr)
            return 1
        return _map_sharded(a, reads2, command_line)

    mesh, shards, unit_batch = None, None, 2048
    for opt, val in (("--mesh", a.mesh), ("--index-shards", a.index_shards)):
        if val is None:
            continue
        from .parallel.mesh import make_mesh

        if a.device == "cpu":
            if val == "all":
                print(f"{opt} all needs CUDA devices", file=sys.stderr)
                return 1
            slots = ["cpu"] * int(val)
        else:
            slots = make_mesh(val if val == "all" else int(val))
        if opt == "--mesh":
            # every slot maps the one-device chunk of 2048 units
            mesh, unit_batch = slots, unit_batch * len(slots)
        else:  # every slot maps every chunk
            shards = slots

    from .index.build import create_index
    from .index.serialize import read_index
    from .map.engine import run_map
    from .map.host_units import make_native_engine_factory
    from .map.pipeline import (
        make_torch_engine_factory, make_torch_native_engine_factory,
    )

    if a.index:
        if a.verbose:
            _log(f"loading index {a.index}")
        index = read_index(a.index)
    else:
        if a.verbose:
            _log(f"indexing genome {a.genome}")
        index = create_index(a.genome)
    if a.max_candidates:
        index.max_candidates = a.max_candidates

    if a.engine == "native":
        factory = make_native_engine_factory(n_threads=a.threads)
    elif a.engine == "exact":
        factory = None  # run_map's default: the exact engine
    elif a.engine == "torch-replay":
        factory = make_torch_engine_factory(a.device, lmax=a.lmax)
    else:
        factory = make_torch_native_engine_factory(
            a.device, lmax=a.lmax, unit_batch=unit_batch,
            n_threads=a.threads, mesh_devices=mesh,
            device_align=a.device_align, index_shards=shards)
    if a.engine == "hybrid":
        return _map_hybrid(a, index, reads2, command_line, factory)
    run_map(
        index, a.reads_files[0], reads2, a.outfile, a.stats or None,
        command_line, a_rich=a.a_rich, pbat=a.pbat,
        random_pbat=a.random_pbat, allow_ambig=a.ambig, stats_json=a.json,
        valid_frac=a.max_distance, pe_min_dist=a.min_frag,
        pe_max_dist=a.max_frag, engine_factory=factory,
        threads=a.threads, bam=a.bam, verbose=a.verbose)
    return 0


def _map_hybrid(a, index, reads2, command_line, factory):
    """--engine hybrid: the native engine maps the first reads on the host
    cores while the torch engine maps the rest; with -i the host shard
    runs in its own process (NativeShardServer), as in abismal_tpu."""
    from .map.engine import _write_stats as write_stats
    from .map.hybrid_split import NativeShardServer, run_map_hybrid_split

    threads = max(1, a.threads)
    eng = factory(index, a.ambig, a.max_distance, a.min_frag, a.max_frag)
    eng.n_threads = threads
    server = None
    if a.index:
        server = NativeShardServer(a.index, a.ambig, a.max_distance,
                                   a.min_frag, a.max_frag, threads=threads)
    try:
        stats = run_map_hybrid_split(
            index, a.reads_files[0], reads2, a.outfile, command_line,
            device_share=a.device_share, threads=threads, a_rich=a.a_rich,
            pbat=a.pbat, random_pbat=a.random_pbat, allow_ambig=a.ambig,
            valid_frac=a.max_distance, pe_min_dist=a.min_frag,
            pe_max_dist=a.max_frag, lmax=a.lmax, bam=a.bam,
            verbose=a.verbose, tpu_engine=eng, native_server=server)
    finally:
        if server is not None:
            server.close()
    write_stats(stats, a.stats or None, a.json, reads2 is not None, a.ambig)
    return 0


def _map_sharded(a, reads2, command_line):
    """--hosts N (N spawned shard processes, gathered here) or --shard I:N
    (this process maps shard I alone), with --engine torch or native.
    --device cuda puts torch shard i on cuda:i mod the card count; any
    other device takes every shard; native shards use no device."""
    from .map.engine import _write_stats as write_stats
    from .map.stats import PEStats, SEStats
    from .parallel.multihost import (
        _apply_stats, count_reads, map_shard, run_map_multihost,
        shard_bounds,
    )

    device = None if a.device == "cuda" else a.device
    kw = dict(a_rich=a.a_rich, pbat=a.pbat, random_pbat=a.random_pbat,
              allow_ambig=a.ambig, valid_frac=a.max_distance,
              pe_min_dist=a.min_frag, pe_max_dist=a.max_frag, bam=a.bam,
              verbose=a.verbose, lmax=a.lmax, device=device,
              engine=a.engine)
    paired = reads2 is not None
    if a.hosts:
        if a.hosts < 0:
            print("--hosts must be positive", file=sys.stderr)
            return 1
        stats = run_map_multihost(
            a.index, a.reads_files[0], reads2, a.outfile, command_line,
            n_hosts=a.hosts, threads_per_host=max(1, a.threads), **kw)
    else:
        try:
            si, sn = (int(x) for x in a.shard.split(":"))
        except ValueError:
            si, sn = -1, 0
        if not 0 <= si < sn:
            print(f"--shard must be I:N with 0 <= I < N, not {a.shard}",
                  file=sys.stderr)
            return 1
        skip, cnt = shard_bounds(count_reads(a.reads_files[0]), sn)[si]
        raw = map_shard(a.index, a.reads_files[0], reads2, a.outfile, si,
                        sn, command_line, skip, cnt,
                        threads=max(1, a.threads), **kw)
        stats = PEStats() if paired else SEStats()
        _apply_stats(raw, paired, stats)
    write_stats(stats, a.stats or None, a.json, paired, a.ambig)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Program: abismal-tpu-torch\nUsage: python -m abismal_tpu_torch "
              "<command> [options]\nCommands:\n    map:    map FASTQ reads, "
              "or read pairs from two FASTQs (-l/-L: fragment\n"
              "            length window), on a torch device (--device, "
              "default cuda);\n"
              "            --mesh N|all: over N devices; --index-shards "
              "N|all: the index\n"
              "            split over N devices; --engine hybrid: with the "
              "host cores\n"
              "            (--device-share); --hosts N / --shard I:N: in "
              "read-range shards;\n"
              "            --engine native|exact|torch-replay: the C++ or "
              "Python engines\n"
              "    idx:    make an index for a FASTA reference genome\n"
              "    sim:    simulate WGBS reads for a FASTA reference genome")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "map":
        return cmd_map(rest)
    if cmd == "idx":
        return cmd_idx(rest)
    if cmd == "sim":
        return cmd_sim(rest)
    print(f"ERROR: invalid command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
