"""Command line of the port: `python -m abismal_tpu_torch map ...` maps
single-end reads, or read pairs given two FASTQs, with the PyTorch engine
on --device (default cuda).
`idx` and `sim` are host-only and run abismal_tpu's commands unchanged.
The SAM @PG CL: header records argv as abismal_tpu's CLI does."""

from __future__ import annotations

import sys

from abismal_tpu.cli import _DashArgumentParser, _log, cmd_idx, cmd_sim


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

    from .host import create_index, read_index, run_map
    from .map.pipeline import make_torch_native_engine_factory

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

    reads2 = a.reads_files[1] if len(a.reads_files) == 2 else None
    run_map(
        index, a.reads_files[0], reads2, a.outfile, a.stats or None,
        "map " + " ".join(argv), a_rich=a.a_rich, pbat=a.pbat,
        random_pbat=a.random_pbat, allow_ambig=a.ambig, stats_json=a.json,
        valid_frac=a.max_distance, pe_min_dist=a.min_frag,
        pe_max_dist=a.max_frag,
        engine_factory=make_torch_native_engine_factory(
            a.device, lmax=a.lmax, n_threads=a.threads),
        threads=a.threads, bam=a.bam, verbose=a.verbose)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Program: abismal-tpu-torch\nUsage: python -m abismal_tpu_torch "
              "<command> [options]\nCommands:\n    map:    map FASTQ reads, "
              "or read pairs from two FASTQs (-l/-L: fragment\n"
              "            length window), on a torch device (--device, "
              "default cuda)\n"
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
