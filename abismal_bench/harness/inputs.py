"""A run's inputs: the configuration's genome and its index, cached inside
the checkout, and the pool of reads that the seed draws.

The genome, its layout (gen/fasta.py) and the index live in
build/abismal_bench/genomes/<key>/, where key hashes the genome's
parameters and the generator's source; the index's name adds a hash of
the port's index/ and native/ sources, so that a change to how the port
builds an index builds it again.  Each file is written under a temporary
name and moved into place.  Only the first run in a checkout makes them."""

from __future__ import annotations

import glob
import hashlib
import json
import os

from ..gen import fasta, genome as gen_genome, reads
from .spec import ROOT


def _md5_files(paths) -> str:
    h = hashlib.md5()
    for p in sorted(paths):
        h.update(os.path.relpath(p, ROOT).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def genome_dir(config: dict, build: str) -> str:
    g = config["genome"]
    key = hashlib.md5(json.dumps(g, sort_keys=True).encode()
                      + _md5_files([gen_genome.__file__]).encode()
                      ).hexdigest()[:16]
    d = os.path.join(build, "abismal_bench", "genomes", key)
    os.makedirs(d, exist_ok=True)
    return d


def genome_files(config: dict, build: str | None = None):
    """(FASTA path, fasta.Genome) of the configuration, made on first use."""
    d = genome_dir(config, build or os.path.join(ROOT, "build"))
    g = config["genome"]
    fa = os.path.join(d, "genome.fa")
    made = not os.path.exists(fa)
    if made:
        gen_genome.gen_genome(fa, int(g["genome_size"]),
                              seed=int(g["genome_seed"]),
                              chrom_len=int(g["chrom_len"]))
    genome = fasta.Genome(fa, os.path.join(d, "layout.npz"))
    if made:
        os.sync()  # the write-back in this run's set-up, not in the next's
    return fa, genome


def index_file(fa: str, threads: int) -> str:
    """The port's index of fa, built and written by the port on first use."""
    pkg = os.path.join(ROOT, "abismal_tpu_torch")
    src = [p for sub in ("index", "native")
           for p in glob.glob(os.path.join(pkg, sub, "*"))
           if p.endswith((".py", ".cpp", ".h", ".hpp"))]
    path = os.path.join(os.path.dirname(fa),
                        f"index-{_md5_files(src)[:16]}.idx")
    if not os.path.exists(path):
        from abismal_tpu_torch.index.build import create_index
        from abismal_tpu_torch.index.serialize import write_index

        tmp = f"{path}.tmp{os.getpid()}"
        write_index(create_index(fa, n_threads=threads), tmp)
        os.replace(tmp, path)
        os.sync()
    return path


TRAFFIC = ("read_length", "frag_min", "frag_max", "pool_reads",
           "pool_files", "mutation_rate", "sub_ins_del", "bs_conv",
           "traffic_seed", "protocol")


def make_pool(genome, workload: dict, seed: int, paired: bool) -> reads.Pool:
    """The pool the seed draws; ValueError for a traffic parameter the
    simulator does not know or one that is missing."""
    t = workload["traffic"]
    if set(t) != set(TRAFFIC):
        raise ValueError(f"traffic parameters: unknown "
                         f"{sorted(set(t) - set(TRAFFIC))}, missing "
                         f"{sorted(set(TRAFFIC) - set(t))}")
    return reads.simulate(
        genome, int(t["pool_reads"]), seed, int(t["read_length"]),
        int(t["frag_min"]), int(t["frag_max"]), float(t["mutation_rate"]),
        t["sub_ins_del"], float(t["bs_conv"]), paired,
        groups=int(t["pool_files"]), traffic_seed=int(t["traffic_seed"]),
        protocol=t["protocol"])


def write_pool(pool: reads.Pool, n_files: int, out_dir: str):
    """The pool in n_files FASTQ files (pairs: two each): ([(fq1, fq2 or
    None)], [(first read, end)])."""
    n = pool.n
    bounds = [(n * i // n_files, n * (i + 1) // n_files)
              for i in range(n_files)]
    files = []
    for i, (s, e) in enumerate(bounds):
        fq = []
        for k in range(len(pool.seqs)):
            p = os.path.join(out_dir, f"pool{i}_{k + 1}.fq")
            reads.write_fastq(p, pool.names[s:e], pool.seqs[k][s:e], k + 1)
            fq.append(p)
        files.append((fq[0], fq[1] if len(fq) > 1 else None))
    return files, bounds

