"""The genome generator and the read simulator are deterministic from
their seeds, and each simulated mate's truth is its source."""

from __future__ import annotations

import hashlib
import os

import numpy as np

from abismal_bench.gen import fasta, genome, reads
from abismal_bench.reference.check import Judge


def _md5(p):
    return hashlib.md5(open(p, "rb").read()).hexdigest()


def test_genome_is_deterministic(tmp_path):
    a, b, c = (str(tmp_path / n) for n in ("a.fa", "b.fa", "c.fa"))
    genome.gen_genome(a, 300_000, seed=11, chrom_len=120_000)
    genome.gen_genome(b, 300_000, seed=11, chrom_len=120_000)
    genome.gen_genome(c, 300_000, seed=12, chrom_len=120_000)
    assert _md5(a) == _md5(b) != _md5(c)
    g = fasta.Genome(a, str(tmp_path / "a.npz"))
    assert g.names == ["chr1", "chr2", "chr3"]
    assert g.lengths.tolist() == [120_000, 120_000, 60_000]
    raw = open(a, "rb").read().split(b"\n>")[1].split(b"\n", 1)[1]
    raw = raw.replace(b"\n", b"")
    got = g.window(1, 0, 120_000)
    keep = np.frombuffer(raw, np.uint8) != ord("N")
    assert np.array_equal(got[keep], np.frombuffer(raw, np.uint8)[keep])


def _pool(path, seed, paired):
    g = fasta.Genome(path, path + ".npz")
    return g, reads.simulate(g, 300, seed, 100, 100, 250, 0.01, [1, 1, 1],
                             0.98, paired)


def test_reads_are_deterministic_and_true(tmp_path):
    fa = str(tmp_path / "g.fa")
    genome.gen_genome(fa, 400_000, seed=11, chrom_len=200_000)
    for paired in (False, True):
        g, p1 = _pool(fa, 2**31 + 7, paired)
        _, p2 = _pool(fa, 2**31 + 7, paired)
        _, p3 = _pool(fa, 2**31 + 8, paired)
        assert p1.seqs == p2.seqs and p1.truth == p2.truth
        assert p1.seqs != p3.seqs
        judge = Judge(g, p1, [(0, p1.n)], paired)
        nms = [judge.truth_score(k, i)[0] for k in range(len(p1.seqs))
               for i in range(p1.n)]
        # the true path of a read carries only its mutations (1%) and the
        # converted bases' wildcard matches: a few differences at most
        assert np.mean(nms) < 2.5 and max(nms) <= 12
        muts = sum("I" in t.cigar or "D" in t.cigar
                   for m in p1.truth for t in m)
        assert muts > 0


def test_fastq_round_trip(tmp_path):
    names, seqs = ["read0", "read1"], [b"ACGT" * 25, b"TTGA" * 25]
    p = str(tmp_path / "r.fq")
    reads.write_fastq(p, names, seqs, 2)
    assert open(p, "rb").read().split(b"\n")[:4] == [
        b"@read0.2", b"ACGT" * 25, b"+", b"B" * 100]
    assert os.path.getsize(p) == 2 * (9 + 101 + 2 + 101)
