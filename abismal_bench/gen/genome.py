"""The synthetic stand-in for hg38 that the benchmark's configurations map
against.

Frozen copy of tools/scale_test.py:22 (gen_genome), so that the yardstick
does not move when the repository's tools do.  The only changes: the
chromosome length is a parameter (120 Mb by default, as there), and the
file is written under a temporary name and moved into place, so that a
reader never sees half a genome."""

from __future__ import annotations

import os

import numpy as np


def gen_genome(path: str, total: int, seed: int = 11,
               chrom_len: int = 120_000_000) -> None:
    """Streaming synthetic genome: chromosomes of chrom_len bases with
    interior N runs, occasional IUPAC ambiguity codes, and tandem
    repeats, in 80-column FASTA lines."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    iupac = np.frombuffer(b"RYSWKM", dtype=np.uint8)
    written = 0
    ci = 0
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        while written < total:
            n = int(min(chrom_len, total - written))
            ci += 1
            f.write(f">chr{ci}\n".encode())
            chunk_sz = 10_000_000
            for off in range(0, n, chunk_sz):
                m = min(chunk_sz, n - off)
                seq = bases[rng.integers(0, 4, size=m)]
                # sprinkle N runs (~1 per 2 Mb, 10..5000 bases)
                for _ in range(max(1, m // 2_000_000)):
                    s = int(rng.integers(0, max(1, m - 6000)))
                    ln = int(rng.integers(10, 5000))
                    seq[s : s + ln] = ord("N")
                # occasional IUPAC codes
                k = m // 1_000_000
                if k:
                    pos = rng.integers(0, m, size=k)
                    seq[pos] = iupac[rng.integers(0, 6, size=k)]
                # a tandem repeat region per chunk (big buckets)
                rep = np.frombuffer(b"ACGTACGTTTAGGC" * 1500, dtype=np.uint8)
                s = int(rng.integers(0, max(1, m - rep.shape[0])))
                seq[s : s + rep.shape[0]] = rep
                # 80-col fasta lines
                pad = (-m) % 80
                if pad:
                    seq = np.concatenate([seq, np.full(pad, ord("\n"),
                                                       np.uint8)])
                lines = seq.reshape(-1, 80)
                out = np.empty((lines.shape[0], 81), dtype=np.uint8)
                out[:, :80] = lines
                out[:, 80] = ord("\n")
                data = out.tobytes()
                if pad:
                    data = data[: -(pad + 1)] + b"\n"
                f.write(data)
            written += n
    os.replace(tmp, path)
