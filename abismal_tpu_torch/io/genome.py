"""Genome (FASTA) loading and the chromosome lookup table.

Mirrors the reference semantics exactly (src/AbismalIndex.cpp:1148-1372):
chromosomes are concatenated into one buffer with PADDING_SIZE 'N's on both
ends recorded as synthetic "pad_start"/"pad_end" chromosomes; `starts` is a
prefix array with one extra final entry (total size).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from ..constants import PADDING_SIZE


def open_maybe_gzip(path: str):
    """Open a text file that may be gzip/bgzf compressed."""
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        g = gzip.open(f, "rb")
        g.raw_file = f  # compressed-byte position for progress reporting
        return g
    return f


@dataclass
class ChromLookup:
    """name <-> concatenated-genome-offset mapping
    (AbismalIndex.hpp:101-143, AbismalIndex.cpp:1282-1320)."""

    names: list = field(default_factory=list)
    starts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))

    def get_genome_size(self) -> int:
        return int(self.starts[-1])

    def get_chrom_idx_and_offset(self, pos: int):
        """pos -> (chrom_idx, offset) via upper_bound on starts."""
        idx = int(np.searchsorted(self.starts, pos, side="right")) - 1
        return idx, pos - int(self.starts[idx])

    def get_chrom_idx_and_offset_checked(self, pos: int, readlen: int):
        """Also validates that [pos, pos+readlen) stays in one chromosome
        (AbismalIndex.cpp:1305-1320).  Returns (ok, chrom_idx, offset)."""
        idx = int(np.searchsorted(self.starts, pos, side="right"))
        if idx == 0:
            return False, 0, 0
        idx -= 1
        offset = pos - int(self.starts[idx])
        ok = pos + readlen <= int(self.starts[idx + 1])
        return ok, idx, offset

    def get_pos(self, chrom: str, offset: int) -> int:
        try:
            i = self.names.index(chrom)
        except ValueError:
            return 0xFFFFFFFF
        return int(self.starts[i]) + offset

    # --- binary serialization (AbismalIndex.cpp:1148-1258) ---
    def write(self, f) -> None:
        n = len(self.names)
        f.write(np.uint32(n).tobytes())
        for name in self.names:
            b = name.encode()
            f.write(np.uint32(len(b)).tobytes())
            f.write(b)
        f.write(np.asarray(self.starts[: n + 1], dtype="<u4").tobytes())

    @classmethod
    def read(cls, f) -> "ChromLookup":
        n = int(np.frombuffer(f.read(4), dtype="<u4")[0])
        names = []
        for _ in range(n):
            sz = int(np.frombuffer(f.read(4), dtype="<u4")[0])
            names.append(f.read(sz).decode())
        starts = np.frombuffer(f.read(4 * (n + 1)), dtype="<u4").copy()
        return cls(names=names, starts=starts)


def load_genome(genome_file: str):
    """Load a (possibly gzipped) FASTA into an ASCII uint8 array with N
    padding, mirroring load_genome_impl (AbismalIndex.cpp:1322-1360).

    Returns (genome_ascii_u8, ChromLookup).  Bases are kept verbatim (no
    case folding) exactly like the reference.
    """
    names = ["pad_start"]
    starts = [0]
    chunks = [np.full(PADDING_SIZE, ord("N"), dtype=np.uint8)]
    size = PADDING_SIZE

    def add_name(header: bytes):
        # name = text after '>' up to first space/tab (AbismalIndex.cpp:1346)
        cut = len(header)
        for d in (b" ", b"\t"):
            p = header.find(d)
            if p != -1:
                cut = min(cut, p)
        names.append(header[:cut].decode())
        starts.append(size)

    with open_maybe_gzip(genome_file) as fh:
        data = fh.read()
        if data[:1] == b">":
            # fast path: split whole-buffer records at line-start '>' and
            # delete newlines at C speed -- byte-identical to the line
            # loop below (only '\n' is stripped, '\r' and case are kept)
            for rec in data.split(b"\n>"):
                if rec[:1] == b">":
                    rec = rec[1:]
                nl = rec.find(b"\n")
                if nl == -1:
                    add_name(rec)
                    continue
                add_name(rec[:nl])
                seq = rec[nl + 1:].translate(None, b"\n")
                arr = np.frombuffer(seq, dtype=np.uint8)
                chunks.append(arr)
                size += arr.shape[0]
        else:
            for raw in data.split(b"\n"):
                line = raw
                if line[:1] == b">":
                    add_name(line[1:])
                else:
                    arr = np.frombuffer(line, dtype=np.uint8)
                    chunks.append(arr)
                    size += arr.shape[0]

    if len(names) < 2:
        raise RuntimeError("no names found in genome file")

    names.append("pad_end")
    starts.append(size)
    chunks.append(np.full(PADDING_SIZE, ord("N"), dtype=np.uint8))
    size += PADDING_SIZE
    starts.append(size)

    genome = np.concatenate(chunks)
    cl = ChromLookup(names=names, starts=np.asarray(starts, dtype=np.uint32))
    return genome, cl
