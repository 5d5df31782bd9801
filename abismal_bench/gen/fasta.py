"""Random access to a FASTA genome as the mapper sees it, for the read
simulator and the plain reference.

The layout of a FASTA file (each chromosome's name, length, byte offset
and line width) is read once and kept in a small file beside it, with the
one change the mapper makes to the bases: N runs of at most MAX_N_COUNT
bases, counted over the chromosomes laid end to end between two pads of
PADDING_SIZE Ns, are replaced by the stream of a linear congruential
generator (seed 1, one step a base, in increasing position).  That is
upstream abismal's rule (AbismalIndex.cpp:125-175), written here again
from its description; nothing of the program is read."""

from __future__ import annotations

import os

import numpy as np

PADDING_SIZE = 32767  # Ns on both ends of the concatenated genome
MAX_N_COUNT = 256  # longer N runs stay N (excluded), shorter are replaced
_NL = ord("\n")


def _lcg_bases(n: int) -> np.ndarray:
    state = 1
    out = np.empty(n, np.uint8)
    acgt = b"ACGT"
    for i in range(n):
        state = (1103515245 * state + 12345) & 0x7FFFFFFF
        out[i] = acgt[state & 3]
    return out


def _runs(mask: np.ndarray):
    d = np.diff(mask.astype(np.int8), prepend=np.int8(0), append=np.int8(0))
    return np.flatnonzero(d == 1), np.flatnonzero(d == -1)


def scan_layout(fasta: str) -> dict:
    """The layout of fasta: names, lengths, seq_off (byte offset of each
    chromosome's first base), line (bases a line), and the replaced
    bases (rep_chrom, rep_off, rep_base)."""
    buf = np.fromfile(fasta, dtype=np.uint8)
    heads = np.flatnonzero(buf == ord(">"))
    heads = heads[(heads == 0) | (buf[np.maximum(heads - 1, 0)] == _NL)]
    names, lengths, seq_off, line = [], [], [], []
    runs = []  # (global start, global end) of N runs, in order
    gpos = PADDING_SIZE
    open_run = (0, PADDING_SIZE)  # the leading pad is one N run
    for k, h in enumerate(heads):
        end = int(heads[k + 1]) if k + 1 < len(heads) else buf.shape[0]
        nl = h + int(np.argmax(buf[h:end] == _NL))
        header = bytes(buf[h + 1 : nl])
        names.append(header.split()[0].decode() if header.split() else "")
        region = buf[nl + 1 : end]
        seq = region[region != _NL]
        first = np.flatnonzero(region == _NL)
        width = int(first[0]) if first.size else seq.shape[0]
        n = seq.shape[0]
        # every line but the last of a chromosome has the same width
        if first.size > 1 and not np.all(np.diff(first)[:-1] == width + 1):
            raise ValueError(f"{fasta}: ragged lines in {names[-1]}")
        lengths.append(n)
        seq_off.append(nl + 1)
        line.append(max(width, 1))
        s, e = _runs(seq == ord("N"))
        for a, b in zip((s + gpos).tolist(), (e + gpos).tolist()):
            if open_run is not None and open_run[1] == a:
                open_run = (open_run[0], b)
            else:
                if open_run is not None:
                    runs.append(open_run)
                open_run = (a, b)
        gpos += n
    if open_run is not None and open_run[1] == gpos:
        open_run = (open_run[0], gpos + PADDING_SIZE)
    if open_run is not None:
        runs.append(open_run)
    starts = np.concatenate([[PADDING_SIZE],
                             PADDING_SIZE + np.cumsum(lengths)]).astype(
                                 np.int64)
    short = [(a, b) for a, b in runs if b - a <= MAX_N_COUNT]
    rep_pos = (np.concatenate([np.arange(a, b) for a, b in short])
               if short else np.zeros(0, np.int64)).astype(np.int64)
    rep_chrom = np.searchsorted(starts, rep_pos, side="right") - 1
    return dict(names=np.array(names), lengths=np.array(lengths, np.int64),
                seq_off=np.array(seq_off, np.int64),
                line=np.array(line, np.int64),
                rep_chrom=rep_chrom.astype(np.int64),
                rep_off=(rep_pos - starts[rep_chrom]).astype(np.int64),
                rep_base=_lcg_bases(rep_pos.shape[0]))


class Genome:
    """A FASTA genome by chromosome and offset, with the mapper's N
    replacement; the layout is cached in layout_path (made on first
    use, written under a temporary name and moved into place)."""

    def __init__(self, fasta: str, layout_path: str):
        if not os.path.exists(layout_path):
            tmp = f"{layout_path}.tmp{os.getpid()}.npz"
            np.savez(tmp, **scan_layout(fasta))
            os.replace(tmp, layout_path)
        with np.load(layout_path) as z:
            lay = {k: z[k] for k in z.files}
        self.names = [str(x) for x in lay["names"]]
        self.index = {n: i for i, n in enumerate(self.names)}
        self.lengths = lay["lengths"]
        self.seq_off = lay["seq_off"]
        self.line = lay["line"]
        self.rep = [(lay["rep_off"][lay["rep_chrom"] == c],
                     lay["rep_base"][lay["rep_chrom"] == c])
                    for c in range(len(self.names))]
        self.buf = np.memmap(fasta, dtype=np.uint8, mode="r")
        # where a chromosome starts when all are laid end to end: uniform
        # draws of positions over the whole genome
        self.cum = np.concatenate([[0], np.cumsum(self.lengths)])

    @property
    def size(self) -> int:
        return int(self.cum[-1])

    def take(self, chrom: np.ndarray, off: np.ndarray) -> np.ndarray:
        """Bases (ASCII) at chromosome chrom[i] and offsets off[i, ...]
        (any shape after the first axis), with the replaced Ns; N outside
        a chromosome."""
        chrom = np.asarray(chrom, np.int64)
        off = np.asarray(off, np.int64)
        cshape = (-1,) + (1,) * (off.ndim - 1)
        inside = (off >= 0) & (off < self.lengths[chrom].reshape(cshape))
        o = np.where(inside, off, 0)
        at = self.seq_off[chrom].reshape(cshape) + o + o // self.line[
            chrom].reshape(cshape)
        out = np.where(inside, self.buf[at], ord("N")).astype(np.uint8)
        flat = off.reshape(off.shape[0], -1)
        lo, hi = flat.min(axis=1), flat.max(axis=1)
        for ci in np.unique(chrom).tolist():
            roff, rbase = self.rep[ci]
            if not roff.size:
                continue
            k = np.searchsorted(roff, lo)
            rows = np.flatnonzero((chrom == ci) & (k < roff.size)
                                  & (roff[np.minimum(k, roff.size - 1)]
                                     <= hi))
            for r in rows.tolist():
                o = off[r]
                j = np.minimum(np.searchsorted(roff, o), roff.size - 1)
                hit = (roff[j] == o) & inside[r]
                out[r][hit] = rbase[j[hit]]
        return out

    def window(self, chrom: int, start: int, n: int) -> np.ndarray:
        return self.take(np.array([chrom]), (start + np.arange(n))[None])[0]
