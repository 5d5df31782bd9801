"""The control of the judge in check.py: the reference put in the
mapper's place with one guarantee of the configuration broken.

Each read is reported, as a single-end record, where the simulator says
it came from, along its true path, with its NM counted as plain DNA: the
bisulfite wildcard that a directional WGBS configuration states (a T of
a T-rich read matches a C of the genome, an A of an A-rich read a G) is
left out, so every converted C counts as a mismatch.  Held to that
count, hardly a read would pass -m and nothing would be written, so the
control writes every read that aligns enough of its bases, whatever its
count; the judge must find the cell not correct on this output."""

from __future__ import annotations

from .check import PLAIN, parse_cigar, path_counts, revcomp, spans, valid_len


def control_sam(judge, fidx: int, path: str) -> None:
    """Writes the control's SAM of pool file fidx to path."""
    g, pool = judge.g, judge.pool
    s, e = judge.files[fidx]
    lines = [b"@HD\tVN:1.0\n"]
    for i in range(s, e):
        for k in range(len(pool.seqs)):
            t = pool.truth[k][i]
            seq = pool.seqs[k][i]
            if t.reverse:
                seq = revcomp(seq)
            ops = parse_cigar(t.cigar)
            _, span, aligned = spans(ops)
            nm, _ = path_counts(seq, PLAIN, g.window(t.chrom, t.start, span),
                                ops)
            L = len(seq)
            if not valid_len(aligned, L):
                continue
            lines.append(b"%s.%d\t%d\t%s\t%d\t255\t%s\t*\t0\t0\t%s\t*\t"
                         b"NM:i:%d\tCV:A:%s\n" % (
                             pool.names[i].encode(), k + 1,
                             16 if t.reverse else 0,
                             g.names[t.chrom].encode(), t.start + 1,
                             t.cigar.encode(), seq, nm, t.cv.encode()))
    with open(path, "wb") as f:
        f.write(b"".join(lines))
