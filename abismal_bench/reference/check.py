"""The plain reference that decides `correct`: it judges the SAM records
that the mapper wrote for a sample of the reads, drawn from the seed,
against the genome and the simulator's truth.  NumPy only; it imports
nothing of the program and reads nothing the program made but its SAM
text (or its BAM, read back by bam.py).

Upstream abismal's rules, written again from their description
(AbismalAlign.hpp, abismal.cpp), and what the judge holds a record to:

- a base of the read matches a base of the genome when their 4-bit sets
  meet: A=1, C=2, G=4, T=8, IUPAC codes their unions, N the empty set;
  a T-rich read's T is {C,T} and an A-rich read's A is {A,G} (the
  bisulfite wildcard).  SEQ is written on the forward strand, so the
  wildcard of a record is T's when its CV tag is T and it is forward, or
  CV is A and it is reverse, and A's otherwise;
- a path scores +2 a match, -3 a mismatch, -4 an inserted or deleted
  base; soft clips score nothing.  NM is its mismatches plus its
  inserted and deleted bases;
- a single-end record is valid when NM <= int(m * len) and it aligns at
  least max(44, int(0.6 len)) of its bases; the two records of a pair
  when NM1 + NM2 <= int(m * (span1 + span2)) and each spans at least
  max(44, int(0.6 len)) reference bases (m: -m, 0.1);
- the text: QNAME, FLAG, RNAME, POS, 255, CIGAR of M/I/D/S, RNEXT,
  PNEXT, TLEN, SEQ, '*', NM:i:, CV:A:; a read mapped as directional is
  T-rich (mate 1) or A-rich (mate 2), as PBAT (-P; single-end also -A)
  the other way round, as random PBAT (-R) either, a pair's mates
  unlike; a pair's records name each other, and TLEN runs from the first base of mate 1 to the end of mate
  2 (negated on a reverse mate 1, and on mate 2).

Two numbers are compared, each with its limit (the cell's workload file):
  record_faults  sampled records that break any rule above, or that name
                 a read twice or a read the map was not given: exact, 0;
  missed_share   of the sampled mates whose true alignment has at most
                 half the NM that -m allows, the share with no record, a
                 faulty one, or one that scores below the true path."""

from __future__ import annotations

import re
from collections import Counter

import numpy as np

# 4-bit base sets (dna_four_bit_bisulfite.hpp): the genome's IUPAC
# codes, N the empty set; T-rich reads (T matches C or T) and A-rich
# reads (A matches A or G)
GENOME_NIB = np.zeros(256, np.uint8)
for _c, _v in zip("ACGTRYSWKMBDHVN", (1, 2, 4, 8, 5, 10, 6, 9, 12, 3, 14, 13,
                                     11, 7, 0)):
    GENOME_NIB[ord(_c)] = GENOME_NIB[ord(_c.lower())] = _v
T_RICH = np.zeros(256, np.uint8)
A_RICH = np.zeros(256, np.uint8)
PLAIN = np.zeros(256, np.uint8)
for _c, _t, _a, _p in (("A", 1, 5, 1), ("C", 2, 2, 2), ("G", 4, 4, 4),
                       ("T", 10, 8, 8)):
    T_RICH[ord(_c)], A_RICH[ord(_c)], PLAIN[ord(_c)] = _t, _a, _p
MATCH, MISMATCH, INDEL = 2, -3, -4
MIN_READ_LENGTH = 44
INVALID_HIT_FRAC = 0.4
CIGAR_RE = re.compile(r"(\d+)([MIDS])")
FLAG_BITS = 0x1 | 0x2 | 0x10 | 0x20 | 0x40 | 0x80
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(COMP)[::-1]


def parse_cigar(cigar: str):
    ops = [(int(n), op) for n, op in CIGAR_RE.findall(cigar)]
    if not ops or "".join(f"{n}{op}" for n, op in ops) != cigar:
        return None
    return ops


def spans(ops):
    """(query length, reference span, aligned query bases)."""
    q = sum(n for n, op in ops if op in "MIS")
    r = sum(n for n, op in ops if op in "MD")
    a = sum(n for n, op in ops if op in "MI")
    return q, r, a


def valid_len(n: int, readlen: int) -> bool:
    return n >= max(MIN_READ_LENGTH, int((1.0 - INVALID_HIT_FRAC) * readlen))


def path_counts(seq: bytes, table, ref: np.ndarray, ops):
    """(mismatches + indel bases, score) of the path ops of seq against
    the reference bases ref (ASCII, from the path's first base)."""
    q = table[np.frombuffer(seq, np.uint8)]
    g = GENOME_NIB[ref]
    qi = ri = 0
    nm = score = 0
    for n, op in ops:
        if op == "M":
            hit = int(np.count_nonzero(q[qi : qi + n] & g[ri : ri + n]))
            nm += n - hit
            score += MATCH * hit + MISMATCH * (n - hit)
            qi += n
            ri += n
        elif op == "I":
            nm += n
            score += INDEL * n
            qi += n
        elif op == "D":
            nm += n
            score += INDEL * n
            ri += n
        else:  # S
            qi += n
    return nm, score


def wildcard(cv: str, reverse: bool):
    return T_RICH if (cv == "T") != reverse else A_RICH


class Record:
    __slots__ = ("name", "flag", "chrom", "pos", "ops", "rnext", "pnext",
                 "tlen", "seq", "nm", "cv", "text_ok")

    @classmethod
    def parse(cls, line: bytes):
        f = line.rstrip(b"\n").split(b"\t")
        r = cls()
        r.text_ok = False
        r.name = f[0].decode(errors="replace")
        if len(f) != 13:
            return r
        try:
            r.flag, r.pos, mapq = int(f[1]), int(f[3]), int(f[4])
            r.pnext, r.tlen = int(f[7]), int(f[8])
        except ValueError:
            return r
        r.chrom = f[2].decode(errors="replace")
        r.ops = parse_cigar(f[5].decode(errors="replace"))
        r.rnext = f[6]
        r.seq = f[9]
        nm, cv = f[11], f[12]
        if (mapq != 255 or r.ops is None or f[10] != b"*"
                or not nm.startswith(b"NM:i:") or cv not in (b"CV:A:T",
                                                             b"CV:A:A")
                or r.flag & ~FLAG_BITS):
            return r
        try:
            r.nm = int(nm[5:])
        except ValueError:
            return r
        r.cv = cv[-1:].decode()
        r.text_ok = True
        return r


CONVERSIONS = ("directional", "pbat", "random")


def conversion_of(settings: dict, paired: bool) -> str:
    """How the configuration tells the mapper to convert its reads."""
    if settings.get("random_pbat"):
        return "random"
    if settings.get("pbat") or (settings.get("a_rich") and not paired):
        return "pbat"
    return "directional"


def sample(rng, n_maps: int, n_reads: int, want: int):
    """(map, read) pairs to judge: the same number from every map of the
    window, drawn without repeats."""
    per = max(1, -(-want // max(n_maps, 1)))
    per = min(per, n_reads)
    return [(m, int(i)) for m in range(n_maps)
            for i in np.sort(rng.choice(n_reads, per, replace=False))]


def _lines(path: str, bam: bool):
    if bam:
        from .bam import sam_lines

        yield from sam_lines(path)
        return
    with open(path, "rb") as f:
        for line in f:
            if line[:1] != b"@":
                yield line


def read_map(path: str, names: set, want: set, bam: bool = False):
    """The records of the reads in want (name -> [records]), and the
    number of records that name a read twice or a read not in names."""
    recs, seen = {}, set()
    bad = 0
    for line in _lines(path, bam):
        name = line.split(b"\t", 1)[0].decode(errors="replace")
        if name in seen or name not in names:
            bad += 1
        seen.add(name)
        if name in want:
            recs.setdefault(name, []).append(Record.parse(line))
    return recs, bad


class Judge:
    """Judges maps of one workload's pool files.  genome: gen.fasta
    Genome; pool: gen.reads.Pool; files: the read index range of each pool
    file; paired; m: the -m fraction; conversion: one of CONVERSIONS; bam:
    the maps wrote BAM."""

    def __init__(self, genome, pool, files, paired: bool, m: float = 0.1,
                 conversion: str = "directional", bam: bool = False):
        if conversion not in CONVERSIONS:
            raise ValueError(f"conversion {conversion!r}")
        self.g, self.pool, self.files = genome, pool, files
        self.paired, self.m = paired, m
        self.conversion, self.bam = conversion, bam
        self.faults = Counter()

    def _cv_ok(self, cv: str, mate: int) -> bool:
        if self.conversion == "random":
            return True
        t_first = self.conversion == "directional"
        return cv == ("T" if (mate == 0) == t_first else "A")

    def fault(self, why: str):
        self.faults[why] += 1

    def _record_ok(self, r, mate: int, read: bytes) -> tuple:
        """Checks one record alone: (ok, its path score, its ref span)."""
        if not r.text_ok:
            return self.fault("text") or (False, 0, 0)
        reverse = bool(r.flag & 0x10)
        if not self._cv_ok(r.cv, mate):
            return self.fault("conversion") or (False, 0, 0)
        if r.seq != (revcomp(read) if reverse else read):
            return self.fault("seq") or (False, 0, 0)
        q, span, aligned = spans(r.ops)
        c = self.g.index.get(r.chrom)
        if (q != len(read) or c is None or r.pos < 1
                or r.pos - 1 + span > int(self.g.lengths[c])):
            return self.fault("place") or (False, 0, 0)
        nm, score = path_counts(r.seq, wildcard(r.cv, reverse),
                                self.g.window(c, r.pos - 1, span), r.ops)
        if nm != r.nm:
            return self.fault("nm") or (False, 0, 0)
        L = len(read)
        if not r.flag & 0x1:
            if not (nm <= int(self.m * L) and valid_len(aligned, L)):
                return self.fault("valid") or (False, 0, 0)
            if r.rnext != b"*" or r.pnext != 0 or r.tlen != 0:
                return self.fault("mate") or (False, 0, 0)
        elif not valid_len(span, L):
            return self.fault("valid") or (False, 0, 0)
        return True, score, span

    def _pair_ok(self, r1, r2, span1, span2) -> bool:
        """The two records of a reported pair against each other."""
        f1, f2 = r1.flag, r2.flag
        if (f1 & 0xC3 != 0x43 or f2 & 0xC3 != 0x83
                or bool(f1 & 0x20) != bool(f2 & 0x10)
                or bool(f2 & 0x20) != bool(f1 & 0x10)
                or r1.chrom != r2.chrom or r1.rnext != b"="
                or r2.rnext != b"=" or r1.pnext != r2.pos
                or r2.pnext != r1.pos):
            return self.fault("mate") or False
        if r1.cv == r2.cv:
            return self.fault("conversion") or False
        s1, s2 = r1.pos - 1, r2.pos - 1
        isize = (s1 - (s2 + span2)) if f1 & 0x10 else (s2 + span2 - s1)
        if r1.tlen != isize or r2.tlen != -isize:
            return self.fault("tlen") or False
        if r1.nm + r2.nm > int(self.m * (span1 + span2)):
            return self.fault("valid") or False
        return True

    def truth_score(self, mate: int, i: int):
        """(NM, score) of read i's mate along its true path."""
        t = self.pool.truth[mate][i]
        seq = self.pool.seqs[mate][i]
        if t.reverse:
            seq = revcomp(seq)
        ops = parse_cigar(t.cigar)
        span = spans(ops)[1]
        return path_counts(seq, wildcard(t.cv, t.reverse),
                           self.g.window(t.chrom, t.start, span), ops)

    def judge(self, maps, seed: int, want: int) -> dict:
        """maps: (pool file, SAM path) of every finished map, in order.
        Judges want reads (pairs), the same number from each map."""
        rng = np.random.default_rng([seed, 0x5EED])
        mates = 2 if self.paired else 1
        n_file = min(e - s for s, e in self.files)
        picks = sample(rng, len(maps), n_file, want)
        eligible = missed = checked = 0
        for mi in sorted({m for m, _ in picks}):
            fidx, path = maps[mi]
            s, e = self.files[fidx]
            idx = [s + i for m, i in picks if m == mi]
            names = {f"{self.pool.names[j]}.{k + 1}" for j in range(s, e)
                     for k in range(mates)}
            want_names = {f"{self.pool.names[j]}.{k + 1}" for j in idx
                          for k in range(mates)}
            recs, bad = read_map(path, names, want_names, self.bam)
            for _ in range(bad):
                self.fault("name")
            for j in idx:
                got = [recs.get(f"{self.pool.names[j]}.{k + 1}", [])
                       for k in range(mates)]
                res = []
                for k in range(mates):
                    if len(got[k]) > 1:
                        res.append((False, 0, 0))
                        continue
                    if not got[k]:
                        res.append(None)
                        continue
                    checked += 1
                    res.append(self._record_ok(got[k][0], k,
                                               self.pool.seqs[k][j]))
                if (mates == 2 and res[0] and res[1] and res[0][0]
                        and res[1][0]):
                    p1, p2 = got[0][0].flag & 1, got[1][0].flag & 1
                    if p1 != p2:
                        self.fault("mate")
                        res = [(False, 0, 0)] * 2
                    elif p1 and not self._pair_ok(got[0][0], got[1][0],
                                                  res[0][2], res[1][2]):
                        res = [(False, 0, 0)] * 2
                elif mates == 2 and any(
                        x is not None and x[0] and got[k][0].flag & 1
                        for k, x in enumerate(res)):
                    self.fault("mate")  # a pair record without its mate
                    res = [(False, 0, 0) if x else x for x in res]
                for k in range(mates):
                    tnm, tscore = self.truth_score(k, j)
                    L = len(self.pool.seqs[k][j])
                    if tnm > int(self.m * L) // 2:
                        continue
                    eligible += 1
                    x = res[k]
                    if x is None or not x[0] or x[1] < tscore:
                        missed += 1
        share = missed / eligible if eligible else 1.0
        return dict(record_faults=int(sum(self.faults.values())),
                    missed_share=share, eligible=eligible, missed=missed,
                    checked=checked, faults=dict(self.faults))
