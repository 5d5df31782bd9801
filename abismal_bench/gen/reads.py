"""The benchmark's read simulator: WGBS reads or pairs of a directional,
PBAT or random-PBAT library with their true alignments, from two seeds: the cell's traffic seed and the
run's.

The cell's own traffic seed gives the fragments (fragments: one in each
of as many equal strata of the genome as the pool has reads or pairs,
its strand + or -, for OT / OB of directional libraries) and their
mutations; the run's seed gives their order in the pool files and the
bisulfite conversion.  So every run of a cell maps the same set of
fragments, in another order: a few fragments in the genome's tandem
repeats, mutated one way or another, can take a large share of the
native engine's time, and that share must not swing from seed to seed.
The strand's sequence is mutated base by base (a mutation with
probability mutation_rate, then a substitution by a random base, an
insertion of one or a deletion, in the ratio sub_ins_del: upstream
abismal's `sim -m`), and then bisulfite-converted, each C to a T with
probability bs_conv.  Mate 1 is the first read_length bases, mate 2 the
reverse complement of the last read_length; a fragment whose mutated
sequence is shorter than read_length is mutated again.  Names and quality
strings follow upstream's `sim` (readN.1 / readN.2, all 'B').

Each mate's truth is where its bases came from, as a SAM record would
give it: chromosome, first reference base (0-based), reverse strand,
conversion (T: C->T on the read, A: G->A) and CIGAR (M, I, D)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_COMP = np.full(256, ord("N"), np.uint8)
for _a, _b in (b"AT", b"CG", b"GC", b"TA"):
    _COMP[_a] = _b
_ACGT = np.zeros(256, bool)
_ACGT[list(b"ACGT")] = True


_COMP_B = bytes(_COMP.tolist())


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP_B)[::-1]


@dataclass
class Mate:
    """One mate's truth, SAM-oriented."""

    chrom: int
    start: int  # 0-based first reference base
    reverse: bool
    cv: str  # "T" or "A"
    cigar: str


@dataclass
class Pool:
    """The simulated reads: names, mates' sequences (read orientation),
    and each mate's truth (mates[m][i])."""

    names: list
    seqs: list  # [mate 1 seqs] or [mate 1 seqs, mate 2 seqs], bytes
    truth: list  # per mate: list of Mate

    @property
    def n(self) -> int:
        return len(self.names)


def _cigar(runs) -> str:
    if len(runs) == 1:
        return f"{runs[0][1]}{runs[0][0]}"
    out = []
    for op, c in runs:
        if out and out[-1][0] == op:
            out[-1][1] += c
        elif c:
            out.append([op, c])
    return "".join(f"{c}{op}" for op, c in out)


def _take_prefix(runs, emitted: int):
    """The op runs that emit the first `emitted` bases, leading and
    trailing D dropped: (runs, source bases consumed, leading Ds)."""
    out, n, src = [], 0, 0
    for op, c in runs:
        if n == emitted:
            break
        if op == "D":
            out.append((op, c))
            src += c
            continue
        c = min(c, emitted - n)
        out.append((op, c))
        n += c
        if op == "M":
            src += c
    lead = 0
    while out and out[0][0] == "D":
        lead += out[0][1]
        src -= out[0][1]
        out.pop(0)
    return out, src, lead


def _mutate(src: bytes, hits, kind, rbase):
    """src mutated at the draws hits (kind: 0 substitution, 1 insertion,
    2 deletion; rbase the random base of each): (emitted bytes, op
    runs).  Draw k acts on the source base that the draws before it
    leave next; an insertion takes no source base."""
    L = len(src)
    emit, runs = [], []
    si = prev = 0

    def add(op, c):
        if runs and runs[-1][0] == op:
            runs[-1][1] += c
        else:
            runs.append([op, c])

    for k, kd, b in zip(hits, kind, rbase):
        run = min(k - prev, L - si)
        if run > 0:
            emit.append(src[si : si + run])
            add("M", run)
            si += run
        if si >= L:
            break
        if kd == 0:
            emit.append(bytes((b,)))
            add("M", 1)
            si += 1
        elif kd == 1:
            emit.append(bytes((b,)))
            add("I", 1)
        else:
            add("D", 1)
            si += 1
        prev = k + 1
    if si < L:
        emit.append(src[si:])
        add("M", L - si)
    return b"".join(emit), runs


MAX_TRIES = 64  # draws in a stratum before a draw anywhere


def fragments(genome, n: int, traffic_seed: int, frag_min: int,
              frag_max: int, batch: int = 8192):
    """The pool's fragments, one a stratum: the genome cut into n equal
    strata, a fragment of a length uniform in [frag_min, frag_max]
    starting uniformly in its stratum, drawn again there while it leaves
    its chromosome or holds a base other than A, C, G or T; its strand + or
    - with equal chance.  From the cell's traffic_seed alone: every run of
    a cell maps the same set of fragments, so the work that a seed gives
    does not swing with how many fragments fall into the genome's tandem
    repeats (see the module's docstring).  Returns (chrom, off, flen, minus, bases (n, frag_max))."""
    rng = np.random.default_rng(traffic_seed)
    width = genome.size / n
    F = frag_max
    chrom = np.zeros(n, np.int64)
    off = np.zeros(n, np.int64)
    flen = np.zeros(n, np.int64)
    bases = np.zeros((n, F), np.uint8)
    for b0 in range(0, n, batch):
        pending = np.arange(b0, min(n, b0 + batch))
        tries = 0
        while pending.size:
            m = pending.size
            fl = rng.integers(frag_min, frag_max + 1, size=m)
            if tries < MAX_TRIES:
                g = ((pending + rng.random(m)) * width).astype(np.int64)
            else:
                g = rng.integers(0, genome.size, size=m)
            g = np.minimum(g, genome.size - 1)
            tries += 1
            c = np.searchsorted(genome.cum, g, side="right") - 1
            o = g - genome.cum[c]
            fr = genome.take(c, o[:, None] + np.arange(F)[None])
            ok = (o + fl <= genome.lengths[c]) & np.all(
                _ACGT[fr] | (np.arange(F)[None] >= fl[:, None]), axis=1)
            k = pending[ok]
            chrom[k], off[k], flen[k], bases[k] = c[ok], o[ok], fl[ok], fr[ok]
            pending = pending[~ok]
    minus = rng.random(n) < 0.5
    return chrom, off, flen, minus, bases


def order(n: int, groups: int, rng) -> np.ndarray:
    """The fragment of each pool index: group f of the pool (its f-th
    contiguous n / groups, one pool file) holds the fragments j = f mod
    groups, in an order drawn from the seed, so that every file covers the
    genome alike."""
    j = np.arange(n)
    return np.concatenate([rng.permutation(j[j % groups == f])
                           for f in range(groups)])


def _mutated(bases, flen, minus, read_length, mutation_rate, sub_ins_del,
             rng, batch: int = 8192):
    """Each fragment's strand sequence, mutated: (emitted bytes, op runs)
    a fragment; one shorter than read_length is mutated again."""
    n, F = bases.shape
    sid = np.asarray(sub_ins_del, float)
    sid = np.cumsum(sid / sid.sum())
    acgt = np.frombuffer(b"ACGT", np.uint8)
    emits, runs_of = [None] * n, [None] * n
    for b0 in range(0, n, batch):
        pending = np.arange(b0, min(n, b0 + batch))
        while pending.size:
            m = pending.size
            # the draws that mutate, by fragment, with their kind and base;
            # a fragment of L bases takes fewer than 2 L draws
            hr, hc = np.nonzero(rng.random((m, 2 * F)) <= mutation_rate)
            kind = np.searchsorted(sid, rng.random(hr.size), side="right")
            rbase = acgt[rng.integers(0, 4, hr.size)]
            used = hc < 2 * flen[pending][hr]
            hr, hc, kind, rbase = hr[used], hc[used], kind[used], rbase[used]
            first = np.searchsorted(hr, np.arange(m + 1))
            done = np.zeros(m, bool)
            for i in range(m):
                j = int(pending[i])
                L = int(flen[j])
                src = bases[j, :L].tobytes()
                if minus[j]:
                    src = src.translate(_COMP_B)[::-1]
                a, b = first[i], first[i + 1]
                if a == b:
                    emit, runs = src, [["M", L]]
                else:
                    emit, runs = _mutate(src, hc[a:b].tolist(),
                                         kind[a:b].tolist(),
                                         rbase[a:b].tolist())
                if len(emit) >= read_length:
                    emits[j], runs_of[j], done[i] = emit, runs, True
            pending = pending[~done]
    return emits, runs_of


PROTOCOLS = ("directional", "pbat", "random_pbat")


def simulate(genome, n: int, seed: int, read_length: int, frag_min: int,
             frag_max: int, mutation_rate: float, sub_ins_del, bs_conv: float,
             paired: bool, groups: int = 1, traffic_seed: int = 0,
             protocol: str = "directional") -> Pool:
    """n reads (paired: n pairs) from genome (gen.fasta.Genome).  The
    fragments and their mutations come from traffic_seed (fragments,
    _mutated); seed draws their order (order) and the conversion.  The
    library's protocol: directional, mate 1 the converted strand's head
    (T-rich); pbat, mate 1 the reverse complement of its tail (A-rich),
    and mate 2 its head (a single-end read is mate 1); random_pbat, each
    fragment one or the other with equal chance, from traffic_seed."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"protocol {protocol!r}: one of {PROTOCOLS}")
    chrom, off, flen, minus, bases = fragments(genome, n, traffic_seed,
                                               frag_min, frag_max)
    emits, runs_of = _mutated(bases, flen, minus, read_length, mutation_rate,
                              sub_ins_del,
                              np.random.default_rng([traffic_seed, 1]))
    swap = np.full(n, protocol == "pbat")
    if protocol == "random_pbat":
        swap = np.random.default_rng([traffic_seed, 2]).random(n) < 0.5
    rng = np.random.default_rng(seed)
    which = order(n, groups, rng)
    RL = read_length
    # bisulfite conversion of every emitted C, the pool at once
    lens = np.fromiter((len(emits[j]) for j in which), np.int64, n)
    flat = np.frombuffer(b"".join(emits[j] for j in which), np.uint8).copy()
    flat[(flat == ord("C")) & (rng.random(flat.size) < bs_conv)] = ord("T")
    conv = flat.tobytes()
    ends = np.cumsum(lens).tolist()
    seqs = [[None] * n for _ in range(2 if paired else 1)]
    truth = [[None] * n for _ in range(2 if paired else 1)]
    for k in range(n):
        j = int(which[k])
        e1 = ends[k]
        e0 = e1 - int(lens[k])
        runs = runs_of[j]
        o1, c1, d1 = _take_prefix(runs, RL)
        o2, c2, d2 = _take_prefix(runs[::-1], RL)
        o2 = o2[::-1]
        c = int(chrom[j])
        f0 = int(off[j])
        f1 = f0 + int(flen[j])
        if not minus[j]:
            m1 = Mate(c, f0 + d1, False, "T", _cigar(o1))
            m2 = Mate(c, f1 - d2 - c2, True, "A", _cigar(o2))
        else:
            m1 = Mate(c, f1 - d1 - c1, True, "T", _cigar(o1[::-1]))
            m2 = Mate(c, f0 + d2, False, "A", _cigar(o2[::-1]))
        s1 = conv[e0 : e0 + RL]
        s2 = conv[e1 - RL : e1].translate(_COMP_B)[::-1]
        if swap[j]:
            s1, s2, m1, m2 = s2, s1, m2, m1
        seqs[0][k], truth[0][k] = s1, m1
        if paired:
            seqs[1][k], truth[1][k] = s2, m2
    return Pool([f"read{i}" for i in range(n)], seqs, truth)


def write_fastq(path: str, names, seqs, mate: int) -> None:
    """One FASTQ of the reads, named as upstream's sim names them."""
    with open(path, "wb") as f:
        f.write(b"".join(
            b"@%s.%d\n%s\n+\n%s\n" % (nm.encode(), mate, s,
                                      b"B" * len(s))
            for nm, s in zip(names, seqs)))
