"""A plain reference of random-PBAT single-end mapping (`abismal map -R`):
each read's unique best alignment over the whole genome, by exhaustive
search, in plain torch integer arithmetic on the CPU or a card.  It
imports nothing of the program and reads nothing the program made.

The rules are upstream abismal's, as reference/check.py states them and
written again here:

- a read is tried in four encodings: forward or reverse-complemented, and
  T-rich (a T of the read matches a C or a T of the genome) or A-rich (an
  A matches an A or a G).  SEQ is written on the forward strand, so the
  reverse-complemented read of a record whose CV is T is matched with the
  A-rich wildcard, and with CV A with the T-rich one;
- a base matches when its 4-bit set meets the genome's (A=1, C=2, G=4,
  T=8, IUPAC codes their unions, N the empty set);
- a local alignment scores +2 a match, -3 a mismatch, -4 an inserted or
  deleted base, soft clips nothing; it starts where its prefix score is
  0, as upstream's traceback stops there;
- a read is reported at its best score over all encodings and offsets if
  no other alignment of that score lies more than 3 diagonals away (any
  other diagonal at the perfect score 2 len), else it is ambiguous, and
  only if the winner is valid: NM <= int(0.1 len) and it aligns at least
  max(44, int(0.6 len)) bases.

The search: the read is cut into int(0.1 len) + 1 disjoint pieces, every
genome offset where a piece matches exactly (under the encoding's
wildcard) is listed, and a local alignment is run in a band of
+-int(0.1 len) diagonals around each listed diagonal.  Departures from
upstream, and what they mean for the comparison:

- upstream lists candidates by seeds and a heap of 50 and narrows each
  band to 2 min(diffs, int(0.1 len)) + 1 diagonals, so it can miss an
  alignment that this search finds: the comparison allows a share of
  reads that this search places and upstream leaves unmapped;
- an alignment need not cover the read (soft clips are free), so a piece
  free of edits is certain only above a score: `guaranteed_score`, the
  least S such that every alignment scoring S or more holds more whole
  pieces than edits, and is valid.  A read whose best listed score lies
  below it is `unresolved` (its best might be missed), and is not
  compared;
- where two encodings tie on one diagonal upstream writes one of them;
  both are accepted here;
- the position of the winner is a range: the first genome base of every
  optimal path (ties of clip against mismatch give several).

decide() returns a Decision a read; compare() holds a map's SAM records
to them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MATCH, MISMATCH, INDEL = 2, -3, -4
MIN_READ_LENGTH = 44
VALID_LEN_FRAC = 0.6
MAX_DIFFS_FRAC = 0.1
NEAR = 3  # diagonals within this many are one place (upstream's same_pos)
PAD = 1024  # empty bases around every chromosome
NEG = -(1 << 20)
BIG = 1 << 30

# 4-bit sets of a read's bases: T-rich, A-rich
T_RICH = np.zeros(256, np.uint8)
A_RICH = np.zeros(256, np.uint8)
for _c, _t, _a in (("A", 1, 5), ("C", 2, 2), ("G", 4, 4), ("T", 10, 8)):
    T_RICH[ord(_c)], A_RICH[ord(_c)] = _t, _a
GENOME_NIB = np.zeros(256, np.uint8)
for _c, _v in zip("ACGTRYSWKMBDHVN", (1, 2, 4, 8, 5, 10, 6, 9, 12, 3, 14, 13,
                                     11, 7, 0)):
    GENOME_NIB[ord(_c)] = GENOME_NIB[ord(_c.lower())] = _v
COMP = bytes.maketrans(b"ACGT", b"TGCA")
# the four encodings: (reverse, CV, the wildcard of the matched sequence)
ENCODINGS = ((False, "T", T_RICH), (False, "A", A_RICH),
             (True, "T", A_RICH), (True, "A", T_RICH))


def revcomp(seq: bytes) -> bytes:
    return seq.translate(COMP)[::-1]


def max_diffs(L: int) -> int:
    return int(MAX_DIFFS_FRAC * L)


def min_aligned(L: int) -> int:
    return max(MIN_READ_LENGTH, int(VALID_LEN_FRAC * L))


def piece_bounds(L: int) -> list:
    """The int(0.1 L) + 1 disjoint pieces of a read of L bases."""
    n = max_diffs(L) + 1
    return [(k * L // n, (k + 1) * L // n) for k in range(n)]


def _whole_pieces(bounds, a: int) -> int:
    """The fewest pieces lying whole inside any a bases of the read."""
    L = bounds[-1][1]
    return min(sum(1 for s, e in bounds if s >= x and e <= x + a)
               for x in range(L - a + 1))


def guaranteed_score(L: int) -> int:
    """The least score S (even) such that every local alignment of a read
    of L bases scoring S or more (a) is valid and (b) holds a piece with
    no edit.  An alignment of score S with e edits aligns at least S / 2
    + 2 e query bases (all edits deletions: each costs 4 and the matches
    that pay for it) and e <= (2 L - S) / 3; an edit breaks at most one
    piece."""
    bounds = piece_bounds(L)
    best = 2 * L + 2
    for S in range(2 * L, 0, -2):
        e_max = (2 * L - S) // 3
        if e_max > max_diffs(L) or -(-S // 2) < min_aligned(L):
            break
        ok = True
        for e in range(e_max + 1):
            a = -(-S // 2) + 2 * e
            if a > L:
                break
            if _whole_pieces(bounds, a) <= e:
                ok = False
                break
        if not ok:
            break
        best = S
    return best


class PlainGenome:
    """Chromosomes laid end to end as 4-bit sets, PAD empty bases around
    each, on one device, with 32-position bit masks of every read set."""

    def __init__(self, chroms, device="cpu"):
        """chroms: [(name, bases)], bases ASCII (bytes or uint8 array), as
        the mapper sees them (short N runs already replaced)."""
        import torch

        self.names = [n for n, _ in chroms]
        parts, starts, pos = [np.zeros(PAD, np.uint8)], [], PAD
        for _, b in chroms:
            arr = GENOME_NIB[np.frombuffer(bytes(b), np.uint8)]
            starts.append(pos)
            parts += [arr, np.zeros(PAD, np.uint8)]
            pos += arr.shape[0] + PAD
        self.starts = np.array(starts, np.int64)
        self.lengths = np.array([len(b) for _, b in chroms], np.int64)
        self.dev = torch.device(device)
        nib = np.concatenate(parts)
        n = -(-nib.shape[0] // 32) * 32 + 32
        self.nib = torch.zeros(n, dtype=torch.int32, device=self.dev)
        self.nib[: nib.shape[0]] = torch.from_numpy(nib.astype(np.int32)).to(
            self.dev)
        # bit b of word j: position 32 j + b holds a base of the set
        w = torch.arange(32, device=self.dev, dtype=torch.int64)
        self.masks = torch.zeros((16, n // 32), dtype=torch.int64,
                                 device=self.dev)
        per = self.nib.reshape(-1, 32).to(torch.int64)
        for s in range(1, 16):
            hit = (per & s) != 0
            self.masks[s] = (hit.to(torch.int64) << w).sum(dim=1)

    @property
    def size(self) -> int:
        return int(self.nib.shape[0])

    def locate(self, g: int):
        """(chromosome, 0-based offset) of concatenated position g."""
        c = int(np.searchsorted(self.starts, g, side="right") - 1)
        return c, g - int(self.starts[c])

    def window(self, chrom: int, off: int, n: int):
        s = int(self.starts[chrom]) + off
        return self.nib[s : s + n]


@dataclass
class Decision:
    """A read's decision: status unique, ambiguous or unresolved (best
    below guaranteed_score, or no listed offset: a winner at or above it
    is valid); for a unique one the score, strand, the encodings
    tied there (CVs), chromosome and the range of first genome bases
    (0-based) of the optimal paths."""

    status: str
    score: int = 0
    reverse: bool = False
    cvs: tuple = ()
    chrom: int = -1
    pos_lo: int = -1
    pos_hi: int = -1


def _queries(seqs, L):
    """(n, 4, L) int32 read sets of every encoding."""
    out = np.zeros((len(seqs), 4, L), np.int32)
    for i, s in enumerate(seqs):
        rc = revcomp(s)
        for e, (rev, _cv, table) in enumerate(ENCODINGS):
            out[i, e] = table[np.frombuffer(rc if rev else s, np.uint8)]
    return out


def _listed(genome, q, bounds, mem_words):
    """Every (row, encoding, diagonal) where a piece of the row's read
    matches exactly; q (n, 4, L) int32 on the genome's device."""
    import torch

    dev = genome.dev
    n = q.shape[0]
    W = genome.masks.shape[1]
    M = torch.cat([genome.masks, torch.zeros((16, 1), dtype=torch.int64,
                                             device=dev)], dim=1)
    lo32 = (1 << 32) - 1
    nb = len(bounds)
    rows_all = torch.arange(n, device=dev).repeat_interleave(4 * nb)
    encs_all = torch.arange(4, device=dev).repeat_interleave(nb).repeat(n)
    pb = torch.tensor(bounds, device=dev).repeat(4 * n, 1)
    plen = max(t - s for s, t in bounds)
    step = max(1, mem_words // (W + 1))
    found = []
    for p0 in range(0, rows_all.shape[0], step):
        rows, encs = rows_all[p0 : p0 + step], encs_all[p0 : p0 + step]
        st, en = pb[p0 : p0 + step, 0], pb[p0 : p0 + step, 1]
        acc = torch.full((rows.shape[0], W), lo32, dtype=torch.int64,
                         device=dev)
        for i in range(plen):
            inside = st + i < en
            sets = q[rows, encs, (st + i).clamp(max=q.shape[2] - 1)].long()
            m = M[sets]
            sh = (m[:, :W] >> i) | ((m[:, 1:] << (32 - i)) & lo32) \
                if i else m[:, :W]
            acc = torch.where(inside[:, None], acc & sh, acc)
        k, w = torch.nonzero(acc, as_tuple=True)
        bits = (acc[k, w][:, None] >> torch.arange(32, device=dev)) & 1
        kk, b = torch.nonzero(bits, as_tuple=True)
        pos = w[kk] * 32 + b
        ci = k[kk]
        found.append(torch.stack([rows[ci], encs[ci], pos - st[ci]], dim=1))
    allf = torch.cat(found) if found else torch.zeros(
        (0, 3), dtype=torch.int64, device=dev)
    return torch.unique(allf, dim=0)


def _merge(v1, f1, v2, f2):
    """The larger of two (value, ranges) states; on a tie the ranges
    merged.  f: (pos_lo, pos_hi, diag_lo, diag_hi)."""
    import torch

    take2 = v2 > v1
    tie = v2 == v1
    v = torch.maximum(v1, v2)
    out = []
    for j, (a, b) in enumerate(zip(f1, f2)):
        m = torch.minimum(a, b) if j % 2 == 0 else torch.maximum(a, b)
        out.append(torch.where(take2, b, torch.where(tie, m, a)))
    return v, out


def _shift(x, s, fill):
    import torch

    out = torch.full_like(x, fill)
    out[:, s:] = x[:, : x.shape[1] - s]
    return out


def _windows(genome, q, band, w):
    """The read sets (n, L) and genome windows (n, L + 2 w) of bands (row,
    encoding, diagonal), and each band's genome position of cell (0, 0):
    cell (i, k) aligns read base i with genome base base + k + i."""
    import torch

    L = q.shape[2]
    base = band[:, 2] - w
    span = torch.arange(L + 2 * w, device=genome.dev)
    gidx = (base[:, None] + span[None, :]).clamp(0, genome.size - 1)
    return q[band[:, 0], band[:, 1]], genome.nib[gidx], base


def _band_scores(genome, q, band, w):
    """The best local score in each band, values alone: the deletions
    along a row by a running maximum of H(k) + 4 k."""
    import torch

    qs, gw, _ = _windows(genome, q, band, w)
    n, L = qs.shape
    K = 2 * w + 1
    k4 = (-INDEL) * torch.arange(K, device=genome.dev, dtype=torch.int32)
    H = torch.zeros((n, K), dtype=torch.int32, device=genome.dev)
    best = torch.zeros(n, dtype=torch.int32, device=genome.dev)
    for i in range(L):
        sub = torch.where((gw[:, i : i + K] & qs[:, i : i + 1]) != 0,
                          MATCH, MISMATCH).to(torch.int32)
        v = H + sub
        v[:, :-1] = torch.maximum(v[:, :-1], H[:, 1:] + INDEL)
        v = torch.cummax(v + k4, dim=1).values - k4
        H = v.clamp(min=0)
        best = torch.maximum(best, H.max(dim=1).values)
    return best


def _bands(genome, q, band, w):
    """Banded local alignment of each band (row, encoding, diagonal):
    (best score, pos_lo, pos_hi, diag_lo, diag_hi) a band, positions and
    diagonals absolute, over the cells that reach the best: the scores of
    _band_scores, with the ranges of the paths' first bases carried along
    (ties merged; the deletions by a doubling scan)."""
    import torch

    dev = genome.dev
    qs, gw, base = _windows(genome, q, band, w)
    n, L = qs.shape
    K = 2 * w + 1
    kk = torch.arange(K, device=dev, dtype=torch.int32)[None, :].expand(n, K)
    empty = (torch.full((n, K), BIG, dtype=torch.int32, device=dev),
             torch.full((n, K), -BIG, dtype=torch.int32, device=dev))
    H = torch.zeros((n, K), dtype=torch.int32, device=dev)
    F = [empty[0], empty[1], empty[0], empty[1]]
    best = torch.zeros(n, dtype=torch.int32, device=dev)
    bf = [empty[0][:, 0], empty[1][:, 0], empty[0][:, 0], empty[1][:, 0]]
    for i in range(L):
        sub = torch.where((gw[:, i : i + K] & qs[:, i : i + 1]) != 0,
                          MATCH, MISMATCH).to(torch.int32)
        # diagonal move; a prefix of score 0 starts the path here
        fresh = H <= 0
        vd = H + sub
        here = kk + i  # relative genome position of the cell
        fd = [torch.where(fresh, here, F[0]), torch.where(fresh, here, F[1]),
              torch.where(fresh, kk, F[2]), torch.where(fresh, kk, F[3])]
        # insertion: from (i - 1, k + 1)
        vi = torch.full_like(H, NEG)
        vi[:, :-1] = H[:, 1:] + INDEL
        fi = [_shift_left(f, e) for f, e in zip(F, (BIG, -BIG, BIG, -BIG))]
        v, f = _merge(vd, fd, vi, fi)
        # deletions along the row: a doubling scan of the -4 chain
        s = 1
        while s < K:
            vs = _shift(v, s, NEG) + INDEL * s
            fs = [_shift(x, s, e) for x, e in zip(f, (BIG, -BIG, BIG, -BIG))]
            v, f = _merge(v, f, vs, fs)
            s *= 2
        pos = v > 0
        H = torch.where(pos, v, 0)
        F = [torch.where(pos, x, e) for x, e in
             zip(f, (empty[0], empty[1], empty[0], empty[1]))]
        rm = H.max(dim=1).values
        at = H == rm[:, None]
        rf = [torch.where(at, x, e).amin(1) if j % 2 == 0
              else torch.where(at, x, e).amax(1)
              for j, (x, e) in enumerate(zip(F, (BIG, -BIG, BIG, -BIG)))]
        best, bf = _merge(best, bf, rm, rf)
    b = base.to(torch.int64)
    return (best, bf[0] + b, bf[1] + b, bf[2] + b, bf[3] + b)


def _shift_left(x, fill):
    import torch

    out = torch.full_like(x, fill)
    out[:, :-1] = x[:, 1:]
    return out


def decide(genome: PlainGenome, seqs, block_bands: int = 65536,
           mem_words: int = 1 << 25) -> list:
    """The Decision of every read in seqs (bytes, as sequenced)."""
    import torch

    out = [None] * len(seqs)
    by_len = {}
    for i, s in enumerate(seqs):
        by_len.setdefault(len(s), []).append(i)
    for L, ids in by_len.items():
        w = max_diffs(L)
        S_min = guaranteed_score(L)
        q = torch.from_numpy(_queries([seqs[i] for i in ids], L)).to(
            genome.dev)
        bands = _listed(genome, q, piece_bounds(L), mem_words)
        # the scores of every band, then the ranges of the bands that hold
        # their read's best (and could be resolved)
        sc = torch.cat([_band_scores(genome, q, bands[b0 : b0 + block_bands],
                                     w)
                        for b0 in range(0, bands.shape[0], block_bands)]
                       ) if bands.shape[0] else torch.zeros(
                           0, dtype=torch.int32, device=genome.dev)
        top = torch.zeros(len(ids), dtype=torch.int32, device=genome.dev)
        top.scatter_reduce_(0, bands[:, 0], sc, reduce="amax")
        keep = (sc == top[bands[:, 0]]) & (sc >= S_min)
        bands = bands[keep]
        res = [torch.stack(_bands(genome, q, bands[b0 : b0 + block_bands],
                                  w), dim=1).to(torch.int64)
               for b0 in range(0, bands.shape[0], block_bands)]
        res = (torch.cat(res).cpu().numpy() if res
               else np.zeros((0, 5), np.int64))
        # a read none of whose bands is kept: its best score, unresolved
        best_of = top.cpu().numpy()
        bnd = bands.cpu().numpy()
        order = np.argsort(bnd[:, 0], kind="stable")
        bnd, res = bnd[order], res[order]
        cut = np.searchsorted(bnd[:, 0], np.arange(len(ids) + 1))
        for r, i in enumerate(ids):
            out[i] = (_one(genome, bnd[cut[r] : cut[r + 1]],
                           res[cut[r] : cut[r + 1]], L)
                      if cut[r + 1] > cut[r]
                      else Decision("unresolved", score=int(best_of[r])))
    return out


def _one(genome, bnd, res, L) -> Decision:
    S = int(res[:, 0].max())
    top = res[:, 0] == S
    dlo, dhi = int(res[top, 3].min()), int(res[top, 4].max())
    if dhi - dlo > (0 if S == 2 * L else NEAR):
        return Decision("ambiguous", score=S)
    encs = sorted({int(e) for e in bnd[top, 1]})
    revs = {ENCODINGS[e][0] for e in encs}
    if len(revs) > 1:
        return Decision("ambiguous", score=S)
    lo, hi = int(res[top, 1].min()), int(res[top, 2].max())
    c, off = genome.locate(lo)
    return Decision("unique", S, revs.pop(), tuple(ENCODINGS[e][1]
                                                  for e in encs),
                    c, off, off + hi - lo)


# --- holding a map's SAM records to the decisions ---

def path_score(genome: PlainGenome, chrom: int, off: int, seq: bytes,
               table, cigar: str):
    """(score, NM) of the path cigar of seq (SAM orientation) from genome
    base off of chromosome chrom; None for a CIGAR of other operations."""
    import re

    ops = [(int(n), op) for n, op in re.findall(r"(\d+)([MIDS])", cigar)]
    if "".join(f"{n}{op}" for n, op in ops) != cigar:
        return None
    q = table[np.frombuffer(seq, np.uint8)]
    span = sum(n for n, op in ops if op in "MD")
    g = genome.window(chrom, off, span).cpu().numpy()
    qi = gi = score = nm = 0
    for n, op in ops:
        if op == "M":
            hit = int(np.count_nonzero(q[qi : qi + n] & g[gi : gi + n]))
            score += MATCH * hit + MISMATCH * (n - hit)
            nm += n - hit
            qi, gi = qi + n, gi + n
        elif op in "ID":
            score += INDEL * n
            nm += n
            qi, gi = qi + (op == "I") * n, gi + (op == "D") * n
        else:
            qi += n
    return score, nm


def sam_records(lines) -> dict:
    """name -> [fields] of the mapped records in SAM lines (bytes)."""
    recs = {}
    for line in lines:
        if line[:1] == b"@" or not line.strip():
            continue
        f = line.rstrip(b"\n").split(b"\t")
        recs.setdefault(f[0].decode(), []).append(f)
    return recs


def compare(genome: PlainGenome, names, seqs, decisions, records) -> dict:
    """Holds a map's records (sam_records) of the reads (names, seqs as
    sequenced) to their decisions: `differ` counts records that are not
    the read's unique best (strand, a CV tied there, chromosome, a first
    base of an optimal path, and a path score equal to the best) and
    reads written twice; `missed` the reads placed uniquely here that
    the map did not write; `unresolved` the reads not compared."""
    n = dict(reads=len(names), unique=0, differ=0, missed=0, unresolved=0,
             ambiguous=0, written=0)
    why = {}
    for name, seq, d in zip(names, seqs, decisions):
        got = records.get(name, [])
        n["written"] += bool(got)
        if d.status == "unresolved":
            n["unresolved"] += 1
            continue
        n["unique"] += d.status == "unique"
        n["ambiguous"] += d.status == "ambiguous"
        if not got:
            n["missed"] += d.status == "unique"
            continue
        bad = None
        if len(got) > 1:
            bad = "twice"
        elif d.status != "unique":
            bad = f"written, reference {d.status}"
        else:
            f = got[0]
            flag, pos = int(f[1]), int(f[3]) - 1
            rev, cv = bool(flag & 0x10), f[-1][-1:].decode()
            chrom = genome.names.index(f[2].decode()) \
                if f[2].decode() in genome.names else -1
            table = T_RICH if (cv == "T") != rev else A_RICH
            sc = (path_score(genome, chrom, pos, f[9], table, f[5].decode())
                  if chrom >= 0 else None)
            if rev != d.reverse or cv not in d.cvs:
                bad = "strand or conversion"
            elif chrom != d.chrom or not d.pos_lo <= pos <= d.pos_hi:
                bad = "position"
            elif f[9] != (revcomp(seq) if rev else seq):
                bad = "sequence"
            elif sc is None or sc[0] != d.score:
                bad = "score"
        if bad:
            n["differ"] += 1
            why[bad] = why.get(bad, 0) + 1
    n["why"] = why
    return n
