"""The `map` command's loop and the exact host engine (↔ abismal_tpu/map/
engine.py; reference abismal.cpp:1435-2504).

MappingEngine is a sequential re-implementation of the reference mapper's
semantics (identical candidate collection, tie-breaking, ambiguity,
alignment and output decisions, so byte-identical SAM and mstats): the
exact engine (`--engine exact`) and the base of the replay engines of
map/pipeline.py, which take its candidates from the device.

run_map runs an engine factory's engine: one built on the native C++
library (factory.is_native: the pure-native engine, TorchNativeEngine)
through the dispatch/finish loop of run_map_pipelined; any other through
a sequential loop, or with threads > 1 through map/runner.py (a replay
factory, factory.is_replay, through run_map_hybrid; the exact engine
through run_map_parallel)."""

from __future__ import annotations

import sys
import time

from ..constants import (
    BSFLAG_A_RICH,
    INVALID_HIT_FRAC,
    MAX_DIFFS_SENTINEL,
    MIN_READ_LENGTH,
    PE_MAX_DIST_DEFAULT,
    PE_MIN_DIST_DEFAULT,
    SAM_MATE_RC,
    SAM_PAIR_MAPPED,
    SAM_PAIRED,
    SAM_RC,
    SAM_SECONDARY,
    SAM_TEMPLATE_FIRST,
    SAM_TEMPLATE_LAST,
    SAME_POS_TOLERANCE,
    VALID_FRAC_DEFAULT,
)
from ..io.fastq import ReadLoader
from ..io.sam import (
    cigar_rseq_ops, format_sam_record, make_sam_header, open_sam_output,
)
from ..utils.dna import revcomp_str
from .align import (
    BandedAligner,
    best_pair_score,
    best_single_score,
    edit_distance,
    make_default_cigar,
)
from .candidates import (
    D,
    F,
    P,
    PECandidates,
    SECandidates,
    elem_empty,
    elem_is_ambig,
    set_ambig,
)
from .host_units import strand_code
from .native_engine import run_map_pipelined
from .seeds import SeedIndexView, pack_read, prep_read, process_seeds
from .stats import PEStats, SEStats, stats_to_json

MAP_UNMAPPED, MAP_UNIQUE, MAP_AMBIG = 0, 1, 2


def valid_diffs_cutoff(readlen: int, cutoff: float) -> int:
    return int(cutoff * readlen)


def valid_len(aln_len: int, readlen: int) -> bool:
    min_aln_frac = 1.0 - INVALID_HIT_FRAC
    return aln_len >= max(MIN_READ_LENGTH, int(min_aln_frac * readlen))


def check_valid(diffs: int, aln_len: int, readlen: int,
                cutoff: float) -> bool:
    return valid_len(aln_len, readlen) and diffs <= valid_diffs_cutoff(
        readlen, cutoff
    )


def valid_hit(diffs: int, readlen: int) -> bool:
    return diffs < int(INVALID_HIT_FRAC * readlen)


def same_pos(p1: int, p2: int) -> bool:
    return abs(p1 - p2) <= SAME_POS_TOLERANCE


def _pick_pread(e, pread_t, pread_t_rc, pread_a, pread_a_rc):
    """Query encoding selection by hit flags (abismal.cpp:1461-1465)."""
    if e[F] & SAM_RC:
        return pread_t_rc if (e[F] & BSFLAG_A_RICH) else pread_a_rc
    return pread_a if (e[F] & BSFLAG_A_RICH) else pread_t


def align_se_candidates(pread_t, pread_t_rc, pread_a, pread_a_rc,
                        cutoff: float, res: SECandidates,
                        aln: BandedAligner):
    """abismal.cpp:1435-1497.  Returns (best_element, cigar_list)."""
    readlen = int(pread_t.shape[0])
    max_diffs = valid_diffs_cutoff(readlen, cutoff)
    max_scr = best_single_score(readlen)
    if res.has_exact_match():
        return list(res.best), make_default_cigar(readlen)

    best = [MAX_DIFFS_SENTINEL, 0, 0]
    best_scr = 0
    best_pos = 0
    els = res.prepare_for_alignments()
    i = 0
    while i < len(els) and elem_empty(els[i]):
        i += 1
    for e in els[i:]:
        if valid_hit(e[D], readlen):
            cand_pos = e[P]
            q = _pick_pread(e, pread_t, pread_t_rc, pread_a, pread_a_rc)
            cand_scr = aln.align(e[D], max_diffs, q, cand_pos, False)
            if cand_scr > best_scr:
                best = list(e)
                best_scr = cand_scr
                best_pos = cand_pos
            elif cand_scr == best_scr and (
                cand_pos != best_pos if cand_scr == max_scr
                else not same_pos(cand_pos, best_pos)
            ):
                set_ambig(best)

    cigar = []
    if best[P] != 0:
        q = _pick_pread(best, pread_t, pread_t_rc, pread_a, pread_a_rc)
        aln.align(best[D], max_diffs, q, best[P], True)
        cigar, aln_len, new_pos = aln.build_cigar_len_and_pos(
            best[D], max_diffs, best[P]
        )
        best[P] = new_pos
        best[D] = edit_distance(best_scr, aln_len, cigar)
        if not check_valid(best[D], aln_len, readlen, cutoff):
            best = [MAX_DIFFS_SENTINEL, best[F], 0]
    else:
        best = [MAX_DIFFS_SENTINEL, best[F], 0]
    return best, cigar


class PEBest:
    """pe_element (abismal.cpp:547-622)."""

    def __init__(self, readlen1: int, readlen2: int):
        self.aln_score = 0
        self.r1 = [int(INVALID_HIT_FRAC * readlen1), 0, 0]
        self.r2 = [int(INVALID_HIT_FRAC * readlen2), 0, 0]
        self.max_aln_score = best_pair_score(readlen1, readlen2)

    def reset(self):
        self.aln_score = 0
        self.r1 = [MAX_DIFFS_SENTINEL, self.r1[F], 0]
        self.r2 = [MAX_DIFFS_SENTINEL, self.r2[F], 0]

    def update(self, scr: int, s1, s2) -> bool:
        rd = self.r1[D] + self.r2[D]
        sd = s1[D] + s2[D]
        if scr > self.aln_score or (scr == self.aln_score and sd < rd):
            self.r1 = list(s1)
            self.r2 = list(s2)
            self.aln_score = scr
            return True
        if scr == self.aln_score and sd == rd:
            set_ambig(self.r1)
        return False

    def ambig(self) -> bool:
        return elem_is_ambig(self.r1)

    def empty(self) -> bool:
        return elem_empty(self.r1)

    def sure_ambig(self) -> bool:
        return self.ambig() and self.aln_score == self.max_aln_score

    def should_report(self, allow_ambig: bool) -> bool:
        return not self.empty() and (allow_ambig or not self.ambig())


class MappingEngine:
    """Sequential exact mapper over an AbismalIndex."""

    def __init__(self, index, allow_ambig=False, valid_frac=VALID_FRAC_DEFAULT,
                 pe_min_dist=PE_MIN_DIST_DEFAULT,
                 pe_max_dist=PE_MAX_DIST_DEFAULT):
        self.view = SeedIndexView(index)
        self.cl = index.cl
        self.allow_ambig = allow_ambig
        self.valid_frac = valid_frac
        self.pe_min_dist = pe_min_dist
        self.pe_max_dist = pe_max_dist
        self.aln = BandedAligner(self.view.nib)

    # ---- hooks for accelerated engines (overridden by the TPU pipeline) ----
    def _prepare_batch_se(self, reads, a_rich_mode, random_pbat):
        pass

    def _prepare_batch_pe(self, reads1, reads2, a_rich_mode, random_pbat):
        pass

    def _seeds(self, pread, sc, res, key=None):
        process_seeds(self.view, pread, pack_read(pread), sc, res)

    # ------------------------------------------------------------------ SE
    def _format_se(self, best, cigar, name: str, read: bytes):
        """abismal.cpp:481-545.  Returns (map_type, sam_line_or_None)."""
        ambig = elem_is_ambig(best)
        valid = not elem_empty(best)
        if not self.allow_ambig and ambig:
            return MAP_AMBIG, None
        if not valid:
            return MAP_UNMAPPED, None
        ref_ops = cigar_rseq_ops(cigar)
        ok, chrom_idx, r_s = self.cl.get_chrom_idx_and_offset_checked(
            best[P], ref_ops
        )
        if not ok:
            return MAP_UNMAPPED, None
        flag = 0
        seq = read.decode()
        if best[F] & SAM_RC:
            flag |= SAM_RC
            seq = revcomp_str(seq)
        if self.allow_ambig and ambig:
            flag |= SAM_SECONDARY
        line = format_sam_record(
            name, flag, self.cl.names[chrom_idx], r_s + 1, cigar, "*", 0, 0,
            seq, best[D], "A" if best[F] & BSFLAG_A_RICH else "T",
        )
        return (MAP_AMBIG if ambig else MAP_UNIQUE), line

    def map_se_reads(self, reads, a_rich_mode: bool, random_pbat: bool,
                     stats: SEStats, out):
        """One batch of (name, read); writes SAM lines to `out`
        (abismal.cpp:1511-1704)."""
        self._prepare_batch_se(reads, a_rich_mode, random_pbat)
        max_len = max((len(r) for _, r in reads), default=0)
        self.aln.reset(max(max_len, 1))
        res = SECandidates()
        for ri, (name, read) in enumerate(reads):
            res.reset(len(read))
            best = [MAX_DIFFS_SENTINEL, 0, 0]
            cigar = []
            if read:
                if not random_pbat:
                    conv = a_rich_mode
                    pread = prep_read(read, conv)
                    self._seeds(pread, strand_code("+", conv), res,
                                (ri, "f", conv))
                    read_rc = revcomp_str(read.decode()).encode()
                    pread_rc = prep_read(read_rc, not conv)
                    self._seeds(pread_rc, strand_code("-", conv),
                                res, (ri, "r", not conv))
                    best, cigar = align_se_candidates(
                        pread, pread_rc, pread, pread_rc, self.valid_frac,
                        res, self.aln,
                    )
                else:
                    # 4-way RPBAT orchestration (abismal.cpp:1602-1704)
                    pread_t = prep_read(read, False)
                    self._seeds(pread_t, strand_code("+", False), res,
                                (ri, "f", False))
                    pread_a = prep_read(read, True)
                    self._seeds(pread_a, strand_code("+", True), res,
                                (ri, "f", True))
                    read_rc = revcomp_str(read.decode()).encode()
                    pread_t_rc = prep_read(read_rc, False)
                    self._seeds(pread_t_rc, strand_code("-", True), res,
                                (ri, "r", False))
                    pread_a_rc = prep_read(read_rc, True)
                    self._seeds(pread_a_rc, strand_code("-", False), res,
                                (ri, "r", True))
                    best, cigar = align_se_candidates(
                        pread_t, pread_t_rc, pread_a, pread_a_rc,
                        self.valid_frac, res, self.aln,
                    )
                map_type, line = self._format_se(best, cigar, name, read)
                if map_type == MAP_UNMAPPED:
                    best = [MAX_DIFFS_SENTINEL, best[F], 0]
                if line is not None:
                    out.write(line)
            stats.update(
                read_empty=(len(read) == 0),
                valid=not elem_empty(best),
                ambig=elem_is_ambig(best),
                diffs=best[D], cigar=cigar,
                count_ambig_err=self.allow_ambig,
            )

    # ------------------------------------------------------------------ PE
    def _best_pair(self, res1: PECandidates, res2: PECandidates,
                   pread1, pread2, mem_scr1, best: PEBest, swap_ends: bool):
        """Concordance sweep with memoized end-1 scores
        (abismal.cpp:1722-1831).  Returns (cigar1, cigar2) or None."""
        aln = self.aln
        v1 = res1.v
        v2 = res2.v
        n1 = res1.sz
        n2 = res2.sz
        readlen1 = int(pread1.shape[0]) if pread1 is not None else 0
        readlen2 = int(pread2.shape[0]) if pread2 is not None else 0
        max_diffs1 = valid_diffs_cutoff(readlen1, self.valid_frac)
        max_diffs2 = valid_diffs_cutoff(readlen2, self.valid_frac)
        for k in range(n1):
            mem_scr1[k] = 0

        scr1 = 0
        best_scr1 = best_scr2 = 0
        best_pos1 = best_pos2 = 0

        j1 = 0
        while j1 != n1 and elem_empty(v1[j1]):
            j1 += 1
        j2 = 0
        while j2 != n2 and elem_empty(v2[j2]):
            j2 += 1

        max_dist = self.pe_max_dist
        min_dist = self.pe_min_dist
        while j2 != n2 and not best.sure_ambig():
            s2 = v2[j2]
            scr2 = 0
            lim = s2[P] + readlen2
            # rewind to the first possibly-concordant end-1 candidate
            while j1 == n1 or (j1 != 0 and v1[j1][P] + max_dist >= lim):
                j1 -= 1
            while j1 != n1 and v1[j1][P] + max_dist < lim:
                j1 += 1
            while (j1 != n1 and v1[j1][P] + min_dist <= lim
                   and not best.sure_ambig()):
                s1 = v1[j1]
                if scr2 == 0:
                    scr2 = aln.align(s2[D], max_diffs2, pread2, s2[P], False)
                if mem_scr1[j1] == 0:
                    scr1 = aln.align(s1[D], max_diffs1, pread1, s1[P], False)
                    mem_scr1[j1] = scr1
                pair_scr = scr2 + mem_scr1[j1]
                updated = (best.update(pair_scr, s2, s1) if swap_ends
                           else best.update(pair_scr, s1, s2))
                if updated:
                    # NB: scr1 may be stale when the memo was hit -- the
                    # reference stores the last *computed* score
                    # (abismal.cpp:1793-1799)
                    best_scr1 = scr1
                    best_scr2 = scr2
                    best_pos1 = s1[P]
                    best_pos2 = s2[P]
                j1 += 1
            j2 += 1

        if best_pos1 == 0:
            return None

        s1 = list(best.r2 if swap_ends else best.r1)
        s2 = list(best.r1 if swap_ends else best.r2)

        aln.align(s1[D], max_diffs1, pread1, best_pos1, True)
        cigar1, len1, best_pos1 = aln.build_cigar_len_and_pos(
            s1[D], max_diffs1, best_pos1
        )
        s1[P] = best_pos1
        s1[D] = edit_distance(best_scr1, len1, cigar1)

        aln.align(s2[D], max_diffs2, pread2, best_pos2, True)
        cigar2, len2, best_pos2 = aln.build_cigar_len_and_pos(
            s2[D], max_diffs2, best_pos2
        )
        s2[P] = best_pos2
        s2[D] = edit_distance(best_scr2, len2, cigar2)

        frag_end = best_pos2 + len2
        if (frag_end >= best_pos1 + min_dist
                and frag_end <= best_pos1 + max_dist):
            best.r1 = s2 if swap_ends else s1
            best.r2 = s1 if swap_ends else s2
        else:
            best.reset()
        return cigar1, cigar2

    @staticmethod
    def _best_single(pres: PECandidates, res: SECandidates):
        """Feed PE candidates into the SE fallback set
        (abismal.cpp:1715-1720)."""
        for k in range(pres.sz):
            if res.sure_ambig:
                break
            e = pres.v[k]
            res.update(False, e[D], e[F], e[P])

    def _map_fragments(self, read1: bytes, read2: bytes, conv_a_rich: bool,
                       swap_ends: bool, sc1: int, sc2: int,
                       res1: PECandidates, res2: PECandidates, mem_scr1,
                       res_se1: SECandidates, res_se2: SECandidates,
                       best: PEBest, cigars, keys=(None, None)):
        """abismal.cpp:1849-1885.  Returns (success, pread1, pread2_rc);
        cigars is a 2-slot list updated when a new best pair is found."""
        res1.reset(len(read1))
        res2.reset(len(read2))
        if not read1 and not read2:
            return False, None, None
        pread1 = pread2 = None
        if read1:
            pread1 = prep_read(read1, conv_a_rich)
            self._seeds(pread1, sc1, res1, keys[0])
        if read2:
            rc = revcomp_str(read2.decode()).encode()
            pread2 = prep_read(rc, conv_a_rich)
            self._seeds(pread2, sc2, res2, keys[1])
        # select_maps (abismal.cpp:1833-1847); runs even when one read is
        # empty (that side's set holds only its sentinel, so the sweep
        # no-ops, but the sorting still affects best_single's input order)
        if res1.should_align() and res2.should_align():
            res1.prepare_for_mating()
            res2.prepare_for_mating()
            new_cigars = self._best_pair(
                res1, res2, pread1, pread2, mem_scr1, best, swap_ends
            )
            if new_cigars is not None:
                cigars[0], cigars[1] = new_cigars
        self._best_single(res1, res_se1)
        self._best_single(res2, res_se2)
        return True, pread1, pread2

    def _format_pe(self, best: PEBest, cigars, name1, name2, read1, read2):
        """abismal.cpp:648-773.  Returns (map_type, line1, line2)."""
        if best.empty():
            return MAP_UNMAPPED, None, None
        ambig = best.ambig()
        if not self.allow_ambig and ambig:
            return MAP_AMBIG, None, None
        cig1, cig2 = cigars
        ok1, chr1, r_s1 = self.cl.get_chrom_idx_and_offset_checked(
            best.r1[P], cigar_rseq_ops(cig1)
        )
        ok2, chr2, r_s2 = self.cl.get_chrom_idx_and_offset_checked(
            best.r2[P], cigar_rseq_ops(cig2)
        )
        if not ok1 or not ok2 or chr1 != chr2:
            return MAP_UNMAPPED, None, None
        r_e1 = r_s1 + cigar_rseq_ops(cig1)
        r_e2 = r_s2 + cigar_rseq_ops(cig2)
        rc = bool(best.r1[F] & SAM_RC)
        isize = (r_s1 - r_e2) if rc else (r_e2 - r_s1)

        flag1 = SAM_PAIRED | SAM_PAIR_MAPPED
        flag2 = SAM_PAIRED | SAM_PAIR_MAPPED
        seq1 = read1.decode()
        seq2 = read2.decode()
        if best.r1[F] & SAM_RC:
            flag1 |= SAM_RC
            flag2 |= SAM_MATE_RC
            seq1 = revcomp_str(seq1)
        if best.r2[F] & SAM_RC:
            flag2 |= SAM_RC
            flag1 |= SAM_MATE_RC
            seq2 = revcomp_str(seq2)
        if self.allow_ambig and ambig:
            flag1 |= SAM_SECONDARY
            flag2 |= SAM_SECONDARY
        flag1 |= SAM_TEMPLATE_FIRST
        flag2 |= SAM_TEMPLATE_LAST

        rname = self.cl.names[chr1]
        line1 = format_sam_record(
            name1, flag1, rname, r_s1 + 1, cig1, "=", r_s2 + 1, isize, seq1,
            best.r1[D], "A" if best.r1[F] & BSFLAG_A_RICH else "T",
        )
        line2 = format_sam_record(
            name2, flag2, rname, r_s2 + 1, cig2, "=", r_s1 + 1, -isize, seq2,
            best.r2[D], "A" if best.r2[F] & BSFLAG_A_RICH else "T",
        )
        return (MAP_AMBIG if ambig else MAP_UNIQUE), line1, line2

    def map_pe_reads(self, reads1, reads2, a_rich_mode: bool,
                     random_pbat: bool, stats: PEStats, out):
        """One batch of paired reads (abismal.cpp:1887-2185)."""
        if len(reads1) != len(reads2):
            raise RuntimeError(
                f"paired-end batch sizes differ. Batch 1: {len(reads1)}, "
                f"batch 2: {len(reads2)}. Are you sure your paired-end "
                "inputs have the same number of reads?"
            )
        self._prepare_batch_pe(reads1, reads2, a_rich_mode, random_pbat)
        max_len = max(
            max((len(r) for _, r in reads1), default=0),
            max((len(r) for _, r in reads2), default=0),
        )
        self.aln.reset(max(max_len, 1))
        res1 = PECandidates()
        res2 = PECandidates()
        mem_scr1 = [0] * len(res1.v)
        res_se1 = SECandidates()
        res_se2 = SECandidates()

        for ri, ((name1, read1), (name2, read2)) in enumerate(
                zip(reads1, reads2)):
            l1, l2 = len(read1), len(read2)
            res_se1.reset(l1)
            res_se2.reset(l2)
            best = PEBest(l1, l2)
            cigars = [[], []]

            if not random_pbat:
                conv = a_rich_mode
                ok_pm, pread1, pread2_rc = self._map_fragments(
                    read1, read2, conv, False,
                    strand_code("+", conv), strand_code("-", not conv),
                    res1, res2, mem_scr1, res_se1, res_se2, best, cigars,
                    keys=((ri, 1, "f", conv), (ri, 2, "r", conv)),
                )
                ok_mp, pread2, pread1_rc = self._map_fragments(
                    read2, read1, not conv, True,
                    strand_code("+", not conv), strand_code("-", conv),
                    res2, res1, mem_scr1, res_se2, res_se1, best,
                    cigars_swapped(cigars),
                    keys=((ri, 2, "f", not conv), (ri, 1, "r", not conv)),
                )
                preads1 = (pread1, pread1_rc, pread1, pread1_rc)
                preads2 = (pread2, pread2_rc, pread2, pread2_rc)
                any_ok = ok_pm or ok_mp
            else:
                # 4-way RPBAT (abismal.cpp:2031-2185)
                ok1, pread1_t, pread2_t_rc = self._map_fragments(
                    read1, read2, False, False,
                    strand_code("+", False), strand_code("-", True),
                    res1, res2, mem_scr1, res_se1, res_se2, best, cigars,
                    keys=((ri, 1, "f", False), (ri, 2, "r", False)),
                )
                ok2, pread2_a, pread1_a_rc = self._map_fragments(
                    read2, read1, True, True,
                    strand_code("+", True), strand_code("-", False),
                    res2, res1, mem_scr1, res_se2, res_se1, best,
                    cigars_swapped(cigars),
                    keys=((ri, 2, "f", True), (ri, 1, "r", True)),
                )
                ok3, pread1_a, pread2_a_rc = self._map_fragments(
                    read1, read2, True, False,
                    strand_code("+", True), strand_code("-", False),
                    res1, res2, mem_scr1, res_se1, res_se2, best, cigars,
                    keys=((ri, 1, "f", True), (ri, 2, "r", True)),
                )
                ok4, pread2_t, pread1_t_rc = self._map_fragments(
                    read2, read1, False, True,
                    strand_code("+", False), strand_code("-", True),
                    res2, res1, mem_scr1, res_se2, res_se1, best,
                    cigars_swapped(cigars),
                    keys=((ri, 2, "f", False), (ri, 1, "r", False)),
                )
                preads1 = (pread1_t, pread1_t_rc, pread1_a, pread1_a_rc)
                preads2 = (pread2_t, pread2_t_rc, pread2_a, pread2_a_rc)
                any_ok = ok1 or ok2 or ok3 or ok4

            if not any_ok:
                best.reset()
                res_se1.reset_plain()
                res_se2.reset_plain()

            # valid_pair check (abismal.cpp:624-631,1987-1989)
            if not (
                valid_len(cigar_rseq_ops(cigars[0]), l1)
                and valid_len(cigar_rseq_ops(cigars[1]), l2)
                and best.r1[D] + best.r2[D] <= int(
                    self.valid_frac
                    * (cigar_rseq_ops(cigars[0]) + cigar_rseq_ops(cigars[1]))
                )
            ):
                best.reset()

            best_se1 = [MAX_DIFFS_SENTINEL, 0, 0]
            best_se2 = [MAX_DIFFS_SENTINEL, 0, 0]
            cig_se1 = []
            cig_se2 = []
            if not best.should_report(self.allow_ambig):
                best_se1, cig_se1 = self._align_se_fallback(
                    preads1, res_se1, l1
                )
                best_se2, cig_se2 = self._align_se_fallback(
                    preads2, res_se2, l2
                )
                cigars[0], cigars[1] = cig_se1, cig_se2

            # select_output (abismal.cpp:1073-1088)
            pe_type, line1, line2 = self._format_pe(
                best, cigars, name1, name2, read1, read2
            )
            se_lines = []
            if (not best.should_report(self.allow_ambig)
                    or pe_type == MAP_UNMAPPED):
                if pe_type == MAP_UNMAPPED:
                    best.reset()
                t1, sline1 = self._format_se(best_se1, cig_se1, name1, read1)
                if t1 == MAP_UNMAPPED:
                    best_se1 = [MAX_DIFFS_SENTINEL, best_se1[F], 0]
                if sline1 is not None:
                    se_lines.append(sline1)
                t2, sline2 = self._format_se(best_se2, cig_se2, name2, read2)
                if t2 == MAP_UNMAPPED:
                    best_se2 = [MAX_DIFFS_SENTINEL, best_se2[F], 0]
                if sline2 is not None:
                    se_lines.append(sline2)

            if line1 is not None:
                out.write(line1)
            if line2 is not None:
                out.write(line2)
            for sl in se_lines:
                out.write(sl)

            # stats (abismal.cpp:1034-1057)
            ps = stats.read_pair_stats
            ps.total_reads += 1
            valid = not best.empty()
            ambig = best.ambig()
            ps.reads_mapped_unique += valid and not ambig
            ps.reads_mapped_ambiguous += valid and ambig
            ps.reads_skipped += (not read1) or (not read2)
            if best.should_report(self.allow_ambig):
                ps.update_pair(best.r1[D], best.r2[D], cigars[0], cigars[1])
            else:
                stats.end1_stats.update(
                    read_empty=(l1 == 0), valid=not elem_empty(best_se1),
                    ambig=elem_is_ambig(best_se1), diffs=best_se1[D],
                    cigar=cig_se1, count_ambig_err=False,
                )
                stats.end2_stats.update(
                    read_empty=(l2 == 0), valid=not elem_empty(best_se2),
                    ambig=elem_is_ambig(best_se2), diffs=best_se2[D],
                    cigar=cig_se2, count_ambig_err=False,
                )

    def _align_se_fallback(self, preads, res_se: SECandidates, readlen: int):
        # the four encodings per end are all present or all absent (a read
        # is either empty, producing no fragment-call encodings, or every
        # call encoded it)
        pt, ptrc, pa, parc = preads
        if pt is None and ptrc is None:
            return [MAX_DIFFS_SENTINEL, 0, 0], []
        return align_se_candidates(
            pt, ptrc, pa, parc, self.valid_frac / 2, res_se, self.aln
        )


def cigars_swapped(cigars):
    """A view-like 2-slot proxy presenting [cig2, cig1] while writing back
    into the original list."""

    class _Swapped:
        def __getitem__(self, i):
            return cigars[1 - i]

        def __setitem__(self, i, v):
            cigars[1 - i] = v

    return _Swapped()


def _write_stats(stats, stats_path, stats_json, paired, allow_ambig):
    if not stats_path:
        return
    with open(stats_path, "w") as f:
        if stats_json:
            f.write(stats_to_json(stats))
        elif paired:
            f.write(stats.tostring(allow_ambig))
        else:
            f.write(stats.tostring("read1"))


def run_map(index, reads_file1: str, reads_file2: str | None, out_path: str,
            stats_path: str | None, command_line: str, a_rich: bool = False,
            pbat: bool = False, random_pbat: bool = False,
            allow_ambig: bool = False, stats_json: bool = False,
            valid_frac: float = VALID_FRAC_DEFAULT,
            pe_min_dist: int = PE_MIN_DIST_DEFAULT,
            pe_max_dist: int = PE_MAX_DIST_DEFAULT,
            engine_factory=None, threads: int = 1,
            bam: bool = False, verbose: bool = False):
    """End-to-end `map` command (abismal.cpp:2295-2504).
    engine_factory(index, allow_ambig, valid_frac, pe_min_dist,
    pe_max_dist) builds the engine; None is the exact engine
    (MappingEngine)."""
    paired = reads_file2 is not None

    if getattr(engine_factory, "is_native", False):
        # native-library engines thread internally and use the
        # dispatch/finish pipeline loop (single process)
        engine = engine_factory(index, allow_ambig, valid_frac, pe_min_dist,
                                pe_max_dist)
        engine.n_threads = max(1, threads)
        stats = run_map_pipelined(
            engine, index, reads_file1, reads_file2, out_path, command_line,
            a_rich=a_rich, pbat=pbat, random_pbat=random_pbat, bam=bam,
            verbose=verbose)
        _write_stats(stats, stats_path, stats_json, paired, allow_ambig)
        return stats

    if threads > 1:
        # worker processes map whole batches, the output is written in
        # batch order: the sequential path's bytes.  A replay factory's
        # engine runs the device stage 1 in this process (run_map_hybrid,
        # which is handed the configured factory)
        from . import runner

        extra = {}
        if getattr(engine_factory, "is_replay", False):
            run = runner.run_map_hybrid
            extra["engine_factory"] = engine_factory
        else:
            run = runner.run_map_parallel
        stats = run(
            index, reads_file1, reads_file2, out_path, command_line,
            threads, a_rich=a_rich, pbat=pbat, random_pbat=random_pbat,
            allow_ambig=allow_ambig, valid_frac=valid_frac,
            pe_min_dist=pe_min_dist, pe_max_dist=pe_max_dist, bam=bam,
            **extra)
        _write_stats(stats, stats_path, stats_json, paired, allow_ambig)
        return stats

    if engine_factory is None:
        engine = MappingEngine(index, allow_ambig, valid_frac, pe_min_dist,
                               pe_max_dist)
    else:
        engine = engine_factory(index, allow_ambig, valid_frac, pe_min_dist,
                                pe_max_dist)

    start_time = time.monotonic()
    bar = None
    if verbose:
        from ..utils.progress import file_progress

        bar = file_progress(reads_file1)
    with open_sam_output(out_path, bam) as out:
        out.write(make_sam_header(index.cl, command_line))
        if not paired:
            stats = SEStats()
            rl = ReadLoader(reads_file1)
            a_rich_mode = a_rich or pbat
            while rl:
                batch = rl.load_batch()
                if batch:
                    engine.map_se_reads(batch, a_rich_mode, random_pbat,
                                        stats, out)
                    if bar is not None:
                        b = rl.current_byte
                        if bar.time_to_report(b):
                            bar.report(sys.stderr, b)
        else:
            stats = PEStats()
            rl1 = ReadLoader(reads_file1)
            rl2 = ReadLoader(reads_file2)
            while rl1 and rl2:
                b1 = rl1.load_batch()
                b2 = rl2.load_batch()
                if b1 or b2:
                    # PE ignores -A: the conversion is pbat's alone
                    # (abismal.cpp:2477-2480)
                    engine.map_pe_reads(b1, b2, pbat, random_pbat, stats, out)
                    if bar is not None:
                        b = rl1.current_byte
                        if bar.time_to_report(b):
                            bar.report(sys.stderr, b)

    if bar is not None and bar.prev < 100:
        bar.report(sys.stderr, bar.total)
    if verbose:
        print(f"[total mapping time: "
              f"{time.monotonic() - start_time:.2f}s]", file=sys.stderr)
    _write_stats(stats, stats_path, stats_json, paired, allow_ambig)
    return stats
