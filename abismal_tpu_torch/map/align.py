"""Banded local alignment with traceback -> BAM cigar.

Exact re-implementation of the reference's banded Smith-Waterman
(src/AbismalAlign.hpp): int16 scores, zero floor, band of width
2*min(diffs, max_diffs)+1 centered on the seed diagonal, three update moves
with the reference's tie priority (insertion > deletion > diagonal, with the
insertion chain using already-updated values).  Rows are NumPy-vectorized;
the in-row insertion chain is a max-prefix scan.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    ALN_INDEL,
    ALN_MATCH,
    ALN_MISMATCH,
    BANDWIDTH,
    CIGAR_DEL,
    CIGAR_INS,
    CIGAR_MATCH,
    CIGAR_SHIFT,
    CIGAR_SOFT,
)


def best_single_score(readlen: int) -> int:
    return ALN_MATCH * readlen


def best_pair_score(readlen1: int, readlen2: int) -> int:
    return best_single_score(readlen1) + best_single_score(readlen2)


def edit_distance(scr: int, length: int, cigar) -> int:
    """Closed-form mismatch recovery from score + cigar
    (AbismalAlign.hpp:73-89).  C++ int division truncates toward zero."""
    if scr == 0:
        return length
    ins = sum(c >> CIGAR_SHIFT for c in cigar if (c & 0xF) == CIGAR_INS)
    dele = sum(c >> CIGAR_SHIFT for c in cigar if (c & 0xF) == CIGAR_DEL)
    a = scr - ALN_INDEL * (ins + dele)
    num = ALN_MATCH * (length - ins) - a
    den = ALN_MATCH - ALN_MISMATCH
    # C++ integer division truncates toward zero
    mism = abs(num) // den
    if num < 0:
        mism = -mism
    return mism + ins + dele


def make_default_cigar(length: int):
    return [length << CIGAR_SHIFT]  # '<len>M'


def band_width(diffs: int, max_diffs: int) -> int:
    """Band width 2*min(diffs, max_diffs)+1 capped at BANDWIDTH.  IUPAC
    genome codes can make Hamming 'distances' negative (multiple nibble
    bits match); the reference casts the negative value to size_t before
    min(), so the full band wins (AbismalAlign.hpp:332-334)."""
    b = 2 * min(diffs, max_diffs) + 1
    return BANDWIDTH if b < 0 else min(BANDWIDTH, b)


class BandedAligner:
    """Holds the score/traceback band for one thread of mapping
    (AbismalAlign.hpp:104-148).  Uses the native implementation by default;
    the pure-NumPy path below is the test oracle for it."""

    def __init__(self, genome_nibbles: np.ndarray, use_native: bool = True):
        self.g = np.ascontiguousarray(genome_nibbles)
        self.bw = BANDWIDTH
        self.table = None
        self.traceback = None
        self.q_sz = 0
        self._bandwidth = 0
        self.native = None
        self._tb_result = None
        if use_native:
            from ..native import get_lib

            self.native = get_lib()
            self._scratch = None
            self._cigar_buf = np.zeros(512, dtype=np.uint32)

    def reset(self, max_read_length: int) -> None:
        n_rows = max_read_length + self.bw
        if self.native is not None:
            self._scratch = np.zeros(n_rows * self.bw, dtype=np.int16)
            self._tb_scratch = np.zeros(n_rows * self.bw, dtype=np.int8)
            return
        self.table = np.zeros((n_rows, self.bw), dtype=np.int16)
        self.traceback = np.full((n_rows, self.bw), -1, dtype=np.int8)

    def _align_native(self, diffs: int, max_diffs: int, qseq: np.ndarray,
                      t_pos: int, do_traceback: bool) -> int:
        q_sz = int(qseq.shape[0])
        self.q_sz = q_sz
        if diffs == 0:
            self._tb_result = None
            return best_single_score(q_sz)
        bandwidth = band_width(diffs, max_diffs)
        q = np.ascontiguousarray(qseq)
        if not do_traceback:
            return int(self.native.banded_align_score(
                self.g.ctypes.data, q.ctypes.data, q_sz, t_pos, bandwidth,
                self._scratch.ctypes.data))
        import ctypes

        aln_len = ctypes.c_int64()
        new_pos = ctypes.c_int64()
        score = ctypes.c_int16()
        n_ops = self.native.banded_align_traceback(
            self.g.ctypes.data, q.ctypes.data, q_sz, t_pos, bandwidth,
            self._scratch.ctypes.data, self._tb_scratch.ctypes.data,
            self._cigar_buf.ctypes.data, ctypes.byref(aln_len),
            ctypes.byref(new_pos), ctypes.byref(score))
        self._tb_result = (
            [int(x) for x in self._cigar_buf[:n_ops]], int(aln_len.value),
            int(new_pos.value),
        )
        return int(score.value)

    def align(self, diffs: int, max_diffs: int, qseq: np.ndarray, t_pos: int,
              do_traceback: bool) -> int:
        """qseq: encoded read nibbles.  Returns the best local score
        (AbismalAlign.hpp:320-386)."""
        if self.native is not None:
            return self._align_native(diffs, max_diffs, qseq, t_pos,
                                      do_traceback)
        q_sz = int(qseq.shape[0])
        self.q_sz = q_sz
        if diffs == 0:
            return best_single_score(q_sz)

        bandwidth = band_width(diffs, max_diffs)
        self._bandwidth = bandwidth
        t_shift = q_sz + bandwidth
        t_beg = t_pos - (bandwidth - 1) // 2

        tbl = self.table
        tbl[:t_shift, :bandwidth] = 0
        if do_traceback:
            tb = self.traceback
            tb[:t_shift, :bandwidth] = -1

        g = self.g
        q = qseq
        idx4 = np.arange(bandwidth, dtype=np.int32)
        for i in range(1, t_shift):
            left = bandwidth - i if i < bandwidth else 0
            right = min(bandwidth, t_shift - i)
            if left >= right:
                continue
            prev = tbl[i - 1]
            cur = tbl[i]
            ref_base = g[t_beg + i - 1]
            q0 = i - bandwidth  # query index of column j is q0 + j
            js = idx4[left:right]
            qs = q[q0 + left : q0 + right]
            # diagonal: match test = nibble AND != 0 (AbismalAlign.hpp:65-70)
            sub = np.where((qs & ref_base) != 0, np.int16(ALN_MATCH),
                           np.int16(ALN_MISMATCH))
            diag = prev[left:right] + sub
            v = np.maximum(cur[left:right], diag)  # cur is 0-filled
            if do_traceback:
                trow = tb[i]
                t_slice = trow[left:right]
                t_slice[v == diag] = CIGAR_MATCH
            # from above: cell[j] <- max(cell[j], prev[j+1] + indel) for
            # j in [left, right-1)
            if right - left > 1:
                above = prev[left + 1 : right] + np.int16(ALN_INDEL)
                upd = np.maximum(v[:-1], above)
                if do_traceback:
                    t_slice[:-1][upd == above] = CIGAR_DEL
                v[:-1] = upd
                # from left (insertion chain, sequential in j): max-prefix
                # scan of v[j] + 4*j then subtract
                k = np.arange(right - left, dtype=np.int32)
                chain = np.maximum.accumulate(
                    v.astype(np.int32) - ALN_INDEL * k
                ) + ALN_INDEL * k
                chain = chain.astype(np.int16)
                if do_traceback:
                    is_left = np.zeros(right - left, dtype=bool)
                    is_left[1:] = chain[1:] == chain[:-1] + np.int16(ALN_INDEL)
                    t_slice[is_left] = CIGAR_INS
                v = chain
            cur[left:right] = v

        n_cells = t_shift * bandwidth
        flat = tbl[:t_shift, :bandwidth].reshape(-1)[:n_cells]
        return int(flat.max())

    def build_cigar_len_and_pos(self, diffs: int, max_diffs: int, t_pos: int):
        """Traceback -> (cigar list, aligned_len, new t_pos)
        (AbismalAlign.hpp:388-440)."""
        if self.native is not None:
            if diffs == 0 or self._tb_result is None:
                return make_default_cigar(self.q_sz), self.q_sz, t_pos
            return self._tb_result
        q_sz = self.q_sz
        bandwidth = band_width(diffs, max_diffs)
        t_shift = q_sz + bandwidth
        flat = self.table[:t_shift, :bandwidth].reshape(-1)
        best_cell = int(np.argmax(flat))
        r = int(flat[best_cell])
        the_row, the_col = divmod(best_cell, bandwidth)

        if r == 0 or diffs == 0:
            return make_default_cigar(q_sz), q_sz, t_pos

        soft_clip_bottom = (q_sz + bandwidth - 1) - (the_row + the_col)

        cigar = []
        tb = self.traceback
        tbl = self.table
        prev_arrow = int(tb[the_row, the_col])
        is_del = prev_arrow == CIGAR_DEL
        is_ins = prev_arrow == CIGAR_INS
        the_row -= 0 if is_ins else 1
        the_col -= 1 if is_ins else 0
        the_col += 1 if is_del else 0
        n = 1
        while tbl[the_row, the_col] > 0:
            arrow = int(tb[the_row, the_col])
            is_del = arrow == CIGAR_DEL
            is_ins = arrow == CIGAR_INS
            the_row -= 0 if is_ins else 1
            the_col -= 1 if is_ins else 0
            the_col += 1 if is_del else 0
            if arrow != prev_arrow:
                cigar.append((n << CIGAR_SHIFT) | (prev_arrow & 0xF))
                n = 0
            n += 1
            prev_arrow = arrow
        cigar.append((n << CIGAR_SHIFT) | (prev_arrow & 0xF))

        soft_clip_top = (the_row + the_col) - (bandwidth - 1)
        if soft_clip_top > 0:
            cigar.append((soft_clip_top << CIGAR_SHIFT) | CIGAR_SOFT)
        cigar.reverse()
        if soft_clip_bottom > 0:
            cigar.append((soft_clip_bottom << CIGAR_SHIFT) | CIGAR_SOFT)

        aligned_len = q_sz - soft_clip_bottom - soft_clip_top
        t_beg = t_pos - (bandwidth - 1) // 2
        return cigar, aligned_len, t_beg + the_row
