"""Candidate-hit containers with the reference's exact heap semantics.

The reference uses std::push_heap/std::pop_heap on fixed arrays keyed by
Hamming distance; eviction order among equal-distance hits depends on the
libstdc++ heap algorithms, so those algorithms (sift-up push, and pop via
hole-to-leaf + sift-up) are reproduced here verbatim-in-behavior.

se_candidates: abismal.cpp:334-449.  pe_candidates: abismal.cpp:775-863.
Elements are [diffs, flags, pos] lists; comparison is by diffs only
(se_element::operator<, abismal.cpp:251-254).
"""

from __future__ import annotations

from ..constants import (
    GOOD_FRAC_DENOM,
    INVALID_HIT_FRAC,
    MAX_DIFFS_SENTINEL,
    PE_MAX_SIZE_LARGE,
    PE_MAX_SIZE_SMALL,
    SAM_SECONDARY,
    SE_MAX_CANDIDATES,
)

D, F, P = 0, 1, 2  # element field indices


def elem_is_ambig(e) -> bool:
    return bool(e[F] & SAM_SECONDARY)


def set_ambig(e) -> None:
    e[F] |= SAM_SECONDARY


def elem_empty(e) -> bool:
    return e[P] == 0


# --- libstdc++ heap algorithms (bits/stl_heap.h), comparator: diffs < ---

def _sift_up(v, hole, top, value):
    parent = (hole - 1) // 2
    while hole > top and v[parent][D] < value[D]:
        v[hole] = v[parent]
        hole = parent
        parent = (hole - 1) // 2
    v[hole] = value


def push_heap(v, n) -> None:
    """std::push_heap(v, v+n): element at n-1 sifts up."""
    _sift_up(v, n - 1, 0, v[n - 1])


def _adjust_heap(v, hole, length, value):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if v[second][D] < v[second - 1][D]:
            second -= 1
        v[hole] = v[second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        v[hole] = v[second - 1]
        hole = second - 1
    _sift_up(v, hole, top, value)


def pop_heap(v, n) -> None:
    """std::pop_heap(v, v+n): max moves to v[n-1], heap shrinks."""
    if n > 1:
        value = v[n - 1]
        v[n - 1] = v[0]
        _adjust_heap(v, 0, n - 1, value)


class SECandidates:
    """Fixed 50-slot max-heap on diffs with separately tracked exact match
    (abismal.cpp:334-449)."""

    max_size = SE_MAX_CANDIDATES

    def __init__(self):
        self.v = [[MAX_DIFFS_SENTINEL, 0, 0] for _ in range(self.max_size)]
        self.sz = 1
        self.best = [MAX_DIFFS_SENTINEL, 0, 0]
        self.cutoff = 0
        self.good_cutoff = 0
        self.sure_ambig = False

    def reset(self, readlen: int) -> None:
        # NB: element flags are NOT reset (se_element::reset,
        # abismal.cpp:286-296); only diffs and pos
        self.best[D] = int(INVALID_HIT_FRAC * readlen)
        self.best[P] = 0
        self.v[0][D] = int(INVALID_HIT_FRAC * readlen)
        self.v[0][P] = 0
        self.cutoff = self.v[0][D]
        self.good_cutoff = readlen // GOOD_FRAC_DENOM
        self.sure_ambig = False
        self.sz = 1

    def reset_plain(self) -> None:
        """se_candidates used after a failed fragment (abismal.cpp:406-415)."""
        self.best[D] = MAX_DIFFS_SENTINEL
        self.best[P] = 0
        self.v[0][D] = MAX_DIFFS_SENTINEL
        self.v[0][P] = 0
        self.cutoff = self.v[0][D]
        self.sure_ambig = False
        self.sz = 1

    def full(self) -> bool:
        return self.sz == self.max_size

    def has_exact_match(self) -> bool:
        return not elem_empty(self.best)

    def should_do_sensitive(self) -> bool:
        return (not self.full()) or self.cutoff > self.good_cutoff

    def set_specific(self) -> None:
        self.cutoff = self.good_cutoff

    def set_sensitive(self) -> None:
        self.cutoff = self.v[0][D]

    def update(self, specific: bool, d: int, s: int, p: int) -> None:
        if d == 0:
            # update_exact_match (abismal.cpp:347-355)
            if elem_empty(self.best):
                self.best = [0, s, p]
            elif self.best[P] != p or self.best[F] != s:
                set_ambig(self.best)
        else:
            if self.full():
                pop_heap(self.v, self.sz)
                self.v[self.sz - 1] = [d, s, p]
            else:
                self.v[self.sz] = [d, s, p]
                self.sz += 1
            push_heap(self.v, self.sz)

        self.sure_ambig = elem_is_ambig(self.best) and self.best[D] == 0
        self.cutoff = (min(self.cutoff, self.v[0][D]) if specific
                       else self.v[0][D])

    def prepare_for_alignments(self):
        """Sort by (pos, flags) and dedup (abismal.cpp:429-439); returns the
        deduped element list."""
        els = self.v[: self.sz]
        els.sort(key=lambda e: (e[P], e[F]))
        out = []
        for e in els:
            if not out or out[-1][P] != e[P] or out[-1][F] != e[F]:
                out.append(e)
        self.sz = len(out)
        return out


class PECandidates:
    """Heap with capacity growing 32 -> 32768 while specific-phase hits stay
    good (abismal.cpp:775-863)."""

    def __init__(self):
        self.v = [[MAX_DIFFS_SENTINEL, 0, 0] for _ in range(PE_MAX_SIZE_LARGE)]
        self.sz = 1
        self.capacity = PE_MAX_SIZE_SMALL
        self.cutoff = 0
        self.good_cutoff = 0
        self.sure_ambig = False

    def reset(self, readlen: int) -> None:
        self.v[0][D] = int(INVALID_HIT_FRAC * readlen)
        self.v[0][P] = 0
        self.sure_ambig = False
        self.cutoff = self.v[0][D]
        self.good_cutoff = readlen // GOOD_FRAC_DENOM
        self.sz = 1
        self.capacity = PE_MAX_SIZE_SMALL

    def full(self) -> bool:
        return self.sz == self.capacity

    def should_align(self) -> bool:
        return self.sz != PE_MAX_SIZE_LARGE or self.cutoff != 0

    def should_do_sensitive(self) -> bool:
        return (self.capacity == PE_MAX_SIZE_SMALL
                or self.cutoff > self.good_cutoff)

    def set_specific(self) -> None:
        self.cutoff = self.good_cutoff

    def set_sensitive(self) -> None:
        self.cutoff = self.v[0][D]

    def update(self, specific: bool, d: int, s: int, p: int) -> None:
        if self.full():
            if (specific and self.capacity != PE_MAX_SIZE_LARGE
                    and d <= self.good_cutoff):
                self.capacity += 1
            else:
                pop_heap(self.v, self.sz)
                self.sz -= 1
        self.v[self.sz] = [d, s, p]
        self.sz += 1
        push_heap(self.v, self.sz)
        self.cutoff = (min(self.cutoff, self.v[0][D]) if specific
                       else self.v[0][D])
        self.sure_ambig = self.full() and self.cutoff == 0

    def prepare_for_mating(self):
        """Sort by pos, dedup by (pos, flags) (abismal.cpp:844-852)."""
        els = self.v[: self.sz]
        els.sort(key=lambda e: e[P])
        out = []
        for e in els:
            if not out or out[-1][P] != e[P] or out[-1][F] != e[F]:
                out.append(e)
        self.sz = len(out)
        self.v[: len(out)] = out
        return out
