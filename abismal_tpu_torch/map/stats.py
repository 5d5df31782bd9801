"""Mapping statistics with the reference's exact YAML/JSON formatting
(src/abismal.cpp:865-1071)."""

from __future__ import annotations

import json

from ..io.sam import cigar_rseq_ops


def _g(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{x:g}"


class SEStats:
    def __init__(self):
        self.total_reads = 0
        self.reads_mapped_unique = 0
        self.reads_mapped_ambiguous = 0
        self.reads_skipped = 0
        self.edit_distance = 0
        self.total_bases = 0

    def update(self, read_empty: bool, valid: bool, ambig: bool, diffs: int,
               cigar, count_ambig_err: bool) -> None:
        self.total_reads += 1
        self.reads_mapped_unique += valid and not ambig
        self.reads_mapped_ambiguous += valid and ambig
        self.reads_skipped += read_empty
        if valid and (not ambig or count_ambig_err):
            self.edit_distance += diffs
            self.total_bases += cigar_rseq_ops(cigar)

    def update_pair(self, d1: int, d2: int, cig1, cig2) -> None:
        self.edit_distance += d1 + d2
        self.total_bases += cigar_rseq_ops(cig1) + cigar_rseq_ops(cig2)

    # --- derived quantities (abismal.cpp:898-959) ---
    def reads_mapped(self):
        return self.reads_mapped_unique + self.reads_mapped_ambiguous

    def _frac(self, num):
        return num / self.total_reads if self.total_reads > 0 else 0.0

    def tostring(self, label: str, n_tabs: int = 0) -> str:
        t = "    " * n_tabs
        lines = [f"{t}{label}:"]
        t += "    "
        err_rate = (self.edit_distance / self.total_bases
                    if self.total_bases > 0 else 0.0)
        unmapped = self.total_reads - self.reads_mapped()
        lines += [
            f"{t}total_reads: {self.total_reads}",
            f"{t}mapped:",
            f"{t}    num_mapped: {self.reads_mapped()}",
            f"{t}    num_unique: {self.reads_mapped_unique}",
            f"{t}    num_ambiguous: {self.reads_mapped_ambiguous}",
            f"{t}    percent_mapped: {_g(self._frac(self.reads_mapped()) * 100.0)}",
            f"{t}    percent_unique: {_g(self._frac(self.reads_mapped_unique) * 100.0)}",
            f"{t}    percent_ambiguous: {_g(self._frac(self.reads_mapped_ambiguous) * 100.0)}",
            f"{t}    unique_error:",
            f"{t}        edits: {self.edit_distance}",
            f"{t}        total_bases: {self.total_bases}",
            f"{t}        error_rate: {_g(err_rate)}",
            f"{t}num_unmapped: {unmapped}",
            f"{t}num_skipped: {self.reads_skipped}",
            f"{t}percent_unmapped: {_g(self._frac(unmapped) * 100.0)}",
            f"{t}percent_skipped: {_g(self._frac(self.reads_skipped) * 100.0)}",
        ]
        return "\n".join(lines) + "\n"

    def to_json_obj(self):
        return {
            "total_reads": self.total_reads,
            "reads_mapped_unique": self.reads_mapped_unique,
            "reads_mapped_ambiguous": self.reads_mapped_ambiguous,
            "reads_skipped": self.reads_skipped,
            "edit_distance": self.edit_distance,
            "total_bases": self.total_bases,
        }


class PEStats:
    def __init__(self):
        self.read_pair_stats = SEStats()
        self.end1_stats = SEStats()
        self.end2_stats = SEStats()

    def tostring(self, allow_ambig: bool) -> str:
        s = self.read_pair_stats.tostring("pairs")
        if not allow_ambig:
            s += self.end1_stats.tostring("read1")
            s += self.end2_stats.tostring("read2")
        return s

    def to_json_obj(self):
        return {
            "read_pair_stats": self.read_pair_stats.to_json_obj(),
            "end1_stats": self.end1_stats.to_json_obj(),
            "end2_stats": self.end2_stats.to_json_obj(),
        }


def stats_to_json(stats) -> str:
    # nlohmann::json orders object keys alphabetically and prints compactly
    return json.dumps(stats.to_json_obj(), separators=(",", ":"),
                      sort_keys=True)
