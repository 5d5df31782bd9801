"""SAM text output: header and record formatting, matching the reference's
htslib-based output byte for byte (src/abismal.cpp:451-545, 648-773,
2265-2293)."""

from __future__ import annotations

from contextlib import contextmanager

from ..constants import CIGAR_OPS, CIGAR_SHIFT, CIGAR_TYPE, VERSION_STRING


@contextmanager
def open_sam_output(path: str, bam: bool = False,
                    bam_emit_header: bool = True):
    """Text-SAM or BAM sink; both accept SAM text via write()."""
    if bam:
        from .bam import BamWriter

        w = BamWriter(path, emit_header=bam_emit_header)
        try:
            yield w
        finally:
            w.close()
    else:
        with open(path, "w") as f:
            yield f


def cigar_rseq_ops(cigar) -> int:
    """Reference bases consumed by a BAM-encoded cigar (abismal.cpp:451-462)."""
    return sum(c >> CIGAR_SHIFT for c in cigar if CIGAR_TYPE[c & 0xF] & 2)


def cigar_to_string(cigar) -> str:
    return "".join(f"{c >> CIGAR_SHIFT}{CIGAR_OPS[c & 0xF]}" for c in cigar)


def make_sam_header(cl, command_line: str) -> str:
    """@HD/@SQ/@PG header (abismal.cpp:2265-2293).  `command_line` is the
    full argv of the map invocation joined by spaces (a trailing space is
    appended, matching the reference's ostream_iterator)."""
    names = cl.names[1:-1]
    sizes = [int(cl.starts[i + 2]) - int(cl.starts[i + 1])
             for i in range(len(names))]
    out = ["@HD\tVN:1.0"]
    for name, size in zip(names, sizes):
        out.append(f"@SQ\tSN:{name}\tLN:{size}")
    out.append(f"@PG\tID:ABISMAL\tVN:{VERSION_STRING}\tCL:\"{command_line} \"")
    return "\n".join(out) + "\n"


def format_sam_record(name: str, flag: int, rname: str, pos_1based: int,
                      cigar, rnext: str, pnext_1based: int, isize: int,
                      seq: str, nm: int, cv: str) -> str:
    return (
        f"{name}\t{flag}\t{rname}\t{pos_1based}\t255\t"
        f"{cigar_to_string(cigar)}\t{rnext}\t{pnext_1based}\t{isize}\t"
        f"{seq}\t*\tNM:i:{nm}\tCV:A:{cv}\n"
    )
