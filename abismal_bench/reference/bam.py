"""BAM read back as SAM text lines, for the judge (check.py), written from
the SAM specification (sections 4.1-4.2): a BGZF file is a series of gzip
members, and its payload holds the header text, the references, and one
binary record each alignment.  A line renders the record as upstream
abismal's SAM text does: RNEXT '=' for the record's own reference, '*'
for none, QUAL '*' where it is absent (all 0xff)."""

from __future__ import annotations

import gzip
import struct

CIGAR_OPS = "MIDNSHP=X"
SEQ_NT16 = "=ACMGRSVTWYHKDBN"
INT_TAGS = {b"c": "<b", b"C": "<B", b"s": "<h", b"S": "<H", b"i": "<i",
            b"I": "<I"}


def _tags(data: bytes, p: int, end: int) -> list:
    out = []
    while p < end:
        tag, typ = data[p : p + 2].decode(), data[p + 2 : p + 3]
        p += 3
        if typ in INT_TAGS:
            fmt = INT_TAGS[typ]
            (v,) = struct.unpack_from(fmt, data, p)
            p += struct.calcsize(fmt)
            out.append(f"{tag}:i:{v}")
        elif typ == b"A":
            out.append(f"{tag}:A:{chr(data[p])}")
            p += 1
        elif typ == b"f":
            (v,) = struct.unpack_from("<f", data, p)
            p += 4
            out.append(f"{tag}:f:{v:g}")
        elif typ in (b"Z", b"H"):
            q = data.index(b"\x00", p)
            out.append(f"{tag}:{typ.decode()}:{data[p:q].decode()}")
            p = q + 1
        else:  # an array (B) or an unknown type: the record stops here
            out.append(f"{tag}:{typ.decode(errors='replace')}:?")
            break
    return out


def sam_lines(path: str):
    """Yields each alignment of the BAM file as one SAM text line (bytes,
    with its newline)."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path} is not BAM")
    (l_text,) = struct.unpack_from("<i", data, 4)
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    names = []
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", data, p)
        names.append(data[p + 4 : p + 4 + ln - 1].decode())
        p += 8 + ln
    while p < len(data):
        (size,) = struct.unpack_from("<i", data, p)
        end = p + 4 + size
        (ref, pos, l_name, mapq, _bin, n_cig, flag, l_seq, nref, npos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", data, p + 4)
        q = p + 36
        name = data[q : q + l_name - 1].decode()
        q += l_name
        cig = struct.unpack_from(f"<{n_cig}I", data, q)
        q += 4 * n_cig
        packed = data[q : q + (l_seq + 1) // 2]
        q += (l_seq + 1) // 2
        seq = "".join(SEQ_NT16[(packed[i // 2] >> (4 * (1 - i % 2))) & 15]
                      for i in range(l_seq)) or "*"
        qual = data[q : q + l_seq]
        q += l_seq
        qual = ("*" if not l_seq or all(b == 0xFF for b in qual)
                else "".join(chr(b + 33) for b in qual))
        cigar = "".join(f"{c >> 4}{CIGAR_OPS[c & 15]}" for c in cig) or "*"
        rnext = ("*" if nref < 0 else "=" if nref == ref else names[nref])
        fields = [name, str(flag), names[ref] if ref >= 0 else "*",
                  str(pos + 1), str(mapq), cigar, rnext, str(npos + 1),
                  str(tlen), seq, qual, *_tags(data, q, end)]
        yield ("\t".join(fields) + "\n").encode()
        p = end
