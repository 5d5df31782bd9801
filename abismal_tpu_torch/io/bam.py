"""BAM output: BGZF container + binary alignment records, written from the
engine's (already byte-validated) SAM text.  No htslib dependency.

BGZF blocks are standard gzip members with the BC extra subfield holding
the compressed block length; the file ends with the fixed 28-byte EOF
block (SAM spec section 4).
"""

from __future__ import annotations

import struct
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_CIGAR_OPS = "MIDNSHP=XB"
_SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def reg2bin(beg: int, end: int) -> int:
    """SAM spec bin calculation."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BgzfWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= 65000:
            self._flush_block(self.buf[:65000])
            del self.buf[:65000]

    def _flush_block(self, chunk: bytes) -> None:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(chunk)) + co.flush()
        bsize = len(cdata) + 25 + 1  # header(12) + extra(6) + data + crc/isize(8) - 1
        block = (b"\x1f\x8b\x08\x04" + b"\x00" * 6
                 + struct.pack("<HBBHH", 6, 66, 67, 2, bsize)
                 + cdata
                 + struct.pack("<II", zlib.crc32(bytes(chunk)) & 0xFFFFFFFF,
                               len(chunk)))
        self.f.write(block)

    def close(self) -> None:
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf.clear()
        self.f.write(BGZF_EOF)
        self.f.close()


def bam_header_payload(sam_header_text: str) -> bytes:
    """Uncompressed BAM header block (magic + text + reference list) for a
    SAM header; the native streaming writer BGZF-compresses this payload
    and appends binary records (engine_run_se/pe with out_bam)."""
    refs = []
    for line in sam_header_text.splitlines():
        if line.startswith("@SQ"):
            fields = dict(f.split(":", 1) for f in line.split("\t")[1:])
            refs.append((fields["SN"], int(fields["LN"])))
    text = sam_header_text.encode()
    out = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text)
    out += struct.pack("<i", len(refs))
    for name, length in refs:
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    return bytes(out)


class BamWriter:
    """Accepts the engine's SAM text via write(); emits BAM."""

    def __init__(self, path: str, emit_header: bool = True):
        """emit_header=False consumes @-lines for the reference dictionary
        (tid mapping) but writes no header block -- a non-rank-0 shard of
        a multi-shard BAM whose gather concatenates after a rank-0 shard
        that carries the header."""
        self.out = BgzfWriter(path)
        self._header_lines = []
        self._in_header = True
        self._emit = emit_header
        self._refs = []  # (name, length)
        self._ref_idx = {}

    def write(self, text: str) -> None:
        for line in text.splitlines(keepends=False):
            if not line:
                continue
            if line.startswith("@"):
                self._header_lines.append(line)
            else:
                if self._in_header:
                    self._emit_header()
                self._write_record(line)

    def _emit_header(self) -> None:
        self._in_header = False
        for line in self._header_lines:
            if line.startswith("@SQ"):
                fields = dict(
                    f.split(":", 1) for f in line.split("\t")[1:])
                name = fields["SN"]
                self._ref_idx[name] = len(self._refs)
                self._refs.append((name, int(fields["LN"])))
        if not self._emit:
            return
        text = ("\n".join(self._header_lines) + "\n").encode()
        out = self.out
        out.write(b"BAM\x01" + struct.pack("<i", len(text)) + text)
        out.write(struct.pack("<i", len(self._refs)))
        for name, length in self._refs:
            nb = name.encode() + b"\x00"
            out.write(struct.pack("<i", len(nb)) + nb
                      + struct.pack("<i", length))

    def _write_record(self, line: str) -> None:
        f = line.split("\t")
        qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen, seq, qual = \
            f[:11]
        tags = f[11:]
        refid = self._ref_idx.get(rname, -1)
        pos0 = int(pos) - 1
        if rnext == "=":
            next_refid = refid
        elif rnext == "*":
            next_refid = -1
        else:
            next_refid = self._ref_idx.get(rnext, -1)
        next_pos = int(pnext) - 1

        cig = []
        if cigar != "*":
            n = 0
            for c in cigar:
                if c.isdigit():
                    n = n * 10 + int(c)
                else:
                    cig.append((n << 4) | _CIGAR_OPS.index(c))
                    n = 0
        ref_len = sum(c >> 4 for c in cig if (c & 0xF) in (0, 2, 3, 7, 8))
        bam_bin = reg2bin(pos0, pos0 + max(ref_len, 1))

        name_b = qname.encode() + b"\x00"
        l_seq = 0 if seq == "*" else len(seq)
        seq_b = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(seq if seq != "*" else ""):
            v = _SEQ_NT16.get(ch.upper(), 15)
            if i % 2 == 0:
                seq_b[i // 2] = v << 4
            else:
                seq_b[i // 2] |= v
        qual_b = (b"\xff" * l_seq if qual == "*"
                  else bytes(ord(q) - 33 for q in qual))

        aux = bytearray()
        for t in tags:
            tag, typ, val = t.split(":", 2)
            if typ == "i":
                v = int(val)
                if 0 <= v <= 255:
                    aux += tag.encode() + b"C" + struct.pack("<B", v)
                elif -128 <= v <= 127:
                    aux += tag.encode() + b"c" + struct.pack("<b", v)
                elif 0 <= v <= 65535:
                    aux += tag.encode() + b"S" + struct.pack("<H", v)
                elif -32768 <= v <= 32767:
                    aux += tag.encode() + b"s" + struct.pack("<h", v)
                else:
                    aux += tag.encode() + b"i" + struct.pack("<i", v)
            elif typ == "A":
                aux += tag.encode() + b"A" + val.encode()[:1]
            else:  # string
                aux += tag.encode() + b"Z" + val.encode() + b"\x00"

        body = struct.pack(
            "<iiBBHHHiiii", refid, pos0, len(name_b), int(mapq), bam_bin,
            len(cig), int(flag), l_seq, next_refid, next_pos, int(tlen),
        ) + name_b + b"".join(struct.pack("<I", c) for c in cig) \
            + bytes(seq_b) + qual_b + bytes(aux)
        self.out.write(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        if self._in_header:
            self._emit_header()
        self.out.close()


def read_bam_records(path: str):
    """Minimal BAM reader for tests: yields SAM-like field tuples."""
    import gzip

    with gzip.open(path, "rb") as fh:
        data = fh.read()
    assert data[:4] == b"BAM\x01"
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off)
    off += 4
    header_text = data[off : off + l_text].decode()
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", data, off)
        off += 4
        name = data[off : off + ln - 1].decode()
        off += ln
        (rlen,) = struct.unpack_from("<i", data, off)
        off += 4
        refs.append((name, rlen))
    records = []
    while off < len(data):
        (bs,) = struct.unpack_from("<i", data, off)
        off += 4
        (refid, pos0, l_rn, mapq, _bin, n_cig, flag, l_seq, nrefid, npos,
         tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p : p + l_rn - 1].decode()
        p += l_rn
        cig = struct.unpack_from(f"<{n_cig}I", data, p)
        p += 4 * n_cig
        seq_b = data[p : p + (l_seq + 1) // 2]
        p += (l_seq + 1) // 2
        seq = "".join(
            "=ACMGRSVTWYHKDBN"[(seq_b[i // 2] >> (4 if i % 2 == 0 else 0))
                               & 0xF]
            for i in range(l_seq))
        p += l_seq  # qual
        aux = data[p : off + bs]
        cigar = "".join(f"{c >> 4}{_CIGAR_OPS[c & 0xF]}" for c in cig)
        records.append((qname, flag, refid, pos0, mapq, cigar, nrefid, npos,
                        tlen, seq, bytes(aux)))
        off += bs
    return header_text, refs, records
