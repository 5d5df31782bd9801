"""FASTQ batch reader with the reference's read-cleaning rules
(src/abismal.cpp:150-213)."""

from __future__ import annotations

from ..constants import MIN_READ_LENGTH, PADDING_SIZE
from .genome import open_maybe_gzip

_ACGT = set(b"ACGT")


def clean_read(read: bytes) -> bytes:
    """Blank reads with < MIN_READ_LENGTH non-N bases; otherwise trim N from
    the 3' end then everything before the first ACGT (abismal.cpp:179-196)."""
    if len(read) >= PADDING_SIZE:
        raise RuntimeError(
            f"found a read of size {len(read)}, which is too long. "
            f"Maximum allowed read size = {PADDING_SIZE}"
        )
    n_informative = sum(1 for c in read if c != ord("N"))
    if n_informative < MIN_READ_LENGTH:
        return b""
    read = read.rstrip(b"N")
    for i, c in enumerate(read):
        if c in _ACGT:
            return read[i:]
    raise RuntimeError("read has no ACGT bases after trimming")


class ReadLoader:
    """Streams (name, read) batches of `batch_size` reads
    (abismal.cpp:150-209)."""

    def __init__(self, path: str, batch_size: int = 1000, skip: int = 0,
                 count: int | None = None):
        """skip/count select a contiguous read-range shard [skip,
        skip+count) of the file (multi-host / hybrid-split sharding)."""
        self.path = path
        self.batch_size = batch_size
        self._fh = open_maybe_gzip(path)
        self._eof = False
        self.cur_line = 0
        self._remaining = count
        if skip:
            import itertools

            # consume 4*skip lines at C speed (file iteration is readline
            # -based for Buffered/GzipFile, so mixing with readline is ok)
            consumed = sum(1 for _ in itertools.islice(self._fh, 4 * skip))
            self.cur_line += consumed
            if consumed < 4 * skip:
                self._eof = True

    def __bool__(self) -> bool:
        return not self._eof and self._remaining != 0

    def load_batch(self):
        out = []
        n = self.batch_size
        if self._remaining is not None:
            n = min(n, self._remaining)
        for _ in range(n):
            header = self._fh.readline()
            if not header:
                self._eof = True
                break
            header = header.rstrip(b"\n")
            if not header:
                raise RuntimeError(
                    f"file {self.path} contains an empty read name at line "
                    f"{self.cur_line}"
                )
            rest = header[1:]
            cut = len(rest)
            for d in (b" ", b"\t"):
                p = rest.find(d)
                if p != -1:
                    cut = min(cut, p)
            name = rest[:cut].decode()
            seq = self._fh.readline().rstrip(b"\n")
            self._fh.readline()  # '+'
            self._fh.readline()  # quality
            self.cur_line += 4
            out.append((name, clean_read(seq)))
        if self._remaining is not None:
            self._remaining -= len(out)
        return out

    @property
    def current_byte(self) -> int:
        """On-disk byte position (compressed for .gz inputs), mirroring
        ReadLoader::get_current_byte (abismal.cpp:160-162)."""
        raw = getattr(self._fh, "raw_file", self._fh)
        try:
            return raw.tell()
        except OSError:
            return 0

    def close(self):
        self._fh.close()
