"""FASTQ batch reader with the reference's read-cleaning rules
(src/abismal.cpp:150-213).

ReadLoader parses a batch in one call to the native library (_engine.cpp
parse_batch, the parser of the library's streaming loop); a file that
cannot be read to its end, a gzip stream cut short or corrupt included,
raises RuntimeError."""

from __future__ import annotations

import ctypes
import os


class ReadLoader:
    """Streams (name, read) batches of `batch_size` reads
    (abismal.cpp:150-209), each batch parsed by the native library."""

    def __init__(self, path: str, batch_size: int = 1000, skip: int = 0,
                 count: int | None = None):
        """skip/count select a contiguous read-range shard [skip,
        skip+count) of the file (multi-host / hybrid-split sharding)."""
        from ..native import get_engine_lib

        self.path = path
        self.batch_size = batch_size
        self._lib = get_engine_lib()
        self._h = self._lib.fastq_open(os.fsencode(path))
        if not self._h:
            open(path, "rb").close()  # raises what opening it would
            raise OSError(f"cannot open file: {path}")
        self._eof = False
        self.cur_line = 0
        self._remaining = count
        if skip:
            consumed = self._lib.fastq_skip(self._h, 4 * skip)
            if consumed < 0:
                raise RuntimeError(self._lib.fastq_error_ptr(self._h).decode())
            self.cur_line += consumed
            if consumed < 4 * skip:
                self._eof = True

    def __bool__(self) -> bool:
        return not self._eof and self._remaining != 0

    def load_batch(self):
        n = self.batch_size
        if self._remaining is not None:
            n = min(n, self._remaining)
        lib, h = self._lib, self._handle()
        got = lib.fastq_next_batch(h, n)
        if got < 0:
            raise RuntimeError(lib.fastq_error_ptr(h).decode())
        if got < n:
            self._eof = True
        self.cur_line += 4 * got
        if self._remaining is not None:
            self._remaining -= got
        if not got:
            return []
        offs = ctypes.c_int64 * (got + 1)
        ro = offs.from_address(lib.fastq_roffs_ptr(h))[:]
        no = offs.from_address(lib.fastq_noffs_ptr(h))[:]
        rb = ctypes.string_at(lib.fastq_rblob_ptr(h), ro[-1])
        nb = ctypes.string_at(lib.fastq_nblob_ptr(h), no[-1])
        return [(nb[no[i]:no[i + 1]].decode(), rb[ro[i]:ro[i + 1]])
                for i in range(got)]

    @property
    def current_byte(self) -> int:
        """On-disk byte position (compressed for .gz inputs), mirroring
        ReadLoader::get_current_byte (abismal.cpp:160-162)."""
        return self._lib.fastq_byte_pos(self._handle())

    @property
    def bytes_parsed(self) -> int:
        """Bytes of FASTQ text consumed so far, skipped records included
        (uncompressed)."""
        return self._lib.fastq_bytes_parsed(self._handle())

    def _handle(self):
        if not self._h:
            raise ValueError("I/O operation on closed file.")
        return self._h

    def close(self):
        if self._h:
            self._lib.fastq_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
