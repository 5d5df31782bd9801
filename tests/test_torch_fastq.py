"""The port's FASTQ reader (abismal_tpu_torch/io/fastq.py): ReadLoader,
which parses each batch in the native library, gives what the JAX
package's plain reader (abismal_tpu/io/fastq.py, a Python loop over the
records) gives: the same batches in the same order, the same line count
and the same errors, on plain and gzip input, at batch sizes 1, 7 and
1,024 and on read-range shards; both raise on a gzip file cut short or
corrupt; its byte position grows to the file's size.  The library's
streaming loop, which shares the parser, writes the JAX package's native
engine's bytes and the goldens, and raises on a gzip file cut short."""

import gzip
import os
import random

import pytest

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, golden_file, port_index, ref_index, release_engines,
)

BATCH_SIZES = (1, 7, 1024)


def _rec(name: bytes, seq: bytes, eol: bytes = b"\n") -> bytes:
    return (b"@" + name + eol + seq + eol + b"+" + eol
            + b"I" * len(seq) + eol)


def _acgt(rng, n: int) -> bytes:
    return bytes(rng.choices(b"ACGT", k=n))


def _plain_records(n: int, seed: int = 0, eol: bytes = b"\n") -> bytes:
    rng = random.Random(seed)
    return b"".join(_rec(b"r%d desc" % i, _acgt(rng, 100), eol)
                    for i in range(n))


def _mixed() -> bytes:
    """Every cleaning rule and name cut the reader knows, no error."""
    rng = random.Random(1)
    recs = [
        (b"all_n", b"N" * 100),
        (b"short_informative", _acgt(rng, 43) + b"N" * 57),
        (b"just_enough", b"N" * 10 + _acgt(rng, 44)),
        (b"very_short", _acgt(rng, 30)),
        (b"lead_iupac", b"RYKMSW" + _acgt(rng, 90)),
        (b"lead_n", b"NNNN" + _acgt(rng, 90)),
        (b"lead_n_and_iupac", b"NRNY" + _acgt(rng, 90)),
        (b"trail_n", _acgt(rng, 90) + b"NNNNN"),
        (b"both_ends", b"NB" + _acgt(rng, 80) + b"N" * 8),
        (b"inner_n", _acgt(rng, 40) + b"NNNN" + _acgt(rng, 40)),
        (b"cut at space", _acgt(rng, 100)),
        (b"cut\tat tab", _acgt(rng, 100)),
        (b"cut at\tspace first", _acgt(rng, 100)),
        (b"", _acgt(rng, 100)),  # "@" alone: an empty name, no error
        (b" lead_space", _acgt(rng, 100)),
        (b"empty_read", b""),
        (b"longest", _acgt(rng, 32766)),
        (b"lowercase_n", b"n" * 100),
    ]
    body = b"".join(_rec(n, s) for n, s in recs)
    return _plain_records(5, 2) + body + _plain_records(30, 3)


# name -> (batch_size -> file contents)
CASES = {
    "mixed": lambda bs: _mixed(),
    "crlf": lambda bs: _plain_records(12, 4, b"\r\n"),
    "no_final_newline": lambda bs: _mixed()[:-1],
    "header_at_eof": lambda bs: _plain_records(9, 5) + b"@last\n",
    "header_at_eof_no_newline": lambda bs: _plain_records(9, 5) + b"@last",
    "seq_at_eof": lambda bs: _plain_records(8, 6) + b"@last\n" + b"A" * 60,
    "empty_name_line": lambda bs: (_plain_records(10, 7)
                                   + b"\nACGT\n+\nIIII\n"
                                   + _plain_records(3, 8)),
    "empty_name_line_first": lambda bs: b"\n" + _plain_records(2, 7),
    "too_long": lambda bs: (_plain_records(4, 9)
                            + _rec(b"long", b"A" * 32767)
                            + _plain_records(2, 9)),
    "no_acgt": lambda bs: (_plain_records(3, 10)
                           + _rec(b"iupac", b"RYKM" * 20)),
    "lowercase": lambda bs: _rec(b"lc", b"acgt" * 25),
    "k_times_batch": lambda bs: _plain_records(3 * bs if bs < 1024 else bs,
                                               11),
    "empty_file": lambda bs: b"",
}


def _write(tmp_path, data: bytes, gz: bool) -> str:
    path = str(tmp_path / ("r.fq.gz" if gz else "r.fq"))
    if gz:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return path


def _drain(cls, path, batch_size, skip=0, count=None):
    """Every load_batch of a reader until it is done: (batch, cur_line,
    bool(reader)) each, then the error's type and text if one was raised;
    and the byte positions after each batch.  cls is the port's ReadLoader
    or the JAX package's."""
    rl, steps, pos = None, [], []
    try:
        rl = cls(path, batch_size, skip=skip, count=count)
        steps.append(("init", rl.cur_line, bool(rl)))
        while rl:
            batch = rl.load_batch()
            steps.append((batch, rl.cur_line, bool(rl)))
            pos.append(rl.current_byte)
    except Exception as e:  # the two readers must raise alike
        steps.append((type(e).__name__, str(e)))
    if rl is not None:
        rl.close()
    return steps, pos


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("batch_size", BATCH_SIZES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_reader_matches_plain(tmp_path, case, batch_size, gz):
    from abismal_tpu.io.fastq import ReadLoader as JaxReadLoader
    from abismal_tpu_torch.io.fastq import ReadLoader

    path = _write(tmp_path, CASES[case](batch_size), gz)
    got, _ = _drain(ReadLoader, path, batch_size)
    want, _ = _drain(JaxReadLoader, path, batch_size)
    assert got == want
    if case == "k_times_batch":  # the trailing empty batch
        assert got[-1] == ([], got[-2][1], False)
    if case.startswith("empty_name_line"):
        assert "empty read name at line" in got[-1][1]


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("skip,count", [
    (0, None), (3, 11), (7, 14), (9, None), (6, 1), (45, 10), (50, 5),
    (60, 3), (5, 0),
])
def test_native_reader_shards_match_plain(tmp_path, skip, count, gz):
    """Read-range shards [skip, skip + count) over 50 records in batches
    of 7: starts and ends inside and on batch boundaries, a shard running
    past the end, one starting past it, an empty one; a last line without
    its newline."""
    from abismal_tpu.io.fastq import ReadLoader as JaxReadLoader
    from abismal_tpu_torch.io.fastq import ReadLoader

    path = _write(tmp_path, _plain_records(50, 12)[:-1], gz)
    got, _ = _drain(ReadLoader, path, 7, skip, count)
    want, _ = _drain(JaxReadLoader, path, 7, skip, count)
    assert got == want


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_current_byte_grows_to_the_file_size(tmp_path, gz):
    """current_byte never falls and ends at the file's size; on a plain
    file it is the bytes of the records consumed, the JAX package's
    reader's tell(); bytes_parsed ends at the uncompressed size."""
    from abismal_tpu.io.fastq import ReadLoader as JaxReadLoader
    from abismal_tpu_torch.io.fastq import ReadLoader

    data = _plain_records(20000, 13)
    path = _write(tmp_path, data, gz)
    _, got = _drain(ReadLoader, path, 1024)
    assert got == sorted(got) and got[-1] == os.path.getsize(path)
    if not gz:
        _, want = _drain(JaxReadLoader, path, 1024)
        assert got == want
    rl = ReadLoader(path, 333, skip=5)
    assert rl.bytes_parsed == len(_plain_records(5, 13))
    while rl:
        rl.load_batch()
    assert rl.bytes_parsed == len(data)


def _damaged_gz(data: bytes, how: str) -> bytes:
    z = gzip.compress(data)
    if how == "cut_in_half":
        return z[:len(z) // 2]
    if how == "cut_in_trailer":  # the data whole, its size field cut
        return z[:-3]
    if how == "corrupt_data":
        mid = len(z) // 2
        return z[:mid] + bytes(b ^ 0x5A for b in z[mid:mid + 64]) + \
            z[mid + 64:]
    assert how == "bad_crc"
    return z[:-8] + bytes(b ^ 0xFF for b in z[-8:-4]) + z[-4:]


@pytest.mark.parametrize("skip", [0, 20000], ids=["read", "skip"])
@pytest.mark.parametrize("how", [
    "cut_in_half", "cut_in_trailer", "corrupt_data", "bad_crc",
])
def test_damaged_gz_raises(tmp_path, how, skip):
    """A gzip file cut short (a partial download) or corrupt raises, in
    load_batch or, when the damage lies in the records skipped, in the
    constructor, as the JAX package's reader raises; it never ends as a
    clean, shorter file.  25,000 records are 5.4 MB of text, more than
    the library's read buffer."""
    from abismal_tpu.io.fastq import ReadLoader as JaxReadLoader
    from abismal_tpu_torch.io.fastq import ReadLoader

    path = str(tmp_path / "r.fq.gz")
    with open(path, "wb") as f:
        f.write(_damaged_gz(_plain_records(25000, 14), how))
    got, _ = _drain(ReadLoader, path, 1024, skip)
    want, _ = _drain(JaxReadLoader, path, 1024, skip)
    assert got[-1][0] == "RuntimeError"
    assert len(want[-1]) == 2  # the JAX package's reader raises too
    if how != "corrupt_data":  # whose garbage may first break a record
        assert "cannot read FASTQ" in got[-1][1]
        assert want[-1][0] in ("EOFError", "BadGzipFile")


def test_closed_reader_refuses(tmp_path):
    from abismal_tpu_torch.io.fastq import ReadLoader

    rl = ReadLoader(_write(tmp_path, _plain_records(3), False), 2)
    rl.close()
    rl.close()
    with pytest.raises(ValueError):
        rl.load_batch()
    with pytest.raises(FileNotFoundError):
        ReadLoader(str(tmp_path / "missing.fq"))


# ---- the library's streaming loop (engine_run_se / engine_run_pe) --------

@pytest.fixture(scope="module")
def engines(port_index, ref_index):
    """(the port's native engine, the JAX package's), two threads each."""
    from abismal_tpu.map.native_engine import (
        NativeMappingEngine as RefEngine,
    )
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine

    return (NativeMappingEngine(port_index, n_threads=2),
            RefEngine(ref_index, n_threads=2))


def _stream(eng, fq1, fq2, out, header, skip=0, count=-1):
    from abismal_tpu_torch.map.stats import PEStats, SEStats

    stats = PEStats() if fq2 else SEStats()
    try:
        eng.run_streaming(fq1, fq2, str(out), header, False, False, stats,
                          skip_reads=skip, max_reads=count)
    except RuntimeError as e:
        return ("error", str(e))
    return out.read_bytes()


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("prefix,gz", [
    ("small", False), ("small", True), ("small_pe", False),
], ids=["se", "se-gz", "pe"])
def test_streaming_loop_gives_the_goldens(tmp_path, port_index, engines,
                                          prefix, gz):
    """The streaming loop over a golden FASTQ (as it is in tests/golden/,
    gzipped, or unpacked) writes the golden SAM byte for byte."""
    from abismal_tpu_torch.io.sam import make_sam_header

    paired = prefix.endswith("_pe")
    if gz:
        fq1 = os.path.join(GOLDEN, prefix + "_1.fq.gz")
    else:
        fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    header = make_sam_header(port_index.cl, cl)
    got = _stream(engines[0], fq1, fq2, tmp_path / "o.sam", header)
    assert got == _golden(prefix + ".sam")


@pytest.mark.parametrize("case,skip,count", [
    ("mixed", 0, -1), ("mixed", 7, 20), ("no_final_newline", 0, -1),
    ("header_at_eof", 0, -1), ("seq_at_eof", 3, -1),
    ("empty_name_line", 0, -1), ("too_long", 0, -1),
    ("small", 137, 200), ("small", 450, -1), ("small", 600, 5),
])
def test_streaming_loop_matches_jax_package(tmp_path, port_index, engines,
                                            case, skip, count):
    """The port's streaming loop and the JAX package's (whose library
    copy this port's reader does not touch) write the same bytes, or
    raise the same error, on the edge cases and on shards of a golden."""
    from abismal_tpu_torch.io.sam import make_sam_header

    if case == "small":
        fq = golden_file("small_1.fq")
    else:
        fq = _write(tmp_path, CASES[case](7), False)
    header = make_sam_header(port_index.cl, "map -o o.sam -i x.idx r.fq")
    own = _stream(engines[0], fq, None, tmp_path / "own.sam", header, skip,
                  count)
    ref = _stream(engines[1], fq, None, tmp_path / "ref.sam", header, skip,
                  count)
    assert own == ref
    if case in ("empty_name_line", "too_long"):
        assert own[0] == "error"


@pytest.mark.parametrize("skip", [0, 20000], ids=["read", "skip"])
@pytest.mark.parametrize("how", ["cut_in_half", "bad_crc"])
def test_streaming_loop_raises_on_damaged_gz(tmp_path, port_index, engines,
                                             how, skip):
    """The streaming loop stops with the library's error on a gzip file
    cut short or corrupt, where it read one as a shorter file before."""
    from abismal_tpu_torch.io.sam import make_sam_header

    fq = str(tmp_path / "r.fq.gz")
    with open(fq, "wb") as f:
        f.write(_damaged_gz(_plain_records(25000, 14), how))
    header = make_sam_header(port_index.cl, "map -o o.sam -i x.idx r.fq")
    own = _stream(engines[0], fq, None, tmp_path / "own.sam", header, skip)
    assert own[0] == "error" and "cannot read FASTQ" in own[1]
