"""The native finalize pool (native/_engine.cpp: engine_se_finalize_submit,
engine_pe_slots_submit, engine_job_*) behind TorchNativeEngine.finish_se
and finish_pe, on the CPU: SAM and stats byte for byte the goldens' and
the native engine's at 1, 3 and 8 pool threads; with many items handed
back by the device program (mates longer than lmax, tRex1's repeats),
claimed first and finishing out of batch order, at the default number
of jobs in flight and at one; two files in a row on one engine;
map_se_reads / map_pe_reads and interleaved dispatches complete when
their last finish returns; a map that raises leaves no job behind; and
every other entry point of the library on the same pool (the streaming
loop, to SAM and BAM, the event route's batch and phase calls) gives the
goldens at 1 and 8 threads."""

import gzip
import io
import os

import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, bs_pairs, golden_file, port_index, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

# (golden, paired, pbat); the command lines are the goldens' (MANIFEST)
GOLDENS = [("small", False, False), ("small_pe", True, False),
           ("small_pbat_pe", True, True)]
THREADS = [1, 3, 8]


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def _engine(index, **kw):
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    kw.setdefault("n_threads", 2)
    return TorchNativeEngine(index, unit_batch=128, device="cpu", **kw)


def _factory(eng):
    """A run_map engine factory that hands out eng."""
    def factory(*_):
        return eng
    factory.is_native = True
    return factory


def _run(index, factory, fq1, fq2, out_dir, cl="map", threads=2, **kw):
    """run_map of fq1 (and fq2) through factory: (SAM text, mstats)."""
    from abismal_tpu_torch.map.engine import run_map

    sam, mst = out_dir / "o.sam", out_dir / "o.mstats"
    run_map(index, fq1, fq2, str(sam), str(mst), cl, engine_factory=factory,
            threads=threads, **kw)
    return sam.read_text(), mst.read_text()


def _native(index, fq1, fq2, out_dir, threads=2, **kw):
    """The same map by the native engine (its streaming loop)."""
    from abismal_tpu_torch.map.host_units import make_native_engine_factory

    return _run(index, make_native_engine_factory(threads), fq1, fq2,
                out_dir, threads=threads, **kw)


def _golden_map(index, factory, name, paired, pbat, out_dir, threads):
    fq1 = golden_file(name + "_1.fq")
    fq2 = golden_file(name + "_2.fq") if paired else None
    flag = "-P " if pbat else ""
    ins = f"tests/{name}_1.fq" + (f" tests/{name}_2.fq" if paired else "")
    cl = (f"map {flag}-s tests/{name}.mstats -o tests/{name}.sam "
          f"-i tests/tRex1.idx {ins}")
    return _run(index, factory, fq1, fq2, out_dir, cl, threads, pbat=pbat)


@pytest.fixture(scope="module")
def engine(port_index):
    """One engine for the module: each thread count restarts its pool."""
    eng = _engine(port_index)
    yield eng
    eng.close()


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name,paired,pbat", GOLDENS)
def test_goldens_at_thread_counts(tmp_path, port_index, engine, name,
                                  paired, pbat, threads):
    sam, mst = _golden_map(port_index, _factory(engine), name, paired, pbat,
                           tmp_path, threads)
    assert sam == _golden(name + ".sam")
    assert mst == _golden(name + ".mstats")
    assert not engine.native._jobs


def _write_fq(path, reads):
    path.write_bytes(b"".join(b"@%s\n%s\n+\n%s\n" % (
        n.encode(), s, b"I" * len(s)) for n, s in reads))
    return str(path)


@pytest.fixture(scope="module")
def mixed_files(port_index, tmp_path_factory):
    """Pairs on tRex1, mates of 150 and of 100 bases by turns (at lmax
    128 a 150-base mate sends its read, or its pair, back whole), 750
    pairs, so 6 SE batches and 3 PE ones of run_map_pipelined: (SE FASTQ,
    PE FASTQ 1, PE FASTQ 2)."""
    d = tmp_path_factory.mktemp("mixed")
    l1, l2 = bs_pairs(port_index, n=750, length=150, seed=11)
    s1, s2 = bs_pairs(port_index, n=750, length=100, frag=(100, 250),
                      seed=12)
    r1 = [a if i % 3 == 0 else b for i, (a, b) in enumerate(zip(l1, s1))]
    r2 = [a if i % 5 == 1 else b for i, (a, b) in enumerate(zip(l2, s2))]
    return (_write_fq(d / "se.fq", r1 + r2), _write_fq(d / "pe_1.fq", r1),
            _write_fq(d / "pe_2.fq", r2))


@pytest.fixture(scope="module")
def native_maps(port_index, mixed_files, tmp_path_factory):
    """The native engine's maps of mixed_files: {paired: (SAM, mstats)}."""
    d = tmp_path_factory.mktemp("native")
    return {False: _native(port_index, mixed_files[0], None, d),
            True: _native(port_index, mixed_files[1], mixed_files[2], d)}


def _n_long(fq1, fq2, lmax=128):
    """Reads (SE) or pairs (PE) with a mate longer than lmax."""
    if fq2 is None:
        return sum(len(s) > lmax for _, s in _reads(fq1))
    return sum(len(a) > lmax or len(b) > lmax
               for (_, a), (_, b) in zip(_reads(fq1), _reads(fq2)))


@pytest.mark.parametrize("threads,depth", [(1, None), (3, None), (8, None),
                                           (3, 1), (8, 1)],
                         ids=["1", "3", "8", "3-one", "8-one"])
@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_fallbacks_first_match_native(tmp_path, port_index, mixed_files,
                                      native_maps, paired, threads, depth):
    """Many items handed back, claimed first; batches finish out of order
    on 3 and 8 threads.  A finish leaves at most finalize_depth jobs on
    the pool, and the map's last one none."""
    fq1, fq2 = ((mixed_files[1], mixed_files[2]) if paired
                else (mixed_files[0], None))
    eng = _engine(port_index, n_threads=threads)
    if depth is not None:
        eng.finalize_depth = depth
    left = []
    name = "finish_pe" if paired else "finish_se"
    inner = getattr(eng, name)

    def finish(*a):
        n = inner(*a)
        left.append(len(eng.native._jobs))
        return n

    setattr(eng, name, finish)
    eng.tracer.on = True
    try:
        port = _run(port_index, _factory(eng), fq1, fq2, tmp_path,
                    threads=threads)
    finally:
        eng.tracer.on = False
        eng.close()
    assert port == native_maps[paired]
    c = eng.tracer.summary()["counters"]
    assert c["pool_jobs"] == c["batches"] == len(left) == (3 if paired else 6)
    assert c["pool_first"] >= _n_long(fq1, fq2) > 300
    assert c["pool_waits"] <= c["pool_jobs"]
    assert max(left) <= eng.finalize_depth and left[-1] == 0


def test_two_files_in_a_row(tmp_path, port_index, mixed_files,
                            native_maps):
    """One engine maps an SE file, a PE file and the SE file again: no
    job of one map is written into the next."""
    eng = _engine(port_index, n_threads=3)
    runs = [(mixed_files[0], None), (mixed_files[1], mixed_files[2]),
            (mixed_files[0], None)]
    for i, (fq1, fq2) in enumerate(runs):
        d = tmp_path / str(i)
        d.mkdir()
        port = _run(port_index, _factory(eng), fq1, fq2, d, threads=3)
        assert port == native_maps[fq2 is not None], i
    eng.close()


def _reads(path):
    from abismal_tpu_torch.io.fastq import ReadLoader

    return ReadLoader(path, 10**6).load_batch()


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_map_reads_complete_on_return(port_index, mixed_files, paired):
    """map_se_reads / map_pe_reads (finish(dispatch(...))) have written
    the whole batch when they return, also after a dispatch whose handle
    was dropped unfinished."""
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.stats import PEStats, SEStats

    eng = _engine(port_index, n_threads=3)
    nat = NativeMappingEngine(port_index, n_threads=3)
    if paired:
        batch = (_reads(mixed_files[1])[:96], _reads(mixed_files[2])[:96])
        eng.dispatch_pe(*batch, False, False)  # never finished
        call, new = "map_pe_reads", PEStats
    else:
        batch = (_reads(mixed_files[0])[:200],)
        eng.dispatch_se(*batch, False, False)
        call, new = "map_se_reads", SEStats
    outs = []
    for e in (eng, nat):
        out, st = io.StringIO(), new()
        getattr(e, call)(*batch, False, False, st, out)
        outs.append((out.getvalue(), st.tostring(False) if paired
                     else st.tostring("read1")))
    assert outs[0] == outs[1] and outs[0][0]
    assert not eng.native._jobs
    eng.close()


def test_interleaved_finishes_write_their_own_out(port_index, mixed_files):
    """Two batches dispatched, then finished into two outs: each out holds
    its own batch, complete once the last finish returns."""
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.stats import SEStats

    reads = _reads(mixed_files[0])
    batches = [reads[:150], reads[150:330]]
    eng = _engine(port_index, n_threads=3)
    handles = [eng.dispatch_se(b, False, False) for b in batches]
    outs = [io.StringIO(), io.StringIO()]
    for h, o in zip(handles, outs):
        eng.finish_se(h, SEStats(), o)
    nat = NativeMappingEngine(port_index, n_threads=3)
    for b, o in zip(batches, outs):
        want = io.StringIO()
        nat.map_se_reads(b, False, False, SEStats(), want)
        assert o.getvalue() == want.getvalue()
    eng.close()


def test_map_that_raises_leaves_no_job(tmp_path, port_index, mixed_files,
                                       native_maps):
    """A map whose fifth dispatch raises, its pool slower than its batch
    loop (no job written before the end), drops the jobs its finishes
    left on the pool; the engine's next map is the native engine's."""
    eng = _engine(port_index, n_threads=3)
    inner = eng.dispatch_se
    calls = []

    def failing(*a):
        calls.append(1)
        if len(calls) == 5:
            assert len(eng.native._jobs) == 2  # batches 1 and 2
            raise RuntimeError("dispatch failed")
        return inner(*a)

    eng.dispatch_se = failing
    eng.native._write_jobs = lambda keep: None
    with pytest.raises(RuntimeError, match="dispatch failed"):
        _run(port_index, _factory(eng), mixed_files[0], None, tmp_path,
             threads=3)
    assert not eng.native._jobs
    del eng.dispatch_se, eng.native._write_jobs
    d = tmp_path / "again"
    d.mkdir()
    port = _run(port_index, _factory(eng), mixed_files[0], None, d,
                threads=3)
    assert port == native_maps[False]
    eng.close()


def test_many_jobs_on_more_threads_than_cores(port_index, mixed_files):
    """48 batches of 8 reads in flight at once on a pool of more threads
    than this process has cores, finished in one go (joined with a
    timeout): every read written once, in batch order, its stats summed
    once (the native engine's map of the same reads)."""
    import threading

    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.stats import SEStats

    reads = _reads(mixed_files[0])[:384]
    eng = _engine(port_index, n_threads=len(os.sched_getaffinity(0)) + 4)
    handles = [eng.dispatch_se(reads[i : i + 8], False, False)
               for i in range(0, len(reads), 8)]
    out, st = io.StringIO(), SEStats()

    def finish_all():
        for h in handles:
            eng.finish_se(h, st, out)

    t = threading.Thread(target=finish_all)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    want, st_n = io.StringIO(), SEStats()
    NativeMappingEngine(port_index, n_threads=3).map_se_reads(
        reads, False, False, st_n, want)
    assert out.getvalue() == want.getvalue()
    assert st.__dict__ == st_n.__dict__
    assert not eng.native._jobs
    eng.close()


# every entry point of the native library on its pool, each a map of a
# golden: "stream" the native engine's streaming loop (engine_run_se /
# engine_run_pe), "bam" the same with -B, "events" the event route's batch
# calls (engine_map_se_batch / engine_map_pe_batch), "align" its
# device-align phases (engine_{se,pe}_phase{1,2})
ENTRIES = {"stream_se": ("small", "stream"), "stream_pe": ("small_pe", "stream"),
           "stream_bam": ("small", "bam"), "events_se": ("small", "events"),
           "events_pe": ("small_pe", "events"),
           "align_pe": ("small_pe", "align")}
STREAM_BATCH = 48  # small's 500 reads in 11 batches: more than 8 in flight


def _entry_factory(index, how, threads):
    """A run_map factory whose engine runs the golden through `how`."""
    import functools

    from abismal_tpu_torch.map.native_engine import NativeMappingEngine

    if how in ("stream", "bam"):
        eng = NativeMappingEngine(index, n_threads=threads)
        eng.run_streaming = functools.partial(eng.run_streaming,
                                              batch_size=STREAM_BATCH)
    else:
        eng = _engine(index, n_threads=threads, device_stage2=False,
                      device_align=how == "align", align_jcap=256)
    return _factory(eng), eng


def _stream_bam(index, threads, out_dir):
    """small mapped to BAM by the streaming loop: (BAM bytes, mstats)."""
    from abismal_tpu_torch.map.engine import run_map

    factory, _ = _entry_factory(index, "bam", threads)
    bam, mst = out_dir / "o.bam", out_dir / "o.mstats"
    cl = ("map -s tests/small.mstats -o tests/small.sam -i tests/tRex1.idx "
          "tests/small_1.fq")
    run_map(index, golden_file("small_1.fq"), None, str(bam), str(mst), cl,
            engine_factory=factory, threads=threads, bam=True)
    return bam.read_bytes(), mst.read_text()


@pytest.fixture(scope="module")
def bam_at_one_thread(port_index, tmp_path_factory):
    return _stream_bam(port_index, 1, tmp_path_factory.mktemp("bam1"))[0]


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_native_entry_points_at_thread_counts(tmp_path, port_index, entry,
                                              threads, bam_at_one_thread):
    """Each entry point gives its golden's SAM and mstats at 1 and at 8
    pool threads; the BAM of the streaming loop is the golden SAM's
    records and the same bytes at 8 threads as at 1."""
    from abismal_tpu_torch.io.bam import BamWriter

    name, how = ENTRIES[entry]
    if how == "bam":
        bam, mst = _stream_bam(port_index, threads, tmp_path)
        want = tmp_path / "want.bam"
        w = BamWriter(str(want))
        w.write(_golden("small.sam"))
        w.close()
        assert gzip.decompress(bam) == gzip.decompress(want.read_bytes())
        assert bam == bam_at_one_thread
        assert mst == _golden("small.mstats")
        return
    factory, eng = _entry_factory(port_index, how, threads)
    try:
        sam, mst = _golden_map(port_index, factory, name, name != "small",
                               False, tmp_path, threads)
    finally:
        if how in ("events", "align"):
            eng.close()
    assert sam == _golden(name + ".sam")
    assert mst == _golden(name + ".mstats")
