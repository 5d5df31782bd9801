"""The engine's host tracer (abismal_tpu_torch/tracing.py) on the CPU:
off, a map records nothing and never enters the profiler; on, the SAM is
the golden's byte for byte, the spans nest (self time >= 0, a child's
total within its parent's) and count what the batch loop did, the
native finalize pool's jobs, waits and items claimed first too; under
torch.profiler the spans are abismal:<name> ranges, nested as they were
opened; -v prints the tracer's table; the tracer switches the native
library's worker timers on and off with itself, and the PE slot finalize
reports its workers' seconds on them; reads longer than lmax are
counted (oversized) and named on standard error at the end of a map;
the native unit encoder's rows are counted (encoded_units) and the
finalize reuses the sequence blob the dispatch encoded from."""

import gzip
import json
import os

import numpy as np
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


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def _n_reads(fq):
    with open(fq, "rb") as f:
        return sum(1 for _ in f) // 4


@pytest.fixture(scope="module")
def engine(port_index):
    """(factory, engine): the port's engine on the CPU, as the map tests
    build it (two native threads, 128 units a chunk)."""
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    fac = make_torch_native_engine_factory("cpu", unit_batch=128,
                                           n_threads=2)
    return fac, fac(port_index, False, 0.1, 32, 3000)


def _map(port_index, fac, name, paired, pbat, out, verbose=False):
    """Maps golden `name` with its command line; (SAM text, reads in)."""
    from abismal_tpu_torch.map.engine import run_map

    fq1 = golden_file(name + "_1.fq")
    fq2 = golden_file(name + "_2.fq") if paired else None
    flag = "-P " if pbat else ""
    ins = f"tests/{name}_1.fq" + (f" tests/{name}_2.fq" if paired else "")
    cl = (f"map {flag}-s tests/{name}.mstats -o tests/{name}.sam "
          f"-i tests/tRex1.idx {ins}")
    run_map(port_index, fq1, fq2, str(out), None, cl, pbat=pbat,
            engine_factory=fac, threads=2, verbose=verbose)
    n = _n_reads(fq1) + (_n_reads(fq2) if paired else 0)
    return out.read_text(), n


@pytest.mark.parametrize("name,paired,pbat", GOLDENS)
def test_off_records_nothing(tmp_path, port_index, engine, monkeypatch,
                             name, paired, pbat):
    fac, eng = engine

    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    eng.tracer.on = False
    eng.tracer.reset()
    sam, _ = _map(port_index, fac, name, paired, pbat, tmp_path / "o.sam")
    assert sam == _golden(name + ".sam")
    s = eng.tracer.summary()
    assert s["spans"] == {}
    assert not any(v for v in s["counters"].values())
    assert not eng.native._jobs  # the map's jobs ran, uncounted


@pytest.mark.parametrize("name,paired,pbat", GOLDENS)
def test_on_same_bytes_and_spans_nest(tmp_path, port_index, engine, name,
                                      paired, pbat):
    fac, eng = engine
    eng.tracer.reset()
    eng.tracer.on = True
    try:
        sam, n_reads = _map(port_index, fac, name, paired, pbat,
                            tmp_path / "o.sam")
    finally:
        eng.tracer.on = False
    assert sam == _golden(name + ".sam")
    s = eng.tracer.summary()
    spans, c = s["spans"], s["counters"]
    batches = c["batches"]
    assert batches >= 2 and c["reads"] == n_reads
    ends = ("_1.fq", "_2.fq") if paired else ("_1.fq",)
    assert c["read_bytes"] == sum(os.path.getsize(golden_file(name + e))
                                  for e in ends)
    assert spans["map"][0] == 1
    assert spans["map/dispatch"][0] == spans["map/finish"][0] == batches
    assert spans["map/read"][0] == batches + 1  # and the empty last load
    assert spans["map/dispatch/encode"][0] == batches
    for leaf in ("collect", "pack", "native", "write"):
        assert spans[f"map/finish/{leaf}"][0] == batches, leaf
    assert spans["map/dispatch/run"][0] == c["chunks"] > 0
    assert c["captures"] == 0  # the CPU runs the programs eagerly
    assert not [p for p in spans if p.endswith("device_wait")]
    for path, (calls, total, self_s) in spans.items():
        assert calls > 0 and self_s >= 0 and total >= self_s, path
        if "/" in path:
            parent = spans[path.rsplit("/", 1)[0]]
            assert total <= parent[1], path
    assert {"native_seed_s", "native_align_s", "native_format_s"} <= set(c)
    # the finalize pool: a job a batch, a wait at most a job, and a
    # native_wait span where a finish waited
    assert c["pool_jobs"] == batches
    assert c["pool_waits"] <= c["pool_jobs"]
    assert (c["pool_waits"] > 0) == ("map/finish/native_wait" in spans)


@pytest.mark.parametrize("name,paired,pbat", GOLDENS)
def test_pool_first_counts_the_fallbacks(tmp_path, port_index, engine,
                                         monkeypatch, name, paired, pbat):
    """pool_first counts the items the device program handed back, read
    from the finalize's own inputs: SE reads of status 3, PE pairs with
    a unit of cnt < 0."""
    fac, eng = engine
    nat = eng.native
    want = []
    se, pe = nat._finalize_se, nat._call_pe_slots

    def finalize_se(reads, arm, rp, records, *a, **k):
        want.append(int(((records[:, 0] & 7) == 3).sum()))
        return se(reads, arm, rp, records, *a, **k)

    def call_pe_slots(r1, r2, arm, rp, st, out, pos, ds, cnt, *a):
        want.append(int((cnt.reshape(len(r1), -1) < 0).any(1).sum()))
        return pe(r1, r2, arm, rp, st, out, pos, ds, cnt, *a)

    monkeypatch.setattr(nat, "_finalize_se", finalize_se)
    monkeypatch.setattr(nat, "_call_pe_slots", call_pe_slots)
    eng.tracer.reset()
    eng.tracer.on = True
    try:
        sam, _ = _map(port_index, fac, name, paired, pbat,
                      tmp_path / "o.sam")
    finally:
        eng.tracer.on = False
    assert sam == _golden(name + ".sam")
    c = eng.tracer.summary()["counters"]
    assert len(want) == c["pool_jobs"] == c["batches"]
    assert c["pool_first"] == sum(want) > 0


@pytest.mark.parametrize("name,paired,pbat", GOLDENS)
def test_units_encoded_natively_from_one_blob(tmp_path, port_index, engine,
                                              monkeypatch, name, paired,
                                              pbat):
    """A fused map counts the unit rows the native encoder wrote with bases
    in encoded_units: per a read, per / 2 a mate, with bases (the loader
    blanks the reads it skips; none is over lmax here), and each finalize
    job holds the sequence blob(s) its dispatch encoded from: the
    sequences are joined once a batch, in dispatch/encode."""
    from abismal_tpu_torch.map import native_engine, pipeline

    fac, eng = engine
    nat = eng.native
    made, held = [], []
    seq_blob, submit = native_engine.seq_blob, nat._submit

    def dispatch_blob(reads):
        made.append(seq_blob(reads))
        return made[-1]

    def finalize_blob(reads):
        raise AssertionError("the finalize joined the sequences again")

    def spy(fn, args, refs, *a):
        held.append(refs[0])
        return submit(fn, args, refs, *a)

    monkeypatch.setattr(pipeline, "seq_blob", dispatch_blob)
    monkeypatch.setattr(native_engine, "seq_blob", finalize_blob)
    monkeypatch.setattr(nat, "_submit", spy)
    eng.tracer.reset()
    eng.tracer.on = True
    try:
        sam, n_reads = _map(port_index, fac, name, paired, pbat,
                            tmp_path / "o.sam")
    finally:
        eng.tracer.on = False
    assert sam == _golden(name + ".sam")
    c = eng.tracer.summary()["counters"]
    per, items = (4, n_reads // 2) if paired else (2, n_reads)
    with_bases = sum(int((np.diff(offs) > 0).sum()) for _, offs in made)
    assert c["encoded_units"] == per // (1 + paired) * with_bases
    assert 0 < c["encoded_units"] < per * items
    assert len(held) == c["batches"] >= 2
    assert len(made) == c["batches"] * (2 if paired else 1)
    for k, blobs in enumerate(held):
        if paired:
            assert blobs[0] is made[2 * k][0] and blobs[1] is made[2 * k][1]
            assert (blobs[4] is made[2 * k + 1][0]
                    and blobs[5] is made[2 * k + 1][1])
        else:
            assert blobs[0] is made[k][0] and blobs[1] is made[k][1]


def test_event_route_same_bytes(tmp_path, port_index):
    """The event route (build_stage1's events replayed natively) has the
    same span names: finish/collect is the wait for its collector
    thread, whose own work records nothing."""
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    fac = make_torch_native_engine_factory("cpu", unit_batch=128,
                                           n_threads=2, device_stage2=False)
    eng = fac(port_index, False, 0.1, 32, 3000)
    eng.tracer.on = True
    try:
        sam, n_reads = _map(port_index, fac, "small", False, False,
                            tmp_path / "o.sam")
    finally:
        eng.tracer.on = False
    assert sam == _golden("small.sam")
    s = eng.tracer.summary()
    spans, batches = s["spans"], s["counters"]["batches"]
    assert s["counters"]["reads"] == n_reads
    for path in ("map/dispatch", "map/dispatch/encode", "map/finish",
                 "map/finish/collect", "map/finish/pack",
                 "map/finish/native", "map/finish/write"):
        assert spans[path][0] == batches, path
    assert spans["map/dispatch/run"][0] == s["counters"]["chunks"] > 0


def test_spans_on_the_profiler_timeline(tmp_path, port_index, engine):
    from torch.profiler import ProfilerActivity, profile

    fac, eng = engine
    eng.tracer.reset()
    eng.tracer.on = True
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _map(port_index, fac, "small", False, False, tmp_path / "o.sam")
    finally:
        eng.tracer.on = False
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith("abismal:")]
    names = {p.rsplit("/", 1)[-1] for p in eng.tracer.summary()["spans"]}
    ranges = {}
    for e in events:
        ranges.setdefault(e["name"][8:], []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    assert set(ranges) == names
    for s, e in ranges["encode"]:
        assert any(ds <= s and e <= de for ds, de in ranges["dispatch"])


def test_verbose_prints_the_table(tmp_path, port_index, engine, capsys):
    fac, eng = engine
    eng.tracer.on = False
    _map(port_index, fac, "small", False, False, tmp_path / "o.sam",
         verbose=True)
    err = capsys.readouterr().err
    assert not eng.tracer.on  # on for that map alone
    for path in ("map", "map/read", "map/dispatch/encode",
                 "map/finish/native", "map/finish/write"):
        assert f"[{path} " in err, path
    assert "[counters: reads 500, batches 2," in err
    # 40 of the 500 reads are blanked by the loader: no rows with bases
    assert "[unit encoder: 920 of 1000 unit rows, engagement 0.920]" in err


def test_native_timers_follow_the_tracer(tmp_path, port_index, engine):
    """On, the library's StageTimers count the workers' seconds; turned
    off, a map adds nothing to them."""
    from abismal_tpu_torch.map.native_engine import _ptr

    fac, eng = engine
    nat = eng.native

    def raw():
        ns = np.zeros(16, dtype=np.int64)
        nat.lib.engine_stage_ns(nat._ctx, _ptr(ns), 0)
        return ns[:3]

    eng.tracer.reset()
    eng.tracer.on = True
    _map(port_index, fac, "small", False, False, tmp_path / "o.sam")
    c = eng.tracer.summary()["counters"]
    assert c["native_align_s"] > 0 and c["native_format_s"] > 0
    eng.tracer.on = False
    before = raw()
    _map(port_index, fac, "small", False, False, tmp_path / "o.sam")
    assert (raw() == before).all()


def test_pe_finalize_worker_seconds(tmp_path, port_index, engine):
    """A PE map through the slot finalize (engine_pe_slots_submit)
    reports its workers' seconds in seed, align and format."""
    fac, eng = engine
    eng.tracer.reset()
    eng.tracer.on = True
    try:
        _map(port_index, fac, "small_pe", True, False, tmp_path / "o.sam")
    finally:
        eng.tracer.on = False
    c = eng.tracer.summary()["counters"]
    assert c["native_seed_s"] > 0
    assert c["native_align_s"] > 0
    assert c["native_format_s"] > 0


def _mixed(port_index):
    """Two mate lists of 12 pairs: mate 1 of 150 bases in pairs 0-7, mate
    2 of 150 in pairs 4-11, the others of 100; mates over 128 bases: 16."""
    l1, l2 = bs_pairs(port_index, n=12, length=150)
    s1, s2 = bs_pairs(port_index, n=12, length=100, frag=(100, 250), seed=8)
    r1 = l1[:8] + s1[8:]
    r2 = s2[:4] + l2[4:]
    return r1, r2


@pytest.mark.parametrize("paired", [False, True], ids=["se", "pe"])
def test_oversized_counts_long_mates(port_index, engine, paired):
    """At lmax 128, each read (mate) over 128 bases counts once: on the
    engine always, on the tracer while it is on; 0 there while off."""
    import io

    from abismal_tpu_torch.map.stats import PEStats, SEStats

    _, eng = engine
    r1, r2 = _mixed(port_index)

    def run():
        out = io.StringIO()
        if paired:
            eng.map_pe_reads(r1, r2, False, False, PEStats(), out)
        else:
            eng.map_se_reads(r1 + r2, False, False, SEStats(), out)

    for on in (True, False):
        eng.tracer.reset()
        eng.tracer.on = on
        n0 = eng.n_oversized
        try:
            run()
        finally:
            eng.tracer.on = False
        assert eng.n_oversized - n0 == 16
        assert eng.tracer.summary()["counters"]["oversized"] == (
            16 if on else 0)


@pytest.mark.parametrize("lmax", [128, 160])
def test_long_reads_named_on_stderr(tmp_path, port_index, capsys, lmax):
    """A map with mates longer than --lmax names them in one line on
    standard error, never in the SAM; with lmax above them, no line."""
    from abismal_tpu_torch.map.engine import run_map
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    r1, r2 = _mixed(port_index)
    fqs = []
    for e, reads in ((1, r1), (2, r2)):
        fq = tmp_path / f"r_{e}.fq"
        fq.write_bytes(b"".join(b"@%s\n%s\n+\n%s\n" % (
            n.encode(), s, b"I" * len(s)) for n, s in reads))
        fqs.append(str(fq))
    fac = make_torch_native_engine_factory("cpu", lmax=lmax, unit_batch=128,
                                           n_threads=2)
    sam = tmp_path / "o.sam"
    run_map(port_index, fqs[0], fqs[1], str(sam), None, "map",
            engine_factory=fac, threads=2)
    err = capsys.readouterr().err
    line = ("16 reads longer than --lmax 128 were mapped on the host; set "
            "--lmax to at least the longest read to keep them on the card")
    assert (line in err.splitlines()) == (lmax == 128), err
    assert "longer than" not in sam.read_text()
