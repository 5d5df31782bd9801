"""End-to-end `map` through run_map with the port's engine factory on the
CPU (plain kernel versions): byte-identical to the upstream goldens, and
to the exact native engine on the modes and fallback routes the fused
program must hand back to the host."""

import io

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, bs_pairs, golden_file, port_index, ref_index, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)


def _golden(name):
    import gzip
    import os

    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


@pytest.fixture(scope="module")
def indexes(port_index, ref_index):
    """(the port's index, the JAX package's), read from one file."""
    return port_index, ref_index


def _factory(**kw):
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    kw.setdefault("unit_batch", 128)
    kw.setdefault("n_threads", 2)
    return make_torch_native_engine_factory("cpu", **kw)


def _port_and_native(tmp_path, indexes, fq, cl, fq2=None, **run_kw):
    """(port, native) outputs of run_map, each (SAM text, mstats text):
    the port's run_map with the port's engine on its index, and the JAX
    package's run_map with the JAX package's native engine on its own."""
    from abismal_tpu.map import engine as ref_engine
    from abismal_tpu.map.pipeline import make_native_engine_factory
    from abismal_tpu_torch.map import engine as port_engine

    outs = []
    for i, (mod, fac) in enumerate((
            (port_engine, _factory()),
            (ref_engine, make_native_engine_factory(n_threads=2)))):
        sam, mst = tmp_path / f"o{i}.sam", tmp_path / f"o{i}.mstats"
        mod.run_map(indexes[i], fq, fq2, str(sam), str(mst), cl,
                    engine_factory=fac, threads=2, **run_kw)
        outs.append((sam.read_text(), mst.read_text()))
    return outs


def _pe_port_and_native(tmp_path, indexes, prefix, cl, **run_kw):
    return _port_and_native(tmp_path, indexes, golden_file(prefix + "_1.fq"),
                            cl, fq2=golden_file(prefix + "_2.fq"), **run_kw)


def test_golden_small_parity(tmp_path, port_index):
    """The port's SE path gives the upstream small.sam / small.mstats."""
    from abismal_tpu_torch.map.engine import run_map

    cl = ("map -s tests/small.mstats -o tests/small.sam -i tests/tRex1.idx "
          "tests/small_1.fq")
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    run_map(port_index, golden_file("small_1.fq"), None, str(sam), str(mst),
            cl, engine_factory=_factory())
    assert sam.read_text() == _golden("small.sam")
    assert mst.read_text() == _golden("small.mstats")


@pytest.mark.parametrize("a_rich,random_pbat", [(True, False), (False, True)])
def test_se_modes_match_native(tmp_path, indexes, a_rich, random_pbat):
    """A-rich and RPBAT SE (4 units per read) equal the native engine."""
    port, native = _port_and_native(
        tmp_path, indexes, golden_file("small_1.fq"), "cl",
        a_rich=a_rich, random_pbat=random_pbat)
    assert port == native


def test_wide_band_fallback(tmp_path, indexes):
    """-m 0.45 gives true bands of 2 int(0.45 len) + 1 > BW_MAX: those reads
    fall back to the host (no clamping) and the output stays exact."""
    port, native = _port_and_native(
        tmp_path, indexes, golden_file("small_1.fq"),
        "map -m 0.45 -o out.sam -i tests/tRex1.idx tests/small_1.fq",
        valid_frac=0.45)
    assert port == native


@pytest.mark.parametrize("env", [
    {"ABISMAL_TPU_JOBS_PER_READ": "0"},  # every aligned read re-mapped
    {"ABISMAL_TPU_DEVTB": "0"},  # records only: winners traced on the host
    {"ABISMAL_TPU_JOBS_PER_UNIT": "0"},  # PE: every scored unit re-seeded
])
def test_env_routes_match_native(tmp_path, indexes, monkeypatch, env):
    """The JAX programs' environment knobs, read by the port too, move
    work between the device and the host; output is unchanged."""
    from abismal_tpu_torch.map import pipeline

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # a fresh engine: the memoized one built its program without the knob
    monkeypatch.setattr(pipeline, "_engine_memo", {})
    if "ABISMAL_TPU_JOBS_PER_UNIT" in env:
        port, native = _pe_port_and_native(tmp_path, indexes, "small_pe",
                                           "cl")
    else:
        port, native = _port_and_native(
            tmp_path, indexes, golden_file("small_1.fq"), "cl")
    assert port == native
    (eng,) = (e for _, e in pipeline._engine_memo.values())
    if "ABISMAL_TPU_JOBS_PER_READ" in env:  # every aligned read fell back
        assert eng.n_fallback > eng.n_units // 2
    elif "ABISMAL_TPU_JOBS_PER_UNIT" in env:  # units with a kept candidate
        assert eng.n_fallback > eng.n_units // 2
    else:
        assert not eng.device_tb


def _write_fasta(path, name, seq):
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i : i + 70] + "\n")


def test_iupac_negative_diffs(tmp_path):
    """Genome Y (C|T) codes drive T-rich popcount distances below zero;
    those diffs ride the packed field +512-biased, stay on the device path
    and give the native engine's output."""
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.stats import SEStats
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    rng = np.random.default_rng(77)
    n = 120000
    seq = rng.choice(list("ACGT"), size=n)
    yspots = rng.integers(200, n - 200, 400)
    seq[yspots] = "Y"
    _write_fasta(tmp_path / "negd.fa", "chrY", "".join(seq))
    index = create_index(str(tmp_path / "negd.fa"))
    reads = []
    for i, p in enumerate(sorted(set(int(y) for y in yspots))[:48]):
        s0 = max(0, min(p - 50, n - 100))
        r = "".join(seq[s0 : s0 + 100]).replace("C", "T").replace("Y", "T")
        reads.append((f"nd{i}", r.encode()))

    port = TorchNativeEngine(index, unit_batch=128, n_threads=2,
                             device="cpu")
    out_p, st_p = io.StringIO(), SEStats()
    port.map_se_reads(reads, False, False, st_p, out_p)
    host = NativeMappingEngine(index, n_threads=2)
    out_h, st_h = io.StringIO(), SEStats()
    host.map_se_reads(reads, False, False, st_h, out_h)
    assert out_p.getvalue() == out_h.getvalue()
    assert st_p.__dict__ == st_h.__dict__
    assert st_h.reads_mapped_unique > 0
    assert port.n_fallback < port.n_units // 2


def test_repeat_genome_sure_ambig(tmp_path):
    """Tandem-repeat reads with many exact hits are decided on the device
    by the sure-ambig heap-fill refinement, not sent to the host."""
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.io.fastq import ReadLoader
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.stats import SEStats
    from abismal_tpu_torch.sim.simreads import SimConfig, simulate_reads
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    rng = np.random.default_rng(77)
    unit = "".join(rng.choice(list("ACGT"), size=131))
    seq = ("".join(rng.choice(list("ACGT"), size=60_000)) + unit * 500
           + "".join(rng.choice(list("ACGT"), size=60_000)))
    fa = str(tmp_path / "rep.fa")
    _write_fasta(fa, "chrR", seq)
    index = create_index(fa)
    simulate_reads(fa, SimConfig(
        output_prefix=str(tmp_path / "r"), n_reads=400, mutation_rate=0.0,
        bs_conv=0.98, seed=5, single_end=True))
    batch = ReadLoader(str(tmp_path / "r_1.fq")).load_batch()

    port = TorchNativeEngine(index, unit_batch=1024, n_threads=2,
                             device="cpu")
    out_p, st_p = io.StringIO(), SEStats()
    port.map_se_reads(batch, False, False, st_p, out_p)
    host = NativeMappingEngine(index, n_threads=2)
    out_h, st_h = io.StringIO(), SEStats()
    host.map_se_reads(batch, False, False, st_h, out_h)
    assert out_p.getvalue() == out_h.getvalue()
    assert st_p.__dict__ == st_h.__dict__
    assert port.n_fallback / max(1, port.n_units) < 0.15
    assert st_p.reads_mapped_ambiguous > 50


@pytest.mark.parametrize("prefix,pbat", [
    ("small_pe", False),
    ("small_pbat_pe", True),
    ("small_rpbat_pe", True),  # the golden was mapped with -P (MANIFEST)
])
def test_golden_pe_parity(tmp_path, port_index, prefix, pbat):
    """The port's PE path gives the upstream SAM and mstats."""
    from abismal_tpu_torch.map.engine import run_map

    flag = "-P " if pbat else ""
    cl = (f"map {flag}-s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx tests/{prefix}_1.fq tests/{prefix}_2.fq")
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    # two threads, as every run of the memoized engine before this one:
    # the native engine sums the stats of every worker it ever started,
    # so fewer threads than a previous call count stale reads
    run_map(port_index, golden_file(prefix + "_1.fq"),
            golden_file(prefix + "_2.fq"), str(sam), str(mst), cl, pbat=pbat,
            engine_factory=_factory(), threads=2)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")


def test_pe_mate_file_cut_short(tmp_path, port_index):
    """A mate file with fewer reads than its end-1 file gives a last batch
    whose ends differ in size: the map raises the paired-end message
    before that batch's units are encoded, as the native engine does."""
    from abismal_tpu_torch.map.engine import run_map

    with open(golden_file("small_pe_2.fq"), "rb") as f:
        lines = f.readlines()
    fq2 = tmp_path / "cut_2.fq"
    fq2.write_bytes(b"".join(lines[: len(lines) - 4 * 7]))
    cl = ("map -o tests/small_pe.sam -i tests/tRex1.idx tests/small_pe_1.fq "
          "tests/cut_2.fq")
    with pytest.raises(RuntimeError, match="same number of reads"):
        run_map(port_index, golden_file("small_pe_1.fq"), str(fq2),
                str(tmp_path / "out.sam"), None, cl,
                engine_factory=_factory(), threads=2)


@pytest.mark.parametrize("prefix,random_pbat", [
    ("small_pe", False),
    ("small_rpbat_pe", True),
])
def test_pe_allow_ambig_matches_native(tmp_path, indexes, prefix,
                                       random_pbat):
    port_index = indexes[0]
    """Under -a the device mating sweep decides pairs (n_device_mated > 0)
    and the output equals the native engine's."""
    port, native = _pe_port_and_native(
        tmp_path, indexes, prefix, f"map -a -i tests/tRex1.idx {prefix}",
        allow_ambig=True, random_pbat=random_pbat)
    assert port == native
    eng = _factory()(port_index, True, 0.1, 32, 3000)
    assert eng.n_device_mated > 0


def test_pe_wide_band_fallback(tmp_path, indexes):
    port_index = indexes[0]
    """-m 0.45 PE: bands beyond BW_MAX flag their units (bw_fb) for native
    seeding; the output equals the native engine's."""
    port, native = _pe_port_and_native(
        tmp_path, indexes, "small_pe", "map -m 0.45 small_pe",
        valid_frac=0.45)
    assert port == native
    eng = _factory()(port_index, False, 0.45, 32, 3000)
    assert eng.n_fallback > 0


def test_pe_concordance_window_matches_native(tmp_path, indexes):
    """-l 40 -L 500 reach the device mating sweep as pe_dist."""
    port, native = _pe_port_and_native(
        tmp_path, indexes, "small_pe", "map -l 40 -L 500 small_pe",
        pe_min_dist=40, pe_max_dist=500)
    assert port == native


def test_genome_beyond_u32_positions_refused():
    """A live position may not equal the dead-slot sentinel 0xFFFFFFFF."""
    from types import SimpleNamespace

    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    with pytest.raises(ValueError, match="exceeds"):
        TorchNativeEngine(SimpleNamespace(genome_size=(1 << 32) - 1),
                          device="cpu")


@pytest.mark.parametrize("device_align", [False, True],
                         ids=["events", "device-align"])
@pytest.mark.parametrize("prefix,paired,pbat", [
    ("small", False, False),
    ("small_pe", True, False),
    ("small_pbat_pe", True, True),
    ("small_rpbat_pe", True, True),
])
def test_golden_event_route(tmp_path, port_index, monkeypatch, prefix,
                            paired, pbat, device_align):
    """The event-stream route (device_stage2=False: build_stage1's events
    replayed by the native engine) gives the four protocols' goldens, and
    so does device_align, whose jobs K2 scores on the device up to
    align_jcap = 256 a chunk, the rest natively (↔ tests/test_pipeline.py
    ::test_device_align_parity).  The engine is this test's own: the
    module's memoized engines hold a GB of tables each."""
    from abismal_tpu_torch.map import pipeline
    from abismal_tpu_torch.map.engine import run_map

    monkeypatch.setattr(pipeline, "_engine_memo", {})
    flag = "-P " if pbat else ""
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map {flag}-s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    fac = _factory(device_stage2=False, device_align=device_align,
                   align_jcap=256)
    eng = fac(port_index, False, 0.1, 32, 3000)
    jobs = []
    phase1 = "_phase1_pe" if paired else "_phase1_se"
    inner = getattr(eng.native, phase1)

    def counted(*args):
        n, j = inner(*args)
        jobs.append(n)
        return n, j

    monkeypatch.setattr(eng.native, phase1, counted)
    a0 = eng.n_device_aligned
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    run_map(port_index, golden_file(prefix + "_1.fq"),
            golden_file(prefix + "_2.fq") if paired else None, str(sam),
            str(mst), cl, pbat=pbat, engine_factory=fac, threads=2)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")
    aligned = eng.n_device_aligned - a0
    if device_align:  # the device scored jobs, the native side the rest
        assert 0 < aligned < sum(jobs)
    else:
        assert aligned == 0 and not jobs


def _long_reads(index, n=64, length=250):
    """n bisulfite-converted substrings of tRex1 of `length` bases."""
    from abismal_tpu_torch.utils.dna import unpack_nibbles_u64

    nib = unpack_nibbles_u64(index.genome_words, index.genome_size)
    nib_to_char = np.frombuffer(b"ZACMGRSVTWYHKDBN", dtype=np.uint8)
    rng = np.random.default_rng(5)
    reads = []
    for i in range(n):
        p = int(rng.integers(40000, index.genome_size - 40000))
        seq = bytearray(nib_to_char[nib[p : p + length]].tobytes().replace(
            b"Z", b"A"))
        for j in range(len(seq)):
            if seq[j : j + 1] == b"C" and rng.random() < 0.98:
                seq[j] = ord("T")
        reads.append((f"r{i}", bytes(seq)))
    return reads


@pytest.mark.parametrize("device_stage2", [False, True],
                         ids=["events", "fused"])
def test_lmax_256_long_reads(port_index, monkeypatch, device_stage2):
    """250-base reads with lmax = 256 (↔ tests/test_pipeline.py::
    test_lmax_long_reads_zero_fallback) give the native engine's bytes and
    stats; on the event route no unit falls back.  A budget of 256
    candidates a unit holds them all."""
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.map.stats import SEStats

    monkeypatch.setenv("ABISMAL_TPU_CAND_PER_UNIT", "256")
    reads = _long_reads(port_index)
    port = TorchNativeEngine(port_index, lmax=256, unit_batch=128,
                             n_threads=2, device="cpu",
                             device_stage2=device_stage2)
    outs = []
    for eng in (port, NativeMappingEngine(port_index, n_threads=2)):
        out, st = io.StringIO(), SEStats()
        eng.map_se_reads(reads, False, False, st, out)
        outs.append((out.getvalue(), st.__dict__))
    assert outs[0] == outs[1]
    assert outs[1][1]["reads_mapped_unique"] > 48
    assert port.n_units == 128
    if not device_stage2:
        assert port.n_fallback == 0, "long reads fell back to the host path"


@pytest.fixture(scope="module")
def synth_index(tmp_path_factory):
    """The port's index of a random 400 kb genome (A, C, G, T alone)."""
    from abismal_tpu_torch.index.build import create_index

    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT"), size=400_000))
    fa = tmp_path_factory.mktemp("synth") / "synth.fa"
    fa.write_text(">chr1\n" + "\n".join(seq[i : i + 70] for i in
                                         range(0, len(seq), 70)) + "\n")
    return create_index(str(fa))


@pytest.mark.parametrize("lmax", [160, 128])
@pytest.mark.parametrize("device_stage2", [False, True],
                         ids=["events", "fused"])
def test_lmax_160_pe_150bp_pairs(synth_index, device_stage2, lmax):
    """2x150 bp directional pairs give the native engine's SAM and stats
    on both PE routes.  At lmax 160 every unit stays on the device (the
    fused route mates every orientation there); at lmax 128 every mate is
    too long, so every unit goes to the host and every mate is counted
    oversized."""
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.map.stats import PEStats

    r1, r2 = bs_pairs(synth_index, n=96)
    port = TorchNativeEngine(synth_index, lmax=lmax, unit_batch=128,
                             n_threads=2, device="cpu",
                             device_stage2=device_stage2)
    outs = []
    for eng in (port, NativeMappingEngine(synth_index, n_threads=2)):
        out, st = io.StringIO(), PEStats()
        eng.map_pe_reads(r1, r2, False, False, st, out)
        outs.append((out.getvalue(), st.tostring(False)))
    port.close()
    assert outs[0] == outs[1]
    assert outs[1][0].count("\tNM:i:") > 180
    assert port.n_units == 4 * 96
    if lmax == 160:
        assert port.n_fallback == 0 and port.n_oversized == 0
        assert port.native.n_device_mated == (192 if device_stage2 else 0)
    else:
        assert port.n_fallback == port.n_units
        assert port.n_oversized == 192
