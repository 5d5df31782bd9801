"""The port's own host side against the JAX package's, on the CPU and
exact: constants and static limits equal name by name, the NumPy helpers
give equal arrays on seeded inputs through both packages, and the port's
index build, read simulator, native engine and sharding helpers give the
goldens or the JAX package's bytes."""

import gzip
import os

import numpy as np
import pytest

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, TREX1_FA, golden_file, md5_file, port_index, release_engines,
)


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def test_constants_equal():
    """Every public name of abismal_tpu.constants has the same value in
    the port's copy, and the port adds none."""
    import abismal_tpu.constants as ref
    import abismal_tpu_torch.constants as own

    def public(mod):
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("_") and not isinstance(v, type(os))}

    want, got = public(ref), public(own)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        else:
            assert got[name] == value, name


@pytest.mark.parametrize("name,ref_mod,own_mod", [
    ("BW_MAX", "kernels.banded_align", "kernels.banded_align"),
    ("QOFF", "kernels.banded_align", "kernels.banded_align"),
    ("BAND", "kernels.banded_align", "kernels.banded_align"),
    ("NEG", "kernels.banded_align", "kernels.banded_align"),
    ("ALN_MATCH", "kernels.banded_align", "kernels.banded_align"),
    ("ALN_MISMATCH", "kernels.banded_align", "kernels.banded_align"),
    ("ALN_INDEL", "kernels.banded_align", "kernels.banded_align"),
    ("TB_NOPS", "map.pipeline", "map.host_units"),
    ("SLOT", "map.pipeline", "map.host_units"),
    ("DEVICE_MIN_LEN", "map.pipeline", "map.host_units"),
    ("HASH3_MOD", "map.pipeline", "map.host_units"),
    ("REC_FALLBACK", "map.pipeline", "map.host_units"),
])
def test_static_limits_equal(name, ref_mod, own_mod):
    import importlib

    ref = importlib.import_module("abismal_tpu." + ref_mod)
    own = importlib.import_module("abismal_tpu_torch." + own_mod)
    assert getattr(own, name) == getattr(ref, name)


def _small_units(n=64):
    """Encoded units of the first reads of small_1.fq: (units, is_ga)."""
    from abismal_tpu_torch.io.fastq import ReadLoader
    from abismal_tpu_torch.utils.dna import ENCODE_A_RICH, ENCODE_T_RICH

    reads = ReadLoader(golden_file("small_1.fq")).load_batch()[:n]
    units, is_ga = [], []
    for i, (_, seq) in enumerate(reads):
        enc = ENCODE_A_RICH if i % 2 else ENCODE_T_RICH
        units.append(enc[np.frombuffer(seq, dtype=np.uint8)])
        is_ga.append(bool(i % 2))
    return units, is_ga


def _helper_results(pkg, index):
    """The NumPy helpers of one package (pkg: module path -> module) on
    seeded inputs, as a dict of arrays and scalars."""
    ba = pkg("kernels.banded_align")
    helpers = pkg("map.pipeline" if pkg.ref else "map.host_units")
    seeds = pkg("map.seeds" if pkg.ref else "map.host_units")
    statics = helpers.TpuNativeEngine if pkg.ref else helpers
    rng = np.random.default_rng(11)
    out = {}
    pos = rng.integers(0, 1 << 32, 500).astype(np.int64)
    bw = 2 * rng.integers(0, 31, 500).astype(np.int64) + 1
    out["win_start"] = ba.win_start(pos, bw)
    words = rng.integers(0, 1 << 63, 777, dtype=np.uint64)
    out["pack_genome_u32"] = helpers.pack_genome_u32(words)
    out["pack_genome_u32/guard"] = helpers.pack_genome_u32(words, guard=3)
    out["o_spec_for"] = [helpers.o_spec_for(m) for m in (64, 100, 128, 256)]
    out["ext_iters_for"] = helpers.ext_iters_for(index)
    units, is_ga = _small_units()
    counters = (index.counter, index.counter_t, index.counter_a)
    out["estimate_cand_budget"] = helpers.estimate_cand_budget(
        counters, index.max_candidates, units, is_ga, 128)
    out["estimate_cand_budget/none"] = helpers.estimate_cand_budget(
        counters, index.max_candidates, [u[:20] for u in units], is_ga, 128)
    out["_resolve_cand_budget"] = [
        helpers._resolve_cand_budget(None, 10 ** 8, 3 * 10 ** 8, 128),
        helpers._resolve_cand_budget(96, 1, 1, 128)]
    seqs = [bytes(rng.choice(list(b"ACGTN"), int(n)).astype(np.uint8))
            for n in rng.integers(0, 129, 40)]
    seqs[3] = b""
    A, Arc, lens = statics._ascii_matrices(seqs, 128)
    out["_ascii_matrices/A"], out["_ascii_matrices/Arc"] = A, Arc
    out["_ascii_matrices/lens"] = lens
    for arm in (False, True):
        for rp in (False, True):
            out[f"scode/{arm}/{rp}"] = statics._se_scode_pattern(arm, rp)
            out[f"is_ga/{arm}/{rp}"] = statics._pe_is_ga_pattern(arm, rp)
    out["get_conv_is_ga"] = [seeds.get_conv_is_ga(c)
                             for c in (0, 0x10, 0x1000, 0x1010)]
    pnib, plens = helpers.prepare_units(units + [units[0][:0]], 128)
    out["prepare_units/pnib"], out["prepare_units/lens"] = pnib, plens
    return out


def test_numpy_helpers_agree(port_index):
    """win_start, pack_genome_u32, o_spec_for, ext_iters_for,
    estimate_cand_budget, _resolve_cand_budget, _ascii_matrices, the
    strand-code and conversion patterns, get_conv_is_ga and prepare_units:
    equal results through both packages."""
    import importlib

    def package(name, ref):
        def pkg(mod):
            return importlib.import_module(f"{name}.{mod}")
        pkg.ref = ref
        return pkg

    want = _helper_results(package("abismal_tpu", True), port_index)
    got = _helper_results(package("abismal_tpu_torch", False), port_index)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def test_index_build_gives_golden_md5(tmp_path):
    """The port's create_index + write_index write the golden index bytes,
    and both packages read the file back to equal tables."""
    from abismal_tpu.index.serialize import read_index as ref_read
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.index.serialize import read_index, write_index

    out = str(tmp_path / "tRex1.idx")
    write_index(create_index(TREX1_FA), out)
    with open(os.path.join(GOLDEN, "tRex1.idx.md5")) as f:
        assert md5_file(out) == f.read().strip()
    own, ref = read_index(out), ref_read(out)
    for name in ("genome_words", "counter", "counter_t", "counter_a",
                 "index", "index_t", "index_a"):
        np.testing.assert_array_equal(getattr(own, name), getattr(ref, name),
                                      err_msg=name)
    assert own.genome_size == ref.genome_size
    assert own.max_candidates == ref.max_candidates
    assert own.cl.names == ref.cl.names
    np.testing.assert_array_equal(own.cl.starts, ref.cl.starts)


@pytest.mark.parametrize("kwargs", [
    dict(single_end=True), dict(), dict(pbat=True), dict(random_pbat=True),
], ids=["single", "pe", "pbat", "rpbat"])
def test_simulate_reads_matches_jax_package(tmp_path, kwargs):
    """The port's simulate_reads writes the JAX package's FASTQ bytes for
    one seed."""
    from abismal_tpu.sim import simreads as ref
    from abismal_tpu_torch.sim import simreads as own

    for mod, name in ((ref, "ref"), (own, "own")):
        mod.simulate_reads(TREX1_FA, mod.SimConfig(
            output_prefix=str(tmp_path / name), n_reads=400,
            mutation_rate=0.02, bs_conv=0.97, seed=5, **kwargs))
    ends = ["_1.fq"] if kwargs.get("single_end") else ["_1.fq", "_2.fq"]
    for end in ends:
        got = (tmp_path / ("own" + end)).read_bytes()
        assert got and got == (tmp_path / ("ref" + end)).read_bytes()


@pytest.mark.parametrize("prefix", ["small", "small_pe"])
def test_native_factory_gives_the_goldens(tmp_path, port_index, prefix):
    """The port's native engine (its own copy of the C++ library, built
    into build/) through the port's run_map: golden SAM and mstats, byte
    for byte."""
    from abismal_tpu_torch import native
    from abismal_tpu_torch.map.engine import run_map
    from abismal_tpu_torch.map.host_units import make_native_engine_factory

    paired = prefix.endswith("_pe")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    sam, mst = tmp_path / "o.sam", tmp_path / "o.mstats"
    run_map(port_index, golden_file(prefix + "_1.fq"), fq2, str(sam),
            str(mst), cl, engine_factory=make_native_engine_factory(2),
            threads=2)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")
    # the libraries are built outside the package directory
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert [f for f in os.listdir(native.BUILD_DIR)
            if f.startswith("_engine-") and f.endswith(".so")]


def test_native_engine_reused_with_fewer_threads(port_index):
    """One native engine maps SE reads with 2 threads, then pairs with 1:
    the second call's stats count its own reads only (the idle worker of
    the first call starts every call at zero)."""
    import io

    from abismal_tpu_torch.io.fastq import ReadLoader
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.stats import PEStats, SEStats

    def reads(name):
        return ReadLoader(golden_file(name)).load_batch()

    eng = NativeMappingEngine(port_index, n_threads=2)
    se, out = SEStats(), io.StringIO()
    eng.map_se_reads(reads("small_1.fq"), False, False, se, out)
    assert se.total_reads == 500
    eng.n_threads = 1
    pe = PEStats()
    eng.map_pe_reads(reads("small_pe_1.fq"), reads("small_pe_2.fq"), False,
                     False, pe, out)
    assert pe.read_pair_stats.total_reads == 500
    fresh = PEStats()
    NativeMappingEngine(port_index, n_threads=1).map_pe_reads(
        reads("small_pe_1.fq"), reads("small_pe_2.fq"), False, False, fresh,
        io.StringIO())
    for blk in ("read_pair_stats", "end1_stats", "end2_stats"):
        assert vars(getattr(pe, blk)) == vars(getattr(fresh, blk)), blk
    # and back up: SE with 2 threads after the 1-thread call
    eng.n_threads = 2
    se2 = SEStats()
    eng.map_se_reads(reads("small_1.fq"), False, False, se2, io.StringIO())
    assert vars(se2) == vars(se)


@pytest.mark.parametrize("engine", ["tpu", "tpu-replay", "jax"])
def test_run_map_refuses_other_engines(port_index, tmp_path, capsys,
                                       engine):
    """The port's `map` refuses an --engine of its own list's outside
    (torch, hybrid, native, exact, torch-replay: the JAX package's tpu
    and tpu-replay are torch and torch-replay here), while run_map runs
    every engine the JAX package's does: without a factory the exact
    Python engine (MappingEngine) maps the reads."""
    from abismal_tpu_torch.cli import main
    from abismal_tpu_torch.map.engine import run_map

    with pytest.raises(SystemExit):
        main(["map", "--engine", engine, "-o", "o.sam", "-i", "x.idx",
              "r.fq"])
    assert "invalid choice" in capsys.readouterr().err
    fq = tmp_path / "r.fq"
    fq.write_text("@r1\n" + "ACGT" * 25 + "\n+\n" + "I" * 100 + "\n")
    stats = run_map(port_index, str(fq), None, str(tmp_path / "o.sam"),
                    None, "cl")
    assert stats.total_reads == 1


def test_shard_helpers_agree(tmp_path):
    """shard_bounds, count_reads (plain, gzipped, no final newline) and
    gather: the port's equal the JAX package's."""
    from abismal_tpu.parallel import multihost as ref
    from abismal_tpu_torch.parallel import multihost as own

    for total in (0, 1, 7, 500, 10001):
        for n in (1, 2, 3, 8):
            assert own.shard_bounds(total, n) == ref.shard_bounds(total, n)
    fq = golden_file("small_1.fq")
    data = open(fq, "rb").read()
    cut = tmp_path / "cut.fq"
    cut.write_bytes(data.rstrip(b"\n"))
    gz = tmp_path / "small.fq.gz"
    with gzip.open(gz, "wb") as f:
        f.write(data)
    for path in (fq, str(cut), str(gz)):
        assert own.count_reads(path) == ref.count_reads(path) == 500
    parts = []
    for i, chunk in enumerate((data[:1000], b"", data[1000:])):
        parts.append(str(tmp_path / f"part{i}"))
        open(parts[-1], "wb").write(chunk)
    own.gather(parts, str(tmp_path / "own"))
    ref.gather(parts, str(tmp_path / "ref"))
    assert (tmp_path / "own").read_bytes() == data
    assert (tmp_path / "ref").read_bytes() == data
    assert own._SE_FIELDS == ref._SE_FIELDS


def _revcomp_iupac(s):
    return s[::-1].translate(str.maketrans("ACGTRYKMSWBDHVN",
                                           "TGCAYRMKSWVHDBN"))


def test_iupac_genome_indexes_and_maps_as_native(tmp_path):
    """A genome with Y, R and W spots (and every IUPAC code but N): the
    port's create_index writes the JAX package's bytes, and pairs and
    single reads from it map through the port's native engine as through
    the JAX package's, and through the device engine's event route as
    through the port's native engine.  The fused route maps the single
    reads as the native engine does and the pairs as the JAX package's
    fused route does: its mating sweep scores the negative bands of IUPAC
    diffs 0 where the native engine takes the whole band, so on such a
    genome both differ from the native engine (ROADMAP.md section 3)."""
    import io

    from abismal_tpu.index.build import create_index as ref_create_index
    from abismal_tpu.index.serialize import read_index as ref_read_index
    from abismal_tpu.index.serialize import write_index as ref_write_index
    from abismal_tpu.map.native_engine import (
        NativeMappingEngine as RefNativeEngine,
    )
    from abismal_tpu.map.pipeline import TpuNativeEngine
    from abismal_tpu.map.stats import PEStats as RefPEStats
    from abismal_tpu.map.stats import SEStats as RefSEStats
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.index.serialize import write_index
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.map.stats import PEStats, SEStats

    rng = np.random.default_rng(11)
    n = 120_000
    seq = rng.choice(list("ACGT"), size=n)
    # no N spots: with N and Y spots both, pairs decided on the device
    # report NM one off the native engine's (the JAX program too;
    # ROADMAP.md section 3)
    for code, k in (("Y", 3000), ("R", 300), ("W", 300), ("K", 200),
                    ("M", 200), ("S", 200), ("B", 200), ("D", 200),
                    ("H", 200), ("V", 200)):
        seq[rng.integers(200, n - 200, k)] = code
    fa = tmp_path / "iupac.fa"
    with open(fa, "w") as f:
        f.write(">chrI\n")
        text = "".join(seq)
        for i in range(0, n, 70):
            f.write(text[i : i + 70] + "\n")
    index = create_index(str(fa))
    write_index(index, str(tmp_path / "own.idx"))
    ref_write_index(ref_create_index(str(fa)), str(tmp_path / "ref.idx"))
    assert (md5_file(str(tmp_path / "own.idx"))
            == md5_file(str(tmp_path / "ref.idx")))
    # reads carry bases only: C to T (bisulfite), each IUPAC code to a
    # base it stands for
    conv = str.maketrans("CYRWKMSBDHV", "TTATGATTAAA")
    reads, r1, r2 = [], [], []
    for i in range(200):
        p = int(rng.integers(200, n - 600))
        frag = "".join(seq[p : p + 300]).translate(conv)
        reads.append((f"r{i}", frag[:100].encode()))
        r1.append((f"p{i}", frag[:100].encode()))
        r2.append((f"p{i}", _revcomp_iupac(frag[-100:]).encode()))

    def mapped(eng, se_stats, pe_stats):
        o1, st1 = io.StringIO(), se_stats()
        eng.map_se_reads(reads, False, False, st1, o1)
        o2, st2 = io.StringIO(), pe_stats()
        eng.map_pe_reads(r1, r2, False, False, st2, o2)
        return o1.getvalue(), st1.tostring("reads"), o2.getvalue(), \
            st2.tostring(False)

    want = mapped(NativeMappingEngine(index, n_threads=2), SEStats, PEStats)
    ref_index = ref_read_index(str(tmp_path / "ref.idx"))
    ref = mapped(RefNativeEngine(ref_index, n_threads=2), RefSEStats,
                 RefPEStats)
    assert want == ref
    assert want[2].count("\t99\t") > 100  # pairs mapped as pairs
    # one engine (a GB of tables) at a time
    assert mapped(TorchNativeEngine(
        index, unit_batch=256, n_threads=2, device="cpu",
        device_stage2=False), SEStats, PEStats) == want
    fused = mapped(TorchNativeEngine(index, unit_batch=256, n_threads=2,
                                     device="cpu", device_stage2=True),
                   SEStats, PEStats)
    assert fused[:2] == want[:2]
    ref_fused = mapped(TpuNativeEngine(ref_index, unit_batch=256,
                                       n_threads=2, device_stage2=True),
                       RefSEStats, RefPEStats)
    assert fused[2:] == ref_fused[2:]
    assert fused[2] != want[2]  # the pairs reach negative bands


def test_create_index_reduces_three_letter_keys(tmp_path):
    """IUPAC codes give the three-letter alphabets a fourth symbol (R
    under C->T, Y under G->A), which can carry a 16-symbol key past 3^16.
    The native build reduces it modulo 3^16 as the rolling hash does: on a
    genome with runs of R and Y its index equals, byte for byte, the NumPy
    oracle builds of both packages, and each bucket table adds up to its
    position list.  (Unreduced, such keys were counted and placed past the
    ends of the tables: the heap fault once seen on IUPAC genomes.)"""
    from abismal_tpu.index.build import create_index as ref_create_index
    from abismal_tpu.index.serialize import write_index as ref_write_index
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.index.serialize import write_index

    rng = np.random.default_rng(5)
    n = 60_000
    seq = rng.choice(list("ACGT"), size=n)
    for s0 in rng.integers(100, n - 100, 200):
        seq[s0 : s0 + 20] = list("RY" * 10)
    fa = tmp_path / "ry.fa"
    with open(fa, "w") as f:
        f.write(">chrRY\n")
        text = "".join(seq)
        for i in range(0, n, 70):
            f.write(text[i : i + 70] + "\n")
    index = create_index(str(fa))
    for table, counter in ((index.index, index.counter),
                           (index.index_t, index.counter_t),
                           (index.index_a, index.counter_a)):
        assert int(counter[-1]) == table.shape[0]
    md5s = []
    for build, write, kw in ((create_index, write_index, {}),
                             (create_index, write_index,
                              {"numpy_build": True}),
                             (ref_create_index, ref_write_index,
                              {"numpy_build": True})):
        out = str(tmp_path / f"i{len(md5s)}.idx")
        write(index if not md5s else build(str(fa), **kw), out)
        md5s.append(md5_file(out))
    assert md5s[0] == md5s[1] == md5s[2]
