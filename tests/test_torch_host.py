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
    return out


def test_numpy_helpers_agree(port_index):
    """win_start, pack_genome_u32, o_spec_for, ext_iters_for,
    estimate_cand_budget, _resolve_cand_budget, _ascii_matrices, the
    strand-code and conversion patterns and get_conv_is_ga: equal results
    through both packages."""
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


def test_run_map_refuses_other_engines(port_index):
    """The port's run_map takes native-library engines only; the JAX
    package's pure-Python reference engine is not carried over."""
    from abismal_tpu_torch.map.engine import run_map

    with pytest.raises(ValueError, match="native engine factory"):
        run_map(port_index, "r.fq", None, "o.sam", None, "cl")


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
