"""The port's candidate core and fused stage-1+2 program against the JAX
package's on the same chunk of golden reads: the JAX DeviceIndex's exact
tables are handed to the port (DeviceIndex.from_numpy_tables), and every
output is compared exactly (integer arithmetic, tolerance 0).  JAX runs
on the CPU with its Pallas kernels in interpret mode, as its own tests
run it."""

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    golden_file, port_index, release_engines,
)

jax = pytest.importorskip("jax")

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

LMAX = 128


@pytest.fixture(scope="module")
def tables(port_index):
    from abismal_tpu.map.pipeline import DeviceIndex as JaxDeviceIndex
    from abismal_tpu_torch.map.pipeline import DeviceIndex

    jdev = JaxDeviceIndex(port_index)
    g32, _g2o, c2, c3, idx = (np.asarray(t) for t in jdev.tables())
    tdev = DeviceIndex.from_numpy_tables(
        g32, c2, c3, idx, jdev.n_index2, jdev.n_index3, jdev.max_candidates,
        jdev.ext_iters, "cpu")
    return jdev, tdev


def _units(first, n_reads, a_rich=False, random_pbat=False):
    """One chunk of small_1.fq reads as the engine lays it out."""
    from abismal_tpu_torch.io.fastq import ReadLoader
    from abismal_tpu.map.pipeline import TpuNativeEngine
    from abismal_tpu.map.seeds import get_conv_is_ga
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    reads = ReadLoader(golden_file("small_1.fq")).load_batch()
    reads = reads[first : first + n_reads]

    class _Shape:
        lmax = LMAX

    pnib, lens, per, _ = TorchNativeEngine._se_units_mat(
        _Shape(), reads, a_rich, random_pbat)
    scode = TpuNativeEngine._se_scode_pattern(a_rich, random_pbat)
    is_ga = np.tile([get_conv_is_ga(int(c)) for c in scode], len(reads))
    md = (0.1 * lens.reshape(-1, per).max(axis=1).astype(np.float64)
          ).astype(np.int32)
    return pnib, lens, is_ga, scode, md, per


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_device_index_from_numpy_tables(port_index, tables):
    """JAX's i32 pair tables, re-read as u32 prefix arrays, equal the
    port's own tables built from the index."""
    from abismal_tpu_torch.map.pipeline import DeviceIndex

    _, tdev = tables
    own = DeviceIndex.from_index(port_index, "cpu")
    for a, b in zip(tdev.tables(), own.tables()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (tdev.n_index2, tdev.n_index3, tdev.max_candidates,
            tdev.ext_iters) == (own.n_index2, own.n_index3,
                                own.max_candidates, own.ext_iters)


@pytest.mark.parametrize("max_cand,ext_pool,cand", [
    (None, None, 64),  # the index's max_candidates, static pool
    (2, 512, 64),  # tiny buckets: the seed extension runs on many cells
    (2, 16, 64),  # ... through a pool that spills (ext_fb fallback flags)
    (None, None, 256),  # a list mostly past its last candidate (K6's tail)
    (2, 512, 4),  # more candidates than the list holds (total > gflat)
], ids=["None-None", "2-512", "2-16", "tail", "over-gflat"])
def test_make_core_matches_jax(tables, max_cand, ext_pool, cand):
    from abismal_tpu.map.pipeline import _make_core as jax_core
    from abismal_tpu_torch.map.pipeline import _make_core

    jdev, tdev = tables
    mc = max_cand or jdev.max_candidates
    pnib, lens, is_ga, _, _, _ = _units(0, 64)
    uextra = np.zeros((pnib.shape[0], 3), np.int32)
    core_j, _ = jax_core(LMAX, mc, jdev.n_index2, jdev.n_index3, cand,
                         tp=False, ext_iters=jdev.ext_iters,
                         ext_pool=ext_pool)
    want = jax.jit(core_j)(*jdev.tables(), pnib, lens, is_ga, uextra)
    core_t, _ = _make_core(LMAX, mc, jdev.n_index2, jdev.n_index3, cand,
                           ext_iters=jdev.ext_iters, ext_pool=ext_pool)
    got = core_t(*tdev.tables(), *_t(pnib, lens, is_ga, uextra))
    for k in ("pos", "d", "valid", "unit_total", "overflow", "b_of",
              "cell_of", "slot", "unit_start"):
        w = np.asarray(want[k]).astype(np.int64)
        if k == "pos":
            w &= 0xFFFFFFFF
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64), w,
                                      err_msg=k)
    if ext_pool == 16:  # the inputs must reach the extension and spill
        assert int(np.asarray(want["overflow"]).sum()) > 0
    total, gflat = int(got["unit_total"].sum()), pnib.shape[0] * cand
    if cand == 256:  # the tail: most of the list past the last candidate
        assert 0 < total < gflat // 2
    if cand == 4:  # units past the list's end, and one across it
        assert total > gflat
        assert int((got["unit_start"] < gflat).sum()) < pnib.shape[0]


def test_make_core_noext_matches_jax(tables, monkeypatch):
    """ABISMAL_TPU_NOEXT, the profiling variant without the seed
    extension, read when the core is built: the port's core equals JAX's
    NOEXT core, and with max_candidates 2, where the extension runs on
    many cells, differs from the port's extended core."""
    from abismal_tpu.map.pipeline import _make_core as jax_core
    from abismal_tpu_torch.map.pipeline import _make_core

    jdev, tdev = tables
    pnib, lens, is_ga, _, _, _ = _units(0, 64)
    uextra = np.zeros((pnib.shape[0], 3), np.int32)
    args = (LMAX, 2, jdev.n_index2, jdev.n_index3, 64)
    monkeypatch.setenv("ABISMAL_TPU_NOEXT", "1")
    core_j, _ = jax_core(*args, tp=False, ext_iters=jdev.ext_iters)
    want = jax.jit(core_j)(*jdev.tables(), pnib, lens, is_ga, uextra)
    core_t, _ = _make_core(*args, ext_iters=jdev.ext_iters)
    monkeypatch.delenv("ABISMAL_TPU_NOEXT")
    ext_t, _ = _make_core(*args, ext_iters=jdev.ext_iters)
    targs = (*tdev.tables(), *_t(pnib, lens, is_ga, uextra))
    got, ext = core_t(*targs), ext_t(*targs)
    for k in ("pos", "d", "valid", "unit_total", "overflow", "b_of",
              "cell_of", "slot", "unit_start"):
        w = np.asarray(want[k]).astype(np.int64)
        if k == "pos":
            w &= 0xFFFFFFFF
        np.testing.assert_array_equal(got[k].numpy().astype(np.int64), w,
                                      err_msg=k)
    assert not torch.equal(got["unit_total"], ext["unit_total"])


@pytest.mark.parametrize("first,a_rich,random_pbat", [
    (0, False, False),
    (64, True, False),
    (128, False, True),
])
def test_stage12_packed_rows_match_jax(tables, first, a_rich, random_pbat):
    """build_stage12(device_tb=True) packed (R, 8 + TB_NOPS) rows equal
    the JAX program's on a 128-unit chunk (unit_batch=128)."""
    from abismal_tpu.map.pipeline import build_stage12 as jax_stage12
    from abismal_tpu_torch.map.pipeline import build_stage12

    jdev, tdev = tables
    n_reads = 32 if random_pbat else 64
    pnib, lens, is_ga, scode, md, per = _units(first, n_reads, a_rich,
                                               random_pbat)
    cand = 56  # distinct from other tests' budgets: a fresh JAX program
    prog_j, _ = jax_stage12(LMAX, jdev.max_candidates, jdev.n_index2,
                            jdev.n_index3, per, cand_per_unit=cand,
                            interpret=True, ext_iters=jdev.ext_iters,
                            device_tb=True)
    want = np.asarray(prog_j(*jdev.tables(), pnib, lens, is_ga, scode, md))
    prog_t, _ = build_stage12(LMAX, jdev.max_candidates, jdev.n_index2,
                              jdev.n_index3, per, cand_per_unit=cand,
                              ext_iters=jdev.ext_iters, device_tb=True)
    got = prog_t(*tdev.tables(), *_t(pnib, lens, is_ga, scode, md)).numpy()
    np.testing.assert_array_equal(got, want)
    status = want[:, 0] & 7
    assert (status == 2).sum() > 0 and (want[:, 4] > 0).sum() > 0


CUT_INPUTS = {"plain": (0, False, False), "a_rich": (64, True, False),
              "random_pbat": (128, False, True)}
# the core's extension arrays, with the extension through a pool that
# spills: max_candidates 2, a pool of 16 lanes (ext_fb fallback flags)
SPILL = (2, 16)


def _cut_cases():
    from abismal_tpu_torch.map.pipeline import SE_CUTS

    cases = [(cut, inputs, False) for cut in SE_CUTS + ("extdbg",)
             for inputs in CUT_INPUTS]
    return cases + [(cut, "plain", True)
                    for cut in ("extend", "extdbg", "unitstats", "fbstats")]


@pytest.mark.parametrize("cut,inputs,spill", _cut_cases())
def test_stage12_cuts_match_jax(tables, cut, inputs, spill):
    """Every profiling and diagnostic cut of build_stage12 (the core's
    through it, and extdbg through _make_core, as JAX's tools reach them)
    returns the JAX program's i32 values on a 128-unit chunk, exactly."""
    from abismal_tpu.map.pipeline import _make_core as jax_core
    from abismal_tpu.map.pipeline import build_stage12 as jax_stage12
    from abismal_tpu_torch.map.pipeline import _make_core, build_stage12

    jdev, tdev = tables
    first, a_rich, random_pbat = CUT_INPUTS[inputs]
    n_reads = 32 if random_pbat else 64
    pnib, lens, is_ga, scode, md, per = _units(first, n_reads, a_rich,
                                               random_pbat)
    mc, ext_pool = SPILL if spill else (jdev.max_candidates, None)
    cand = 60  # a budget no other test of this module builds
    if cut == "extdbg":
        uextra = np.zeros((pnib.shape[0], 3), np.int32)
        core_j, _ = jax_core(LMAX, mc, jdev.n_index2, jdev.n_index3, cand,
                             tp=False, cut=cut, ext_iters=jdev.ext_iters,
                             ext_pool=ext_pool)
        want = jax.jit(core_j)(*jdev.tables(), pnib, lens, is_ga, uextra)
        core_t, _ = _make_core(LMAX, mc, jdev.n_index2, jdev.n_index3, cand,
                               ext_iters=jdev.ext_iters, ext_pool=ext_pool,
                               cut=cut)
        got = core_t(*tdev.tables(), *_t(pnib, lens, is_ga, uextra))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == (torch.bool if k == "ext_fb"
                                    else torch.int32), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                          err_msg=k)
        if spill:
            assert np.asarray(want["ext_fb"]).any()
        return
    prog_j, _ = jax_stage12(LMAX, mc, jdev.n_index2, jdev.n_index3, per,
                            cand_per_unit=cand, interpret=True, cut=cut,
                            ext_iters=jdev.ext_iters, ext_pool=ext_pool)
    want = np.asarray(prog_j(*jdev.tables(), pnib, lens, is_ga, scode, md))
    prog_t, _ = build_stage12(LMAX, mc, jdev.n_index2, jdev.n_index3, per,
                              cand_per_unit=cand, ext_iters=jdev.ext_iters,
                              ext_pool=ext_pool, cut=cut)
    got = prog_t(*tdev.tables(), *_t(pnib, lens, is_ga, scode, md)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if cut != "fbstats":  # a_rich reads, T-rich, decide nothing here
        assert want.any()
    elif spill:  # the pool's spills reach fbstats as unit fallbacks
        assert want[:, 0].any()


@pytest.fixture(scope="module")
def repeat_tables(tmp_path_factory):
    """The seed-extension check's repeat genome (buckets far above
    max_candidates; abismal_tpu_torch/tools/debug_ext.py): JAX's
    DeviceIndex and the port's on its exact tables, and the T-rich and
    A-rich units of its reads."""
    from abismal_tpu.map.pipeline import DeviceIndex as JaxDeviceIndex
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.map.host_units import (
        get_conv_is_ga, prepare_units, strand_code,
    )
    from abismal_tpu_torch.map.pipeline import DeviceIndex
    from abismal_tpu_torch.map.seeds import prep_read
    from abismal_tpu_torch.tools.debug_ext import ext_genome

    fa = str(tmp_path_factory.mktemp("repeat") / "ext_genome.fa")
    reads = ext_genome(fa)
    index = create_index(fa)
    jdev = JaxDeviceIndex(index)
    g32, _g2o, c2, c3, idx = (np.asarray(t) for t in jdev.tables())
    tdev = DeviceIndex.from_numpy_tables(
        g32, c2, c3, idx, jdev.n_index2, jdev.n_index3, jdev.max_candidates,
        jdev.ext_iters, "cpu")
    units, is_ga = [], []
    for r in reads:
        for a_rich in (False, True):
            units.append(prep_read(r, a_rich))
            is_ga.append(get_conv_is_ga(strand_code("+", a_rich)))
    pnib, lens = prepare_units(units, LMAX)
    return jdev, tdev, (pnib, lens, np.array(is_ga))


@pytest.mark.parametrize("genome,ways", [
    pytest.param("repeat", w, id=str(w)) for w in (2, 4, 8)] + [
    pytest.param("trex1", w, id=f"trex1-{w}") for w in (2, 4, 8)])
def test_extdbg_repeat_genome_matches_jax(repeat_tables, tables, monkeypatch,
                                          genome, ways):
    """The extension's per-cell arrays (the "extdbg" cut, K4's plain
    version on the CPU) equal JAX's on oversized buckets, with the k-ary
    search at ways 2, 4 and 8 (ABISMAL_TPU_EXT_WAYS, read when each core
    is built and traced): on the repeat genome, and on tRex1 golden reads
    at max_candidates 2.  K4's plain version, called on the arguments the
    core hands it, gives JAX's cells and ext_fb too."""
    from abismal_tpu.map.pipeline import _make_core as jax_core
    from abismal_tpu_torch.constants import KEY_WEIGHT, KEY_WEIGHT_THREE
    from abismal_tpu_torch.kernels.seed_extend import seed_extend_plain
    from abismal_tpu_torch.map import pipeline as pl
    from abismal_tpu_torch.map.pipeline import u32_to_i32

    if genome == "repeat":
        jdev, tdev, (pnib, lens, is_ga) = repeat_tables
        mc = jdev.max_candidates
    else:
        jdev, tdev = tables
        pnib, lens, is_ga, _, _, _ = _units(0, 64)
        mc = 2
    monkeypatch.setenv("ABISMAL_TPU_EXT_WAYS", str(ways))
    uextra = np.zeros((pnib.shape[0], 3), np.int32)
    core_j, _ = jax_core(LMAX, mc, jdev.n_index2, jdev.n_index3, 64,
                         tp=False, cut="extdbg", ext_iters=jdev.ext_iters)
    want = jax.jit(core_j)(*jdev.tables(), pnib, lens, is_ga, uextra)
    core_t, _ = pl._make_core(LMAX, mc, jdev.n_index2, jdev.n_index3, 64,
                              ext_iters=jdev.ext_iters, cut="extdbg")
    seen, inner = [], pl.seed_extend

    def record(*args):
        seen.append(args)
        return inner(*args)

    monkeypatch.setattr(pl, "seed_extend", record)
    got = core_t(*tdev.tables(), *_t(pnib, lens, is_ga, uextra))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
    (args,) = seen
    assert args[15] == ways
    cells = seed_extend_plain(*args)
    for k, c in zip(("l2", "s2x", "e2x", "l3", "s3x", "e3x", "ext_fb"),
                    cells):
        c = c if k == "ext_fb" else u32_to_i32(c)
        np.testing.assert_array_equal(c.numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # oversized buckets were searched and narrowed (the tandem repeats
    # give two-letter ones: 228 cells here; tRex1 three-letter ones)
    big = np.asarray(want["e2"]) - np.asarray(want["s2"]) > mc
    if genome == "repeat":
        assert big.sum() > 100
        assert (np.asarray(want["l2"])[big] > KEY_WEIGHT).all()
    else:
        big3 = np.asarray(want["e3"]) - np.asarray(want["s3"]) > mc
        assert big.sum() + big3.sum() > 50  # 61 cells here
        assert (np.asarray(want["l3"])[big3] > KEY_WEIGHT_THREE).sum() > 40
