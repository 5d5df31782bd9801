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


@pytest.mark.parametrize("max_cand,ext_pool", [
    (None, None),  # the index's max_candidates, static pool
    (2, 512),  # tiny buckets: the seed extension runs on many cells
    (2, 16),  # ... through a pool that spills (ext_fb fallback flags)
])
def test_make_core_matches_jax(tables, max_cand, ext_pool):
    from abismal_tpu.map.pipeline import _make_core as jax_core
    from abismal_tpu_torch.map.pipeline import _make_core

    jdev, tdev = tables
    mc = max_cand or jdev.max_candidates
    pnib, lens, is_ga, _, _, _ = _units(0, 64)
    uextra = np.zeros((pnib.shape[0], 3), np.int32)
    cand = 64
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
