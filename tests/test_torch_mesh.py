"""Data parallelism in the port (abismal_tpu_torch/parallel/mesh.py) on the
CPU, with the plain kernel versions: the slot-split programs against the
JAX package's shard_map programs on a 2-device CPU mesh (interpret mode,
as tests/test_torch_stage12.py runs JAX), and whole `map` runs over a
2-slot CPU mesh against the goldens (↔ tests/test_multichip.py).  Every
comparison is exact equality: the outputs are integers."""

import gzip
import os

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, golden_file, port_index, release_engines,
)
from tests.test_torch_stage12 import _units
from tests.test_torch_stage12pe import _golden_pairs, _pe_units

jax = pytest.importorskip("jax")

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

LMAX = 128
CPU_MESH = ["cpu", "cpu"]


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


@pytest.fixture(scope="module")
def tables(port_index):
    from tests.test_torch_stage12pe import _tables

    return _tables(port_index)


def _jax_mesh():
    from abismal_tpu.parallel.mesh import make_mesh

    if jax.device_count() < 2:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    return make_mesh(2)


def test_shard_stage12_matches_jax(tables):
    """SE: the packed rows of 64 reads (128 units) over two slots, and
    the per-status decision counts summed over them, equal JAX's
    shard_stage12 over two CPU devices.  The budget of 12 candidates per
    unit overflows, so one pooled budget over the whole chunk gives other
    rows than the two per-slice pools."""
    from abismal_tpu.map.pipeline import build_stage12 as jax_stage12
    from abismal_tpu.parallel import mesh as jax_mesh
    from abismal_tpu_torch.map.pipeline import build_stage12
    from abismal_tpu_torch.parallel.mesh import make_mesh, shard_stage12

    jdev, tdev = tables
    mesh = _jax_mesh()
    pnib, lens, is_ga, scode, md, per = _units(0, 64)
    cand = 12
    prog_j, _ = jax_stage12(LMAX, jdev.max_candidates, jdev.n_index2,
                            jdev.n_index3, per, cand_per_unit=cand,
                            interpret=True, ext_iters=jdev.ext_iters,
                            device_tb=True)
    rec_j, counts_j = jax_mesh.shard_stage12(prog_j, mesh)(
        jax_mesh.replicate_tables(jdev, mesh), pnib, lens, is_ga, scode, md)
    prog_t, _ = build_stage12(LMAX, jdev.max_candidates, jdev.n_index2,
                              jdev.n_index3, per, cand_per_unit=cand,
                              ext_iters=jdev.ext_iters, device_tb=True)
    rows, counts = shard_stage12(prog_t, make_mesh(CPU_MESH))(
        [tdev, tdev], pnib, lens, is_ga, scode, md)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rec_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    assert int(counts.sum()) == 64 and int(counts[3]) > 0
    whole = prog_t(*tdev.tables(), *(torch.from_numpy(a) for a in (
        pnib, lens, is_ga, scode, md)))
    assert not torch.equal(whole, rows)


def test_shard_stage12pe_matches_jax(tables):
    """PE: the packed rows of 32 pairs (128 units) over two slots, and the
    count of fallback units (cnt < 0), equal JAX's shard_stage12pe; the
    budget of 10 makes the split matter here too."""
    from abismal_tpu.map.pipeline import build_stage12pe as jax_stage12pe
    from abismal_tpu.parallel import mesh as jax_mesh
    from abismal_tpu_torch.map.pipeline import build_stage12pe
    from abismal_tpu_torch.parallel.mesh import make_mesh, shard_stage12pe

    jdev, tdev = tables
    mesh = _jax_mesh()
    r1, r2 = _golden_pairs("small_pe", 64, 32)
    pnib, lens, is_ga, md, per = _pe_units(r1, r2, False)
    dist = np.array([32, 3000], np.int32)
    cand = 10
    prog_j, _ = jax_stage12pe(LMAX, jdev.max_candidates, jdev.n_index2,
                              jdev.n_index3, per=per, cand_per_unit=cand,
                              interpret=True, ext_iters=jdev.ext_iters)
    pk_j, fb_j = jax_mesh.shard_stage12pe(prog_j, mesh)(
        jax_mesh.replicate_tables(jdev, mesh), pnib, lens, is_ga, md, dist)
    prog_t, _ = build_stage12pe(LMAX, jdev.max_candidates, jdev.n_index2,
                                jdev.n_index3, per=per, cand_per_unit=cand,
                                ext_iters=jdev.ext_iters)
    rows, n_fb = shard_stage12pe(prog_t, make_mesh(CPU_MESH))(
        [tdev, tdev], pnib, lens, is_ga, md, dist)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(pk_j))
    assert n_fb == int(fb_j) > 0
    whole = prog_t(*tdev.tables(), *(torch.from_numpy(a) for a in (
        pnib, lens, is_ga, md, dist)))
    assert not torch.equal(whole, rows)


def _map_mesh(tmp_path, index, prefix, paired, **fac_kw):
    from abismal_tpu_torch.map.engine import run_map
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    fac = make_torch_native_engine_factory("cpu", n_threads=2,
                                           mesh_devices=CPU_MESH, **fac_kw)
    run_map(index, fq1, fq2, str(sam), str(mst), cl, engine_factory=fac,
            threads=2)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")
    return fac(index, False, 0.1, 32, 3000)


@pytest.mark.parametrize("prefix,paired", [("small", False),
                                           ("small_pe", True)])
def test_mesh_mapping_byte_identical(tmp_path, port_index, prefix, paired):
    """run_map over a 2-slot CPU mesh gives the goldens' SAM and mstats;
    SE decision counts cover every read once."""
    eng = _map_mesh(tmp_path, port_index, prefix, paired, unit_batch=128)
    assert eng.n_shards == 2 and len(eng.replicas) == 2
    assert eng.replicas[0] is eng.replicas[1]  # one upload per device
    if not paired:
        assert int(eng.device_decisions.sum()) == 500


@pytest.mark.parametrize("prefix,paired", [("small", False),
                                           ("small_pe", True)])
def test_mesh_overflow_fallback_byte_identical(tmp_path, port_index,
                                               prefix, paired, monkeypatch):
    """A budget of 8 candidates per unit forces core overflow, so fallback
    units are mixed into the split chunks (unit_batch 64: many chunks in
    flight); the goldens still hold."""
    from abismal_tpu_torch.map import pipeline

    monkeypatch.setenv("ABISMAL_TPU_CAND_PER_UNIT", "8")
    # a fresh engine: a memoized one may hold a program without the knob
    monkeypatch.setattr(pipeline, "_engine_memo", {})
    eng = _map_mesh(tmp_path, port_index, prefix, paired, unit_batch=64)
    assert eng.n_fallback > 0, "budget of 8 must force fallback units"
    if not paired:
        assert int(eng.device_decisions.sum()) == 500


@pytest.mark.parametrize("prefix,paired", [("small", False),
                                           ("small_pe", True)])
def test_mesh_event_route_byte_identical(tmp_path, port_index, prefix,
                                         paired, monkeypatch):
    """The event-stream route over a 2-slot CPU mesh (shard_stage1) gives
    the goldens; 4 events a unit fill each slot's stream, so the
    collection cuts every slot's stream to the length it wrote and the
    units past it re-seed natively.  device_align is off with a mesh."""
    from abismal_tpu_torch.map import pipeline

    monkeypatch.setenv("ABISMAL_TPU_GCAP_PER_UNIT", "4")
    monkeypatch.setattr(pipeline, "_engine_memo", {})
    eng = _map_mesh(tmp_path, port_index, prefix, paired, unit_batch=128,
                    device_stage2=False, device_align=True)
    assert not eng.device_align and eng.n_device_aligned == 0
    assert eng.n_fallback > 0, "4 events a unit must overflow slot streams"


def test_mesh_unit_batch_must_divide(port_index):
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    with pytest.raises(ValueError, match="divide"):
        TorchNativeEngine(port_index, unit_batch=129,
                          mesh_devices=["cpu"] * 2)


@pytest.mark.parametrize("spec", [2, "all", ["cuda:0", "cuda:0"]],
                         ids=["n", "all", "list"])
def test_cuda_mesh_without_card_raises(spec):
    """A mesh of CUDA devices on a machine without a card raises."""
    from abismal_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(spec)
