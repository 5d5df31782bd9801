"""The port's event-stream program (build_stage1) and its mesh form
(shard_stage1) against the JAX package's on the same chunks of golden
reads, and the replay of the port's events against the JAX package's
host oracle (process_seeds).  The JAX DeviceIndex's exact tables are
handed to the port (DeviceIndex.from_numpy_tables); every comparison is
exact (integer arithmetic, tolerance 0).  JAX runs on the CPU, as its own
tests run it."""

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    golden_file, port_index, ref_index, release_engines,
)
from tests.test_torch_stage12 import _units

jax = pytest.importorskip("jax")

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

LMAX = 128


@pytest.fixture(scope="module")
def tables(port_index):
    from tests.test_torch_stage12pe import _tables

    return _tables(port_index)


def _thr(lens):
    return ((2 * lens.astype(np.int64)) // 5).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("first,random_pbat,gcap", [
    (0, False, None),  # 64 reads, 128 units, the default 32 events a unit
    (128, True, None),  # random PBAT: 32 reads, 4 units each
    (64, False, "2"),  # 2 events a unit: the stream fills, units drop
])
def test_stage1_events_match_jax(tables, monkeypatch, first, random_pbat,
                                 gcap):
    """(ev, cf) of one 128-unit chunk equal JAX's build_stage1 byte for
    byte; with ABISMAL_TPU_GCAP_PER_UNIT=2 units past the stream's end
    are flagged (dropped) and the stream is full."""
    from abismal_tpu.map.pipeline import build_stage1 as jax_stage1
    from abismal_tpu_torch.map.pipeline import build_stage1

    if gcap:
        monkeypatch.setenv("ABISMAL_TPU_GCAP_PER_UNIT", gcap)
    jdev, tdev = tables
    pnib, lens, is_ga, _, _, _ = _units(first, 32 if random_pbat else 64,
                                        random_pbat=random_pbat)
    thr = _thr(lens)
    cand = 48  # distinct from other tests' budgets: a fresh JAX program
    prog_j, o_spec_j = jax_stage1(LMAX, jdev.max_candidates, jdev.n_index2,
                                  jdev.n_index3, cand_per_unit=cand,
                                  ext_iters=jdev.ext_iters)
    ev_j, cf_j = (np.asarray(a) for a in prog_j(*jdev.tables(), pnib, lens,
                                                is_ga, thr))
    prog_t, o_spec = build_stage1(LMAX, jdev.max_candidates, jdev.n_index2,
                                  jdev.n_index3, cand_per_unit=cand,
                                  ext_iters=jdev.ext_iters)
    ev, cf = prog_t(*tdev.tables(), *_t(pnib, lens, is_ga, thr))
    assert o_spec == o_spec_j and ev.dtype == cf.dtype == torch.int32
    np.testing.assert_array_equal(ev.numpy().view(np.uint32), ev_j)
    np.testing.assert_array_equal(cf.numpy(), cf_j)
    count, overflow = cf_j & 0x3FFFFFFF, (cf_j >> 30) != 0
    assert count.sum() > 0 and (~overflow).sum() > 64
    if gcap:  # the stream is full and the units past it dropped events
        assert count.sum() > ev_j.shape[1] and (ev_j[1] != 0).all()
        past = np.cumsum(count) > ev_j.shape[1]
        assert (past & (count > 0)).sum() > 16
        assert overflow[past & (count > 0)].all()


def test_stage1_replay_matches_oracle(tables, ref_index):
    """The port's events, replayed into a fresh candidate set by the JAX
    package's replay_events, give the state of its host oracle
    process_seeds on every unit that did not overflow (↔ tests/
    test_pipeline.py::test_stage1_events_match_oracle)."""
    from abismal_tpu.map.candidates import SECandidates
    from abismal_tpu.map.pipeline import replay_events
    from abismal_tpu.map.seeds import (
        SeedIndexView, pack_read, prep_read, process_seeds,
    )
    from abismal_tpu_torch.map.host_units import (
        get_conv_is_ga, prepare_units, strand_code,
    )
    from abismal_tpu_torch.map.pipeline import build_stage1

    view = SeedIndexView(ref_index)
    dev = tables[1]
    stage1, o_spec = build_stage1(LMAX, dev.max_candidates, dev.n_index2,
                                  dev.n_index3, ext_iters=dev.ext_iters)
    rng = np.random.default_rng(0)
    nib_to_char = np.frombuffer(b"ZACMGRSVTWYHKDBN", dtype=np.uint8)
    reads = []
    for _ in range(128):
        p = int(rng.integers(40000, 900000))
        reads.append(nib_to_char[view.nib[p : p + 100]].tobytes().replace(
            b"Z", b"A"))
    sc = strand_code("+", False)
    pnib, lens = prepare_units([prep_read(r, False) for r in reads], LMAX)
    is_ga = np.full(len(reads), get_conv_is_ga(sc))
    ev, cf = (a.numpy() for a in stage1(*dev.tables(), *_t(
        pnib, lens, is_ga, _thr(lens))))
    gpos, gmeta = ev.view(np.uint32)
    count = cf & 0x3FFFFFFF
    prefix = np.concatenate(([0], np.cumsum(count)))
    diffs = (gmeta >> 22).astype(np.int32) - 512
    rank = (gmeta & 0x3FFFFF).astype(np.int32)
    n_checked = 0
    for i, r in enumerate(reads):
        if cf[i] >> 30:
            continue
        pread = prep_read(r, False)
        want = SECandidates()
        want.reset(len(r))
        process_seeds(view, pread, pack_read(pread), sc, want)
        got = SECandidates()
        got.reset(len(r))
        s, e = int(prefix[i]), int(prefix[i + 1])
        replay_events(got, sc, gpos[s:e], diffs[s:e], rank[s:e], e - s,
                      o_spec)
        assert (got.best, got.sz) == (want.best, want.sz)
        assert sorted(map(tuple, got.v[: got.sz])) == sorted(
            map(tuple, want.v[: want.sz]))
        n_checked += 1
    assert n_checked > 100


def test_shard_stage1_matches_jax(tables):
    """A 2-slot CPU mesh gives JAX's shard_stage1 rows over two CPU
    devices: each slot's stream on rows (2s, 2s + 1), the count words in
    unit order and the summed event total.  12 candidates a unit overflow,
    so the per-slot pools differ from one pool over the chunk."""
    from abismal_tpu.map.pipeline import build_stage1 as jax_stage1
    from abismal_tpu.parallel import mesh as jax_mesh
    from abismal_tpu_torch.map.pipeline import build_stage1
    from abismal_tpu_torch.parallel.mesh import make_mesh, shard_stage1

    if jax.device_count() < 2:
        pytest.skip("needs the virtual CPU mesh of tests/conftest.py")
    jdev, tdev = tables
    mesh = jax_mesh.make_mesh(2)
    pnib, lens, is_ga, _, _, _ = _units(0, 64)
    thr = _thr(lens)
    cand = 12
    prog_j, _ = jax_stage1(LMAX, jdev.max_candidates, jdev.n_index2,
                           jdev.n_index3, cand_per_unit=cand,
                           ext_iters=jdev.ext_iters)
    ev_j, cf_j, total_j = (np.asarray(a) for a in jax_mesh.shard_stage1(
        prog_j, mesh)(jax_mesh.replicate_tables(jdev, mesh), pnib, lens,
                      is_ga, thr))
    prog_t, _ = build_stage1(LMAX, jdev.max_candidates, jdev.n_index2,
                             jdev.n_index3, cand_per_unit=cand,
                             ext_iters=jdev.ext_iters)
    ev, cf, total = shard_stage1(prog_t, make_mesh(["cpu", "cpu"]))(
        [tdev, tdev], pnib, lens, is_ga, thr)
    assert ev.shape == (4, 64 * 32)
    np.testing.assert_array_equal(ev.numpy().view(np.uint32), ev_j)
    np.testing.assert_array_equal(cf.numpy(), cf_j)
    assert total == int(total_j)
    whole_cf = prog_t(*tdev.tables(), *_t(pnib, lens, is_ga, thr))[1]
    assert ((cf_j >> 30) != 0).sum() > 0
    assert not np.array_equal(whole_cf.numpy(), cf_j)
