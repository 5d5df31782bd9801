"""The key-range-sharded index of the port (DeviceIndexTP, build_stage1
with tp=True, shard_stage1_tp, the host merge and TorchNativeEngine's
index_shards) on the CPU, with the plain kernel versions: its tables and
each shard's stream against the JAX package's (JAX on one CPU device,
shard by shard, as its shard_map runs each shard), the merged stream
against the unsharded one, and whole `map` runs over CPU slots against
the goldens (↔ tests/test_multichip.py).  Every comparison is exact
equality: the outputs are integers."""

import gzip
import os

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, golden_file, port_index, ref_index, release_engines,
)
from tests.test_torch_stage12 import _units

jax = pytest.importorskip("jax")

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

LMAX = 128


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def _thr(lens):
    return ((2 * lens.astype(np.int64)) // 5).astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_tp_tables_match_jax(port_index, ref_index, n_shards):
    """The key bounds of the three tables, P2, P3, index_local and
    shardinfo equal the JAX DeviceIndexTP's (its bases wrapped to i32);
    the genome and counter tables are one copy for all the CPU slots."""
    from abismal_tpu.map import pipeline as ref
    from abismal_tpu_torch.map.host_units import _tp_key_bounds
    from abismal_tpu_torch.map.pipeline import DeviceIndexTP

    for c in (port_index.counter, port_index.counter_t,
              port_index.counter_a):
        np.testing.assert_array_equal(_tp_key_bounds(c, n_shards),
                                      ref._tp_key_bounds(c, n_shards))
    want = ref.DeviceIndexTP(ref_index, n_shards)
    got = DeviceIndexTP(port_index, ["cpu"] * n_shards)
    assert (got.P2, got.P3, got.n_shards) == (want.P2, want.P3, n_shards)
    assert (got.max_candidates, got.ext_iters) == (want.max_candidates,
                                                   want.ext_iters)
    np.testing.assert_array_equal(got.index_local.astype(np.uint32),
                                  want.index_local.view(np.uint32))
    np.testing.assert_array_equal(got.shardinfo.astype(np.int32),
                                  want.shardinfo)
    assert len(got.slots) == n_shards
    for s, slot in enumerate(got.slots):
        assert all(a is b for a, b in zip(slot[:3], got.slots[0][:3]))
        assert torch.equal(slot[3], torch.from_numpy(got.index_local[s]))
        assert torch.equal(slot[4], torch.from_numpy(got.shardinfo[s]))


def _seeded_streams(seed, n_sh=3, B=64, per_unit=4):
    """(ev, cf) of n_sh shards as a sharded stage 1 lays them out: random
    positions, diffs and ranks, some units overflowed, shard 1 empty."""
    rng = np.random.default_rng(seed)
    gcap = B * per_unit
    cnt = rng.integers(0, 2 * per_unit, size=(n_sh, B))
    cnt[1] = 0
    ovf = rng.random((n_sh, B)) < 0.1
    ev = np.zeros((2 * n_sh, gcap), np.uint32)
    for s in range(n_sh):
        total = min(int(cnt[s].sum()), gcap)
        ev[2 * s, :total] = rng.integers(0, 1 << 32, total, dtype=np.uint64)
        diffs = rng.integers(-3, 40, total)
        rank = rng.integers(0, 1 << 22, total)
        ev[2 * s + 1, :total] = ((diffs + 512) << 22) | rank
    cf = (cnt | (ovf.astype(np.int64) << 30)).astype(np.int32)
    return ev, cf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_tp_streams_matches_jax(seed):
    """The host merge equals JAX's on seeded streams with overflowed
    units (on one shard: the unit falls back on all) and an empty
    shard."""
    from abismal_tpu.map.pipeline import _merge_tp_streams as ref_merge
    from abismal_tpu_torch.map.host_units import _merge_tp_streams

    ev, cf = _seeded_streams(seed)
    got, want = _merge_tp_streams(ev, cf), ref_merge(ev, cf)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ovf = got[5]
    assert ovf.any() and not ovf.all() and got[0].size > 0
    assert (got[4][ovf] == 0).all()


@pytest.mark.parametrize("cand", [None, 4])
def test_stage1_tp_shards_match_jax(port_index, ref_index, cand):
    """Each of 3 shards' (ev, cf) from the port's build_stage1(tp=True)
    equals JAX's build_stage1(tp=True) run on that shard's index_local
    and shardinfo rows on one CPU device (what its shard_map runs per
    shard), at the budget of P2 and P3 and at 4 candidates a unit, which
    overflows; shard_stage1_tp stacks the same rows."""
    from abismal_tpu.map import pipeline as ref
    from abismal_tpu_torch.map.pipeline import DeviceIndexTP, build_stage1
    from abismal_tpu_torch.parallel.mesh import make_mesh, shard_stage1_tp

    n_sh = 3
    mesh = make_mesh(["cpu"] * n_sh)
    jtp = ref.DeviceIndexTP(ref_index, n_sh)
    tp = DeviceIndexTP(port_index, mesh)
    pnib, lens, is_ga, _, _, _ = _units(0, 64)
    thr = _thr(lens)
    prog_j, o_spec_j = ref.build_stage1(
        LMAX, jtp.max_candidates, jtp.P2, jtp.P3, cand_per_unit=cand,
        tp=True, ext_iters=jtp.ext_iters)
    prog_t, o_spec = build_stage1(LMAX, tp.max_candidates, tp.P2, tp.P3,
                                  cand_per_unit=cand,
                                  ext_iters=tp.ext_iters, tp=True)
    assert o_spec == o_spec_j
    g2o = ref.overlap_rows_u32(jtp.genome32)
    evs, cfs = [], []
    for s in range(n_sh):
        ev_j, cf_j = (np.asarray(a) for a in prog_j(
            jtp.genome32, g2o, jtp.counter2_np, jtp.counter3_np,
            jtp.index_local[s], pnib, lens, is_ga, thr,
            shard=jtp.shardinfo[s]))
        g32, c2, c3, il, shard = tp.slots[s]
        ev, cf = prog_t(g32, c2, c3, il, *_t(pnib, lens, is_ga, thr),
                        shard=shard)
        np.testing.assert_array_equal(ev.numpy().view(np.uint32), ev_j)
        np.testing.assert_array_equal(cf.numpy(), cf_j)
        evs.append(ev)
        cfs.append(cf)
    counts = np.stack([c.numpy() & 0x3FFFFFFF for c in cfs])
    assert (counts.sum(axis=1) > 0).sum() >= 2  # events on several shards
    if cand:
        assert ((np.stack([c.numpy() for c in cfs]) >> 30) != 0).any()
    ev_m, cf_m = shard_stage1_tp(prog_t, mesh)(
        tp.slots, pnib, lens, is_ga, thr)
    assert torch.equal(ev_m, torch.cat(evs))
    assert torch.equal(cf_m, torch.stack(cfs))


def _genome_units(index, n_units, seed):
    """n_units 100-base substrings of the genome as T-rich units (↔ the
    JAX package's __graft_entry__._unit_inputs)."""
    from abismal_tpu_torch.map.host_units import prepare_units
    from abismal_tpu_torch.map.seeds import prep_read
    from abismal_tpu_torch.utils.dna import unpack_nibbles_u64

    nib = unpack_nibbles_u64(index.genome_words, index.genome_size)
    nib_to_char = np.frombuffer(b"ZACMGRSVTWYHKDBN", dtype=np.uint8)
    rng = np.random.default_rng(seed)
    units = []
    for _ in range(n_units):
        p = int(rng.integers(40000, index.genome_size - 40000))
        seq = nib_to_char[nib[p : p + 100]].tobytes().replace(b"Z", b"A")
        units.append(prep_read(seq, False))
    pnib, lens = prepare_units(units, LMAX)
    return pnib, lens, np.zeros(n_units, dtype=bool), _thr(lens)


def test_sharded_stream_equals_unsharded(port_index):
    """Over 8 CPU slots the rank-merged union of the shards' streams
    equals the unsharded build_stage1 stream event for event (↔
    tests/test_multichip.py::test_sharded_index_stage1_equivalence)."""
    from abismal_tpu_torch.map.host_units import _merge_tp_streams
    from abismal_tpu_torch.map.pipeline import (
        DeviceIndex, DeviceIndexTP, build_stage1,
    )
    from abismal_tpu_torch.parallel.mesh import make_mesh, shard_stage1_tp

    mesh = make_mesh(["cpu"] * 8)
    tp = DeviceIndexTP(port_index, mesh)
    pnib, lens, is_ga, thr = _genome_units(port_index, 128, seed=3)
    prog_tp, _ = build_stage1(LMAX, tp.max_candidates, tp.P2, tp.P3,
                              ext_iters=tp.ext_iters, tp=True)
    ev_tp, cf_tp = shard_stage1_tp(prog_tp, mesh)(tp.slots, pnib, lens,
                                                  is_ga, thr)
    assert ev_tp.shape[0] == 16 and cf_tp.shape == (8, 128)
    m_pos, m_diff, m_rank, m_start, m_cnt, m_ovf = _merge_tp_streams(
        ev_tp.numpy().view(np.uint32), cf_tp.numpy())
    del tp
    dev = DeviceIndex.from_index(port_index, "cpu")
    stage1, _ = build_stage1(LMAX, dev.max_candidates, dev.n_index2,
                             dev.n_index3, ext_iters=dev.ext_iters)
    ev, cf = (a.numpy() for a in stage1(*dev.tables(),
                                        *_t(pnib, lens, is_ga, thr)))
    ev = ev.view(np.uint32)
    cnt = (cf & 0x3FFFFFFF).astype(np.int64)
    assert not (cf >> 30).any() and not m_ovf.any()
    np.testing.assert_array_equal(m_cnt, cnt)
    np.testing.assert_array_equal(m_start, np.cumsum(cnt) - cnt)
    total = int(cnt.sum())
    assert total > 0 and m_pos.shape[0] == total
    np.testing.assert_array_equal(m_pos, ev[0][:total])
    np.testing.assert_array_equal(m_rank,
                                  (ev[1][:total] & 0x3FFFFF).astype(np.int32))
    np.testing.assert_array_equal(
        m_diff, (ev[1][:total] >> 22).astype(np.int32) - 512)
    # more than one shard contributed
    assert ((cf_tp.numpy() & 0x3FFFFFFF).sum(axis=1) > 0).sum() > 1


def _map_sharded(tmp_path, index, prefix, paired, n_shards, **fac_kw):
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
    fac = make_torch_native_engine_factory(
        "cpu", n_threads=2, index_shards=["cpu"] * n_shards, **fac_kw)
    run_map(index, fq1, fq2, str(sam), str(mst), cl, engine_factory=fac,
            threads=2)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")
    return fac(index, False, 0.1, 32, 3000)


@pytest.mark.parametrize("prefix,paired", [("small", False),
                                           ("small_pe", True)])
def test_sharded_index_mapping_byte_identical(tmp_path, port_index, prefix,
                                              paired, monkeypatch):
    """run_map with the index split over 4 CPU slots gives the goldens'
    SAM and mstats (↔ tests/test_multichip.py::
    test_sharded_index_mapping_byte_identical); the engine took the event
    route and holds one copy of the genome and counters."""
    from abismal_tpu_torch.map import pipeline

    monkeypatch.setattr(pipeline, "_engine_memo", {})
    eng = _map_sharded(tmp_path, port_index, prefix, paired, 4,
                       unit_batch=128, device_align=True)
    assert eng.tp.n_shards == 4 and eng.dev is None
    assert not eng.device_stage2 and not eng.device_align
    assert eng.n_units > 0
    assert eng.tp.slots[0][1] is eng.tp.slots[3][1]


def test_sharded_index_overflow_byte_identical(tmp_path, port_index,
                                               monkeypatch):
    """4 events a unit overflow the shards' streams: the merge sends
    those units to the native seeding and the golden holds (↔ tests/
    test_multichip.py::test_sharded_index_overflow_byte_identical)."""
    from abismal_tpu_torch.map import pipeline

    monkeypatch.setenv("ABISMAL_TPU_GCAP_PER_UNIT", "4")
    monkeypatch.setattr(pipeline, "_engine_memo", {})
    eng = _map_sharded(tmp_path, port_index, "small", False, 3,
                       unit_batch=64)
    assert eng.n_fallback > 0, "gcap of 4 must force fallback units"


def test_mesh_and_index_shards_exclude_each_other(port_index):
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    with pytest.raises(ValueError, match="pick one"):
        TorchNativeEngine(port_index, mesh_devices=["cpu"] * 2,
                          index_shards=["cpu"] * 2)
