"""The plain versions of K5 (kernels/segment_rank.py) and K6
(kernels/candidate_list.py) against the JAX programs' own expressions,
written here in jnp from the lines they replace, on the same seeded numpy
inputs, element by element (integer arithmetic, tolerance 0):
  - K5: the slot-rank carry of build_stage12 (abismal_tpu/map/pipeline.py
    :1296-1323, the associative_scan at :1317-1320) and of build_stage12pe
    (:1680-1697, the scan at :1694-1696);
  - K6: the global candidate list of _make_core (:868-921: the cumsum,
    the scatter-max and associative_scan cell carry, the megarow gather and
    the index_all gather).
The cases (tests/test_torch_kernels.py: scan_case, list_case) hold empty
segments, all and no candidates gated, a long tail, spans clamped at the
pool's end, long spans, more candidates than the list (total > gflat),
units at CELLCAP in many cells (one across the list's end) and lmax 256.  The programs' gates are false past
their last span's end, which K5's kernel relies on; that is pinned here on
the programs' own inputs."""

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    port_index, release_engines,
)
from tests.test_torch_kernels import (
    LIST_CASES, SCAN_CASES, list_case, program_scan_args, scan_case,
    scan_torch,
)

jax = pytest.importorskip("jax")
jnp = jax.numpy

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)


def jax_rank_se(gate, rst_c, rend, is_ex):
    """build_stage12's per-read gated rank and counts (pipeline.py
    :1300-1320): (wslot, n_gated, total_ex)."""
    ncand = gate.shape[0]
    gt = gate.astype(jnp.int32)
    g_inc = jnp.cumsum(gt)
    g_exc = g_inc - gt
    g_at = jnp.concatenate([g_exc, g_inc[-1:]])
    n_gated = g_at[rend] - g_at[rst_c]
    ex_at = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(is_ex.astype(jnp.int32))])
    total_ex = ex_at[rend] - ex_at[rst_c]
    base_of = jax.lax.associative_scan(
        jnp.maximum,
        jnp.zeros(ncand + 1, jnp.int32).at[rst_c].max(
            g_at[rst_c])[:ncand])
    return g_exc - base_of, n_gated, total_ex


def jax_rank_pe(gate, ust_c, uend_at):
    """build_stage12pe's per-unit accepted rank and count (pipeline.py
    :1683-1697): (slot_u, n_acc)."""
    ncand = gate.shape[0]
    acc = gate.astype(jnp.int32)
    c_inc = jnp.cumsum(acc)
    c_exc = c_inc - acc
    c_at = jnp.concatenate([c_exc, c_inc[-1:]])
    base = c_at[ust_c]
    n_acc = c_at[uend_at] - base
    base_of = jax.lax.associative_scan(
        jnp.maximum,
        jnp.zeros(ncand + 1, jnp.int32).at[ust_c].max(base)[:ncand])
    return c_exc - base_of, n_acc


def jax_list(cnt_cells, lo_cells, index_all, o_spec, gflat):
    """_make_core's global candidate list (pipeline.py :868-921), the
    megarow cut to the columns K6 builds: (b_of, cell_of, slot, valid,
    pos, unit_start, unit_total); index_all the i32 bits of u32
    positions, as in JAX's DeviceIndex."""
    B, n_cells = cnt_cells.shape
    cnt_flat = cnt_cells.reshape(-1)
    inc = jnp.cumsum(cnt_flat)
    total = inc[-1]
    unit_total = jnp.sum(cnt_cells, axis=1)
    unit_start = jnp.cumsum(unit_total) - unit_total
    f = jnp.arange(gflat, dtype=jnp.int32)
    starts = inc - cnt_flat
    gid_vals = jnp.arange(B * n_cells, dtype=jnp.int32)
    cellmark = jnp.zeros(gflat + 1, dtype=jnp.int32).at[
        jnp.minimum(starts, gflat)].max(gid_vals, indices_are_sorted=True)
    cell_gid = jax.lax.associative_scan(jnp.maximum, cellmark[:gflat])
    b_of = cell_gid // n_cells
    cell_of = cell_gid % n_cells
    valid = f < total
    tbl = jnp.stack([starts.reshape(B, n_cells), lo_cells],
                    axis=2).reshape(B * n_cells, 2)
    mega = tbl[cell_gid]
    slot = f - mega[:, 0]
    lo_flat = mega[:, 1]
    coff = jnp.where(cell_of < 2 * o_spec, cell_of >> 1,
                     (cell_of - 2 * o_spec) >> 1)
    pos = (index_all[jnp.where(valid, lo_flat + slot, 0)]
           .astype(jnp.uint32) - coff.astype(jnp.uint32))
    pos = jnp.where(valid, pos, 0)
    return b_of, cell_of, slot, valid, pos, unit_start, unit_total


def _equal(got, want, what):
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            g.numpy().astype(np.int64), np.asarray(w).astype(np.int64),
            err_msg=f"{what}: output {k}")


@pytest.mark.parametrize("case", SCAN_CASES)
def test_segment_rank_plain_matches_jax(case):
    """K5's plain version equals JAX's SE expression (with the exact mask)
    or PE expression ("pe") entry for entry: every rank, the tail's
    included, and every count."""
    from abismal_tpu_torch.kernels.segment_rank import segment_rank_plain

    gate, seg_start, seg_end, ex = scan_case(case)
    got = segment_rank_plain(*scan_torch((gate, seg_start, seg_end, ex)))
    args = [jnp.asarray(a) for a in (gate, seg_start.astype(np.int32),
                                     seg_end.astype(np.int32))]
    if ex is None:
        want = jax_rank_pe(*args)
    else:
        want = jax_rank_se(*args, jnp.asarray(ex))
    assert len(got) == len(want)
    _equal(got, want, case)
    # the tail's rank is the last segment's count (the kernel's contract)
    tail = int(seg_end[-1])
    assert (got[0][tail:] == got[1][-1]).all()
    if case == "none-gated":
        assert int(got[0].abs().sum()) == 0
    if case == "all-gated":  # a rank is the distance from the span start
        r = np.searchsorted(seg_start, np.arange(tail), side="right") - 1
        np.testing.assert_array_equal(got[0][:tail].numpy(),
                                      np.arange(tail) - seg_start[r])


@pytest.mark.parametrize("case", LIST_CASES)
def test_candidate_list_plain_matches_jax(case):
    """K6's plain version equals JAX's candidate list entry for entry over
    all gflat positions, the tail's (f >= total: the last cell overall)
    included, and the caller's unit_start and unit_total equal JAX's."""
    from abismal_tpu_torch.kernels.candidate_list import (
        candidate_list_plain,
    )

    args = list_case(case)
    cnt, lo, unit_start, unit_total, idx, o_spec, gflat = args
    got = candidate_list_plain(*scan_torch(args))
    want = jax_list(jnp.asarray(cnt.astype(np.int32)),
                    jnp.asarray(lo.astype(np.int32)),
                    jnp.asarray(idx.astype(np.uint32).view(np.int32)),
                    o_spec, gflat)
    _equal(got, want[:5], case)
    np.testing.assert_array_equal(unit_start, np.asarray(want[5]))
    np.testing.assert_array_equal(unit_total, np.asarray(want[6]))
    b_of, cell_of, slot, valid, pos = (g.numpy() for g in got)
    total = int(unit_total.sum())
    if total < gflat:  # the tail: the last cell, the slot runs on
        assert not valid[total:].any() and (pos[total:] == 0).all()
        assert (b_of[total:] == cnt.shape[0] - 1).all()
        assert (cell_of[total:] == cnt.shape[1] - 1).all()
        assert (np.diff(slot[total:]) == 1).all()
    if case in ("over-gflat", "big-units"):
        assert valid.all()
    if case == "cellcap":
        assert int((b_of[valid] == 5).sum()) == int(cnt[5].sum())
    # positions below a cell's seed offset wrap modulo 2^32
    assert int((pos > (1 << 32) - 1024).sum()) > 0 or total == 0


def test_program_gates_end_with_their_spans(port_index):
    """On what the SE and PE programs hand K5 (a chunk of golden reads
    and pairs), the gates are false from the last span's end on, which
    K5's kernel relies on; the spans are contiguous (each ends where the
    next starts) and their ranks and counts equal JAX's expressions.  K6's
    inputs there give JAX's candidate list."""
    from abismal_tpu_torch.kernels.candidate_list import (
        candidate_list_plain,
    )
    from abismal_tpu_torch.kernels.segment_rank import segment_rank_plain

    for kind, (a5, a6) in program_scan_args(port_index).items():
        gate, seg_start, seg_end = a5[:3]
        assert not gate[int(seg_end[-1]):].any(), kind
        assert torch.equal(seg_end[:-1], seg_start[1:]), kind
        assert int(seg_start[0]) == 0 and int(gate.sum()) > 0, kind
        got = segment_rank_plain(*a5)
        j = [jnp.asarray(t.numpy()) for t in a5[:3]]
        want = (jax_rank_pe(*j) if kind == "pe"
                else jax_rank_se(*j, jnp.asarray(a5[3].numpy())))
        _equal(got, want, kind)
        cnt, lo, unit_start, unit_total, idx, o_spec, gflat = a6
        got = candidate_list_plain(*a6)
        want = jax_list(jnp.asarray(cnt.numpy().astype(np.int32)),
                        jnp.asarray(lo.numpy().astype(np.int32)),
                        jnp.asarray(idx.numpy().astype(np.uint32)
                                    .view(np.int32)), o_spec, gflat)
        _equal(got, want[:5], kind)
        assert torch.equal(unit_start, torch.from_numpy(
            np.asarray(want[5]).astype(np.int64))), kind
