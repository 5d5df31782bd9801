"""K6: the candidate core's global candidate list, one warp a unit.

Replaces abismal_tpu/map/pipeline.py:868-921, the global candidate list
of _make_core: the cumsum over the cells, the cell-of-candidate carry (a
scatter-max plus jax.lax.associative_scan(jnp.maximum, ...), :876-889),
the megarow gather (:895-913) and the index_all gather of the positions
(:915-920).  It is not a pl.pallas_call: the JAX core leaves it to XLA.

Unit u's cells hold cnt_cells[u, c] candidates (clamped to CELLCAP) of
the bucket at lo_cells[u, c] in index_all, laid out from unit_start[u],
cell after cell.  For every list position f < gflat: b_of (its unit),
cell_of, slot (f less its cell's start), valid (f < total) and pos =
(index_all[lo + slot] - coff) & M32 (coff the cell's seed offset), 0 where
not valid.  The tail [total, gflat) takes what searchsorted gives it
there, the last cell overall.  Bound on the card: bytes (the cell counts
once, an offset and an index entry a candidate, 33 bytes a candidate
written), ~3 us at B = 2048; the kernel (csrc/candidate_list.cu) keeps
each unit's chain of dependent loads short: the unit's cell starts scanned
in shared memory, then 32 candidates a round, each found by a binary
search there.  candidate_list_plain is the core's former torch code (a
cumsum over all cells and a torch.searchsorted), the reference;
candidate_list launches the kernel for CUDA tensors."""

from __future__ import annotations

import torch

from . import _build
from .popcount_compare import M32

I64 = torch.int64


def candidate_list_plain(cnt_cells, lo_cells, unit_start, unit_total,
                         index_all, o_spec, gflat):
    """Plain PyTorch K6.  cnt_cells, lo_cells (B, n_cells) int64;
    unit_start, unit_total (B,) int64, the row sums of cnt_cells and their
    exclusive prefix (the kernel reads them; this version takes the same
    prefix over all cells); index_all (N,) int64; o_spec and gflat ints.
    Returns (b_of, cell_of, slot, valid, pos), (gflat,) each, int64 but
    valid (bool)."""
    n_cells = cnt_cells.shape[1]
    cnt_flat = cnt_cells.reshape(-1)
    inc = torch.cumsum(cnt_flat, dim=0)
    f = torch.arange(gflat, device=cnt_cells.device)
    starts = inc - cnt_flat
    cell_gid = torch.searchsorted(starts, f, right=True) - 1
    b_of = cell_gid // n_cells
    cell_of = cell_gid % n_cells
    valid = f < inc[-1]
    slot = f - starts[cell_gid]
    lo_flat = lo_cells.reshape(-1)[cell_gid]
    coff = torch.where(cell_of < 2 * o_spec, cell_of >> 1,
                       (cell_of - 2 * o_spec) >> 1)
    pos = (index_all[torch.where(valid, lo_flat + slot, 0)] - coff) & M32
    pos = torch.where(valid, pos, 0)
    return b_of, cell_of, slot, valid, pos


def candidate_list(cnt_cells, lo_cells, unit_start, unit_total, index_all,
                   o_spec, gflat):
    """K6 wrapper: the plain version for CPU tensors, for CUDA tensors the
    CUDA kernel (or an error), one launch that takes no host sync and
    allocates only its outputs.  Same arguments and result as
    candidate_list_plain."""
    if cnt_cells.device.type == "cpu":
        return candidate_list_plain(cnt_cells, lo_cells, unit_start,
                                    unit_total, index_all, o_spec, gflat)
    cnt_cells, lo_cells, unit_start, unit_total, index_all = (
        t.to(I64).contiguous()
        for t in (cnt_cells, lo_cells, unit_start, unit_total, index_all))
    _build.require_device("candidate_list", cnt_cells, lo_cells, unit_start,
                          unit_total, index_all)
    B, n_cells = cnt_cells.shape
    if (lo_cells.shape != cnt_cells.shape
            or unit_start.shape != (B,) or unit_total.shape != (B,)
            or index_all.dim() != 1 or index_all.shape[0] == 0 or B == 0):
        raise ValueError("candidate_list: operand shapes disagree")
    if not 0 < gflat < 1 << 31 or n_cells > 3072:
        raise ValueError(f"candidate_list: gflat {gflat} or n_cells "
                         f"{n_cells} out of range")
    dev = cnt_cells.device
    out = torch.empty((4, gflat), dtype=I64, device=dev)
    valid = torch.empty(gflat, dtype=torch.bool, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.candidate_list_launch(
            cnt_cells.data_ptr(), lo_cells.data_ptr(), unit_start.data_ptr(),
            unit_total.data_ptr(), index_all.data_ptr(), index_all.shape[0],
            B, n_cells, o_spec, gflat, out.data_ptr(), valid.data_ptr(),
            _build.stream_of(cnt_cells))
    _build.check(rc, "candidate_list")
    candidate_list.launches += 1
    return out[0], out[1], out[2], valid, out[3]


candidate_list.launches = 0
