"""K3's least time on the card, counted from the arguments a chunk hands
its packed entry point: the yardstick of k3_roofline.  A frozen copy, so
that a change to the program cannot move it: the packed K3 cases'
count, chip_smoke.py:682-700 (TB_NOPS, abismal_tpu_torch/map/
host_units.py:46; 14 operations a live cell, chip_smoke.py:228)."""

from __future__ import annotations

from .kernels import QOFF, bound, live_cells

OPS_PER_CELL_TRACE = 14  # K2's 8, and 3 compares and 3 selects of the arrow
TB_NOPS = 24  # int32 CIGAR operations of a job's output row


def k3_bound(args):
    """K3 (banded_trace_packed) on (genome32, pnib, wunit, wbw, wqsz,
    wpos, do_tb, lmax): bytes, per job its four int64, its flag and its
    output row (TB_NOPS + 4 int32), and per traced job (wqsz > 0) its
    packed query row and genome window; ops, OPS_PER_CELL_TRACE a live
    cell.  None when no job is traced."""
    _genome32, pnib, wunit, wbw, wqsz, _wpos, _do_tb, lmax = args
    traced = int((wqsz > 0).sum())
    if not traced:
        return None
    R = wunit.shape[0]
    nbytes = R * (4 * 8 + 1 + 4 * (TB_NOPS + 4)) + traced * (
        pnib.shape[1] + (lmax + QOFF + 1) // 2)
    return bound(nbytes, OPS_PER_CELL_TRACE * live_cells(lmax, wbw, wqsz))
