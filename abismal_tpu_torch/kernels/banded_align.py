"""K2 and K3: banded local-alignment score and traceback
(AbismalAlign::align and build_traceback, AbismalAlign.hpp:320-440).

K2, banded_score_packed, replaces abismal_tpu/kernels/banded_align.py:
_kernel_body (build_banded_scorer) and build_device_align, the scorer on
operands gathered on the device: its kernel reads the caller's packed
query rows and the packed genome itself, so every K2 call site is one
launch.  K3, banded_trace, replaces _tracer_body
(build_banded_tracer) together with the arrow walk of
abismal_tpu/map/pipeline.py:build_tb_block, fused into one kernel;
banded_trace_packed is K3 behind the same staging step, so the
single-end traceback is one launch.  The CUDA versions live in
csrc/banded_align.cu (rows staged in shared memory; K2: a warp takes four
jobs, lane groups sized to the band; K3: two jobs a warp, the table by
anti-diagonals, two arrow bits a cell kept in shared memory and walked a
run at a time); the plain PyTorch versions below compute the same thing
row by row over the whole batch, in the JAX package's row parametrization (see
that module's docstring): the query sits at the fixed offset QOFF, and
win[rr] is the genome nibble of row rr from win_start(pos, bw)."""

from __future__ import annotations

import torch

from ..map.host_units import TB_NOPS
from . import _build
from .popcount_compare import M32, genome_words

ALN_MATCH = 2
ALN_MISMATCH = -3
ALN_INDEL = -4
BW_MAX = 61  # widest band a job may carry
BAND = 64  # band columns of one table row (>= BW_MAX)
QOFF = BW_MAX - 1  # fixed query offset of the row parametrization
NEG = -(1 << 14)


def win_start(pos, bw):
    """Genome nibble index of a job's window row 0: the band placement
    t_beg = pos - (bw-1)/2 plus the row reparametrization's shift collapse
    to pos + (bw-1)/2 - QOFF."""
    return pos + (bw - 1) // 2 - QOFF


def walk_step_cap(lp: int) -> int:
    """Walk steps the JAX traceback can take: its while_loop bound
    (lp + QOFF) + 2 (QOFF + 1) + 4, checked every 4 unrolled steps."""
    maxstep = lp + QOFF + 2 * (QOFF + 1) + 4
    return -(-maxstep // 4) * 4


def unpack_nibbles(pnib: torch.Tensor) -> torch.Tensor:
    """(B, W) u8, two nibbles per byte (base i in nibble i & 1 of byte
    i >> 1) -> (B, 2W) int64 nibbles."""
    p = pnib.to(torch.int64)
    return torch.stack([p & 0xF, p >> 4], dim=2).reshape(p.shape[0],
                                                          2 * p.shape[1])


def window_nibbles(genome32, g0, width: int) -> torch.Tensor:
    """(J, width) u8 genome nibbles at positions g0 + k (g0 int64, u32
    values): a direct gather from the packed genome; positions past its
    end read 0, as the JAX window's clamped guard rows do."""
    p = g0[:, None] + torch.arange(width, device=g0.device)[None, :]
    w = genome_words(genome32, p >> 3)
    return ((w >> ((p & 7) * 4)) & 0xF).to(torch.uint8)


def _dp_rows(q, win, bw, qsz):
    """Yields (rr, stored, diag, x1, delv, app_d, valid) for every table
    row of every job; all (J, BAND) int64 / bool."""
    J, lq = q.shape
    n_rows = lq + QOFF
    dev = q.device
    qt = torch.zeros((J, n_rows - 1 + BAND), dtype=torch.int64, device=dev)
    qt[:, QOFF : QOFF + lq] = q.to(torch.int64)
    wt = torch.zeros((J, n_rows), dtype=torch.int64, device=dev)
    nw = min(win.shape[1], n_rows)
    wt[:, :nw] = win[:, :nw].to(torch.int64)
    cols = torch.arange(BAND, device=dev)[None, :]
    bw = bw.reshape(J, 1).to(torch.int64)
    qsz = qsz.reshape(J, 1).to(torch.int64)
    prev = torch.zeros((J, BAND), dtype=torch.int64, device=dev)
    zcol = torch.zeros((J, 1), dtype=torch.int64, device=dev)
    for rr in range(n_rows):
        left = max(QOFF - rr, 0)
        right = torch.minimum(bw, qsz + (QOFF - rr))
        valid = (cols >= left) & (cols < right)
        sub = torch.where((qt[:, rr : rr + BAND] & wt[:, rr : rr + 1]) != 0,
                          ALN_MATCH, ALN_MISMATCH)
        diag = prev + sub
        x1 = diag.clamp(min=0)
        delv = torch.cat([prev[:, 1:], zcol], dim=1) + ALN_INDEL
        app_d = cols < right - 1
        x = torch.where(app_d, torch.maximum(x1, delv), x1)
        m = torch.where(valid, x - ALN_INDEL * cols, NEG)
        v = torch.cummax(m, dim=1).values + ALN_INDEL * cols
        stored = torch.where(valid, v, 0)
        yield rr, stored, diag, x1, delv, app_d, valid
        prev = stored


def banded_score_plain(q, win, bw, qsz):
    """Plain PyTorch K2.  q (J, lp) u8 query nibbles at column 0; win
    (J, >= lp + QOFF) u8 genome nibbles from win_start(pos, bw); bw, qsz
    (J, 1) i32 with qsz <= lp.  Returns the best cell score (J, 1) i32."""
    J = q.shape[0]
    best = torch.zeros(J, dtype=torch.int64, device=q.device)
    for _rr, stored, *_ in _dp_rows(q, win, bw, qsz):
        best = torch.maximum(best, stored.max(dim=1).values)
    return best.to(torch.int32)[:, None]


def _packed_lq(pnib, lmax):
    return 2 * pnib.shape[1] if lmax is None else min(lmax, 2 * pnib.shape[1])


def _packed_operands(genome32, pnib, unit, pos, bw, lq):
    """The query rows and genome windows of jobs on packed operands: the
    first lq nibbles of pnib[unit], the lq + QOFF genome nibbles from
    win_start(pos, bw) & 0xFFFFFFFF (0 past the genome's end)."""
    unit, pos, bw = (t.to(torch.int64) for t in (unit, pos, bw))
    q = unpack_nibbles(pnib[unit])[:, :lq].to(torch.uint8)
    win = window_nibbles(genome32, win_start(pos, bw) & M32, lq + QOFF)
    return q, win


def banded_score_packed_plain(genome32, pnib, unit, pos, bw, qsz,
                              lmax=None):
    """Plain PyTorch K2 on packed operands (↔ JAX build_device_align): job
    j's query is the first lmax nibbles of the packed row pnib[unit[j]]
    ((B, W) u8, two nibbles a byte), its window the lmax + QOFF genome
    nibbles from win_start(pos, bw) & 0xFFFFFFFF of genome32 (eight
    nibbles a word, 0 past the end); unit, pos, bw, qsz (J,) integers.
    Returns the best cell scores (J,) i32, as banded_score_plain."""
    q, win = _packed_operands(genome32, pnib, unit, pos, bw,
                              _packed_lq(pnib, lmax))
    return banded_score_plain(q, win, bw.reshape(-1, 1),
                              qsz.reshape(-1, 1))[:, 0]


def banded_score_packed(genome32, pnib, unit, pos, bw, qsz, lmax=None):
    """K2 on packed operands: the plain version for CPU tensors, for CUDA
    tensors the CUDA kernel (or an error), which unpacks each job's query
    row and genome window into shared memory itself (one launch; none
    more for int64 arguments that are already contiguous).  Same
    arguments and result as banded_score_packed_plain; J jobs, no
    padding."""
    if pnib.device.type == "cpu":
        return banded_score_packed_plain(genome32, pnib, unit, pos, bw, qsz,
                                         lmax)
    J = unit.shape[0]
    genome32 = genome32.to(torch.int32).contiguous()
    pnib = pnib.to(torch.uint8).contiguous()
    unit, pos, bw, qsz = (t.reshape(J).to(torch.int64).contiguous()
                          for t in (unit, pos, bw, qsz))
    _build.require_device("banded_score_packed", genome32, pnib, unit, pos,
                          bw, qsz)
    out = torch.empty(J, dtype=torch.int32, device=pnib.device)
    if J:
        lib = _build.load()
        with torch.cuda.device(pnib.device):
            rc = lib.banded_score_packed_launch(
                genome32.data_ptr(), genome32.shape[0], pnib.data_ptr(),
                pnib.shape[1], _packed_lq(pnib, lmax), unit.data_ptr(),
                pos.data_ptr(), bw.data_ptr(), qsz.data_ptr(), out.data_ptr(),
                J, _build.stream_of(pnib))
        _build.check(rc, "banded_score_packed")
        banded_score_packed.launches += 1
    return out


banded_score_packed.launches = 0


def banded_trace_plain(q, win, bw, qsz, wpos, do_tb):
    """Plain PyTorch K3 (tracer + arrow walk).  q, win, bw, qsz as for
    banded_score_plain (bw, qsz (J,)); wpos (J,) int64 u32 band positions;
    do_tb (J,) bool.  Untraced lanes carry bw = 1, qsz = 0.  Returns
      ops  (J, TB_NOPS) i32: run-length cigar ops (run << 4 | op) in walk
           order, the caller reverses them and adds the soft clips;
      meta (J, 4) i32: [n_ops (-1: not traced or buffer overflow),
           soft_bottom, soft_top, new_pos (u32 bits)]."""
    return _trace_plain(q, win, bw, qsz, wpos, do_tb,
                        walk_step_cap(q.shape[1]))


def _trace_plain(q, win, bw, qsz, wpos, do_tb, max_step):
    """banded_trace_plain with the walk cut after max_step steps.  No
    alignment reaches walk_step_cap(lq) (a walk of s steps scores at most
    2 lq - 4 (s - lq) > 0), so the tests of the cap set a lower one."""
    J, lq = q.shape
    dev = q.device
    n_rows = lq + QOFF
    cols = torch.arange(BAND, device=dev)[None, :]
    panel = torch.zeros((J, n_rows, BAND), dtype=torch.int64, device=dev)
    best = torch.zeros(J, dtype=torch.int64, device=dev)
    brr = torch.zeros_like(best)
    bc = torch.zeros_like(best)
    for rr, stored, diag, x1, delv, app_d, valid in _dp_rows(q, win, bw, qsz):
        vleft = torch.cat([torch.zeros_like(stored[:, :1]), stored[:, :-1]],
                          dim=1)
        arrow = torch.where(diag >= 0, 0, 3)
        arrow = torch.where(app_d & (delv >= x1), 2, arrow)
        arrow = torch.where(stored == vleft + ALN_INDEL, 1, arrow)
        positive = torch.where(stored > 0, 4, 0)
        panel[:, rr] = torch.where(valid, arrow | positive, 0)
        rmax = stored.max(dim=1).values
        cstar = torch.where(stored == rmax[:, None], cols, BAND).min(
            dim=1).values
        upd = rmax > best
        best = torch.where(upd, rmax, best)
        brr = torch.where(upd, rr, brr)
        bc = torch.where(upd, cstar, bc)

    bw = bw.reshape(J).to(torch.int64)
    qsz = qsz.reshape(J).to(torch.int64)
    jid = torch.arange(J, device=dev)

    def fetch(i, j):
        rr = i - bw + QOFF
        ok = (rr >= 0) & (rr < n_rows) & (j >= 0) & (j < BAND)
        v = panel[jid, rr.clamp(0, n_rows - 1), j.clamp(0, BAND - 1)]
        return torch.where(ok, v, 0)

    i0 = brr - QOFF + bw
    j0 = bc
    started = do_tb.reshape(J).to(torch.bool) & (best > 0)
    a0 = fetch(i0, j0) & 3
    isI0 = (a0 == 1).to(torch.int64)
    isD0 = (a0 == 2).to(torch.int64)
    i = i0 - (1 - isI0)
    j = j0 - isI0 + isD0
    act = started.clone()
    prv = a0
    run = torch.ones_like(best)
    cnt = torch.zeros_like(best)
    ops = torch.zeros((J, TB_NOPS), dtype=torch.int64, device=dev)
    over = torch.zeros_like(started)
    kops = torch.arange(TB_NOPS, device=dev)[None, :]
    for step in range(max_step):
        # lanes that stopped are no-ops, so stopping when none is active
        # leaves every lane where the JAX while_loop leaves it
        if step % 8 == 0 and not bool(act.any()):
            break
        nib = fetch(i, j)
        act = act & ((nib & 4) != 0)
        arrow = nib & 3
        emit = act & (arrow != prv)
        val = (run << 4) | prv
        slot = kops == cnt.clamp(max=TB_NOPS - 1)[:, None]
        ops = torch.where(emit[:, None] & slot, val[:, None], ops)
        over = over | (emit & (cnt >= TB_NOPS))
        cnt = cnt + emit.to(torch.int64)
        run = torch.where(emit, 1, run + act.to(torch.int64))
        isI = act & (arrow == 1)
        isD = act & (arrow == 2)
        i = torch.where(act & ~isI, i - 1, i)
        j = j - isI.to(torch.int64) + isD.to(torch.int64)
        prv = torch.where(act, arrow, prv)
    val = (run << 4) | prv
    slot = kops == cnt.clamp(max=TB_NOPS - 1)[:, None]
    ops = torch.where(started[:, None] & slot, val[:, None], ops)
    over = over | (started & (cnt >= TB_NOPS)) | act
    cnt = cnt + started.to(torch.int64)
    soft_bottom = (qsz + bw - 1) - (i0 + j0)
    soft_top = (i + j) - (bw - 1)
    newpos = (wpos.reshape(J).to(torch.int64) - (bw - 1) // 2 + i) & 0xFFFFFFFF
    newpos = torch.where(newpos >= 1 << 31, newpos - (1 << 32), newpos)
    n_ops = torch.where(started & ~over, cnt, -1)
    meta = torch.stack([n_ops, soft_bottom, soft_top, newpos], dim=1)
    return ops.to(torch.int32), meta.to(torch.int32)


def banded_trace(q, win, bw, qsz, wpos, do_tb):
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (or an error).  Same arguments and results as
    banded_trace_plain."""
    return _trace(q, win, bw, qsz, wpos, do_tb, walk_step_cap(q.shape[1]))


def _trace(q, win, bw, qsz, wpos, do_tb, max_step):
    """banded_trace with the walk cut after max_step steps (the tests of
    the cap; see _trace_plain)."""
    if q.device.type == "cpu":
        return _trace_plain(q, win, bw, qsz, wpos, do_tb, max_step)
    J, lq = q.shape
    q = _build.aligned(q.to(torch.uint8).contiguous(), 4)
    win = _build.aligned(win.to(torch.uint8).contiguous(), 4)
    bw = bw.reshape(J).to(torch.int32).contiguous()
    qsz = qsz.reshape(J).to(torch.int32).contiguous()
    wpos = wpos.reshape(J).to(torch.int64).contiguous()
    do_tb = do_tb.reshape(J).to(torch.uint8).contiguous()
    _build.require_device("banded_trace", q, win, bw, qsz, wpos, do_tb)
    ops = torch.empty((J, TB_NOPS), dtype=torch.int32, device=q.device)
    meta = torch.empty((J, 4), dtype=torch.int32, device=q.device)
    if J:
        lib = _build.load()
        with torch.cuda.device(q.device):
            rc = lib.banded_trace_launch(
                q.data_ptr(), lq, win.data_ptr(), win.shape[1],
                bw.data_ptr(), qsz.data_ptr(), wpos.data_ptr(),
                do_tb.data_ptr(), ops.data_ptr(), meta.data_ptr(), J,
                max_step, _build.stream_of(q))
        _build.check(rc, "banded_trace")
        banded_trace.launches += 1
    return ops, meta


banded_trace.launches = 0


def banded_trace_packed_plain(genome32, pnib, wunit, wbw, wqsz, wpos, do_tb,
                              lmax=None):
    """Plain PyTorch K3 on packed operands: job j's query is the first lmax
    nibbles of the packed row pnib[wunit[j]] ((B, W) u8, two nibbles a
    byte), its window the lmax + QOFF genome nibbles from win_start(wpos,
    wbw) & 0xFFFFFFFF of genome32 (eight nibbles a word, 0 past the end);
    wunit, wbw, wqsz, wpos (J,) int64, do_tb (J,) bool.  Gathers and
    unpacks both, then banded_trace_plain; same results."""
    q, win = _packed_operands(genome32, pnib, wunit, wpos, wbw,
                              _packed_lq(pnib, lmax))
    return banded_trace_plain(q, win, wbw.to(torch.int64), wqsz,
                              wpos.to(torch.int64), do_tb)


def banded_trace_packed(genome32, pnib, wunit, wbw, wqsz, wpos, do_tb,
                        lmax=None):
    """K3 on packed operands: the plain version for CPU tensors, for CUDA
    tensors the CUDA kernel (or an error), which unpacks each job's query
    row and genome window into shared memory itself: one launch, and none
    at all for int64 / bool arguments that are already contiguous.  Same
    arguments and results as banded_trace_packed_plain."""
    if pnib.device.type == "cpu":
        return banded_trace_packed_plain(genome32, pnib, wunit, wbw, wqsz,
                                         wpos, do_tb, lmax)
    J = wunit.shape[0]
    genome32 = genome32.to(torch.int32).contiguous()
    pnib = pnib.to(torch.uint8).contiguous()
    wunit, wbw, wqsz, wpos = (t.reshape(J).to(torch.int64).contiguous()
                              for t in (wunit, wbw, wqsz, wpos))
    do_tb = do_tb.reshape(J).contiguous()
    # a bool tensor is one byte an element: the kernel reads it as it is
    do_tb = (do_tb.view(torch.uint8) if do_tb.dtype == torch.bool
             else do_tb.to(torch.uint8))
    _build.require_device("banded_trace_packed", genome32, pnib, wunit, wbw,
                          wqsz, wpos, do_tb)
    ops = torch.empty((J, TB_NOPS), dtype=torch.int32, device=pnib.device)
    meta = torch.empty((J, 4), dtype=torch.int32, device=pnib.device)
    if J:
        lq = _packed_lq(pnib, lmax)
        lib = _build.load()
        with torch.cuda.device(pnib.device):
            rc = lib.banded_trace_packed_launch(
                genome32.data_ptr(), genome32.shape[0], pnib.data_ptr(),
                pnib.shape[1], lq, wunit.data_ptr(), wbw.data_ptr(),
                wqsz.data_ptr(), wpos.data_ptr(), do_tb.data_ptr(),
                ops.data_ptr(), meta.data_ptr(), J, walk_step_cap(lq),
                _build.stream_of(pnib))
        _build.check(rc, "banded_trace_packed")
        banded_trace_packed.launches += 1
    return ops, meta


banded_trace_packed.launches = 0
