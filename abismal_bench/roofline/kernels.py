"""What a kernel's work needs, counted from the arguments a chunk hands it,
and its least time on the card: the yardstick of the `*_roofline`
metrics.  Frozen copies, so that a change to the program cannot move
them:

- bound, live_cells: chip_smoke.py:348-368; K2's bytes and operations:
  chip_smoke.py:603-616 (score_case);
- k4_traffic: chip_smoke.py:930-1015, with the plain search it replays:
  abismal_tpu_torch/kernels/seed_extend.py:75-240 (nib_cls, gwin_cls,
  lex, lanes_plain's k-ary search, pool_lanes) and
  kernels/popcount_compare.py:26-40 (popcount32, genome_words).

Counts are of what the inputs need (each input and output byte once, the
probes of bounds still open), never of what a kernel does beyond that."""

from __future__ import annotations

from .peaks import PEAK_BYTES_PER_S, PEAK_INT32_OPS_PER_S

OPS_PER_CELL_SCORE = 8  # and, select, add, max, add, max, max, add
OPS_PER_CLASS_WORD = 14  # funnel shift, 8 class ops, xor, mask, test, ...
QOFF = 60  # K2's rows: a job's query sits QOFF rows into its table
KEY_WEIGHT, KEY_WEIGHT_THREE = 25, 16
M32 = 0xFFFFFFFF
BIGI = 0x3FFFFFFF


def bound(nbytes, ops) -> dict:
    """The least time (ms) the card could take, and which limit gives it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return dict(bytes=int(nbytes), ops=int(ops),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def live_cells(lq, bw, qsz) -> int:
    """Cells of the banded tables that hold a value: per row rr of job j,
    max(0, min(bw, qsz + QOFF - rr) - max(QOFF - rr, 0))."""
    import torch

    rr = torch.arange(lq + QOFF, device=bw.device)[None, :]
    left = (QOFF - rr).clamp(min=0)
    right = torch.minimum(bw.reshape(-1, 1).long(),
                          qsz.reshape(-1, 1).long() + QOFF - rr)
    return int((right - left).clamp(min=0).sum().item())


def k2_bound(args):
    """K2 (banded_score_packed) on (genome32, pnib, unit, pos, bw, qsz,
    lmax): bytes, a job's four int64 and its score, and for a live job
    its packed query row and genome window; ops, OPS_PER_CELL_SCORE a live
    cell.  None when no job is live."""
    _genome32, pnib, unit, _pos, bw, qsz, lmax = args
    live = (bw > 0) & (qsz > 0)
    n_live = int(live.sum())
    if not n_live:
        return None
    J = unit.shape[0]
    nbytes = J * (4 * 8 + 4) + n_live * (pnib.shape[1] + (lmax + QOFF + 1)
                                         // 2)
    return bound(nbytes, OPS_PER_CELL_SCORE * live_cells(lmax, bw, qsz))


def share(bounds, kernel) -> float | None:
    """A kernel's share of its roofline, in percent: the mean least time
    of the calls recorded on a map's chunks (bounds: a bound() a call, or
    None for one with no live work) over the kernel's mean time an
    instance in the trace of a graphed map of the same chunks (kernel:
    (instances, seconds), from harness/trace.py kernel_time).  None where
    no call had live work or the trace has no instance."""
    if not bounds or kernel is None or kernel[1] <= 0:
        return None
    live = [b["bound_ms"] for b in bounds if b]
    if not live:
        return None
    return 100.0 * (sum(live) / len(bounds)) / (1e3 * kernel[1] / kernel[0])


# --- K4: the plain k-ary search whose comparisons the traffic replays ---

def _popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _genome_words(genome32, widx):
    import torch

    n = genome32.shape[0]
    w = genome32[widx.clamp(0, n - 1)].to(torch.int64) & M32
    return torch.where(widx < n, w, 0)


def _unpack(pnib):
    import torch

    p = pnib.to(torch.int64)
    return torch.stack([p & 0xF, p >> 4], dim=2).reshape(p.shape[0],
                                                          2 * p.shape[1])


def class_words(lmax: int):
    dqmax = lmax - KEY_WEIGHT_THREE
    return dqmax, (dqmax + 7) // 8


def _nib_cls(nib, t3, ga):
    import torch

    b0, b1 = nib & 1, (nib >> 1) & 1
    b2, b3 = (nib >> 2) & 1, (nib >> 3) & 1
    hi3 = torch.where(ga, b3, b2)
    lo3 = torch.where(ga, b1, b0) | hi3
    c3v = 2 * hi3 + (lo3 & (1 - hi3))
    return torch.where(t3, c3v, 1 - (b0 | b2))


def _gwin_cls(genome32, g0, t3, ga, qw: int):
    import torch

    ar = torch.arange(qw + 1, device=g0.device)
    A = _genome_words(genome32, (g0 >> 3)[:, None] + ar[None, :])
    sh = ((g0 & 7) * 4)[:, None]
    wal = ((A[:, :qw] >> sh) | (A[:, 1:] << (32 - sh))) & M32
    m1 = 0x11111111
    b0, b1 = wal & m1, (wal >> 1) & m1
    b2, b3 = (wal >> 2) & m1, (wal >> 3) & m1
    ga, t3 = ga[:, None], t3[:, None]
    hi3 = torch.where(ga, b3, b2)
    lo3 = torch.where(ga, b1, b0) | hi3
    cls3 = (hi3 << 1) | (lo3 & ~hi3)
    return torch.where(t3, cls3, (b0 | b2) ^ m1)


def _lex(gcls, qcls, D, wj8):
    import torch

    qw = qcls.shape[1]
    nrem = (D[:, None] - wj8[None, :]).clamp(0, 8)
    full = nrem >= 8
    dmask = torch.where(full, M32,
                        (1 << (4 * torch.where(full, 0, nrem))) - 1)
    diff = (gcls ^ qcls) & dmask
    ctz = _popcount32((~diff) & (diff - 1) & M32)
    candn = torch.where(diff != 0, wj8[None, :] + (ctz >> 2), BIGI)
    mis = candn.min(dim=1).values
    lcp = torch.minimum(mis, D)
    wjx = (mis >> 3).clamp(0, qw - 1)[:, None]
    shx = (mis & 7) * 4
    gv = (gcls.gather(1, wjx)[:, 0] >> shx) & 0xF
    qv = (qcls.gather(1, wjx)[:, 0] >> shx) & 0xF
    cmp = torch.where(mis < D, torch.where(gv < qv, -1, 1), 0)
    return lcp, cmp


def pool_lanes(flat_act, cum_act, pool: int):
    import torch

    n_cells = flat_act.shape[0]
    pdest = torch.where(flat_act & (cum_act <= pool), cum_act - 1, pool)
    lane_id = torch.full((pool + 1,), n_cells, dtype=torch.int64,
                         device=flat_act.device)
    lane_id.scatter_(0, pdest, torch.arange(n_cells, device=flat_act.device))
    return lane_id[:pool]


def _search_compares(args):
    """The plain K4 lanes' search on args, its compares recorded: one
    (lcp, cmp, D) a trip of the k-ary search, then the window's."""
    import torch

    (genome32, index_all, pnib, lens, is_ga, base3, s2, e2, s3, e3,
     flat_act, cum_act, pool, lmax, _mc, ways, kary_iters, ext_w,
     _ns) = args
    lane_id = pool_lanes(flat_act, cum_act, pool)
    dev = lane_id.device
    P = lane_id.shape[0]
    B, o_spec = s2.shape
    n_idx = index_all.shape[0]
    n_lanes = B * o_spec
    dqmax, qw = class_words(lmax)
    nprb = ways - 1
    ip = _unpack(pnib)
    stride = ip.shape[1]
    pvv = lane_id < 2 * n_lanes
    lid = lane_id.clamp(max=2 * n_lanes - 1)
    tbl3 = lid >= n_lanes
    rem = lid % n_lanes
    pb, poff = rem // o_spec, rem % o_spec
    kw_l = torch.where(tbl3, KEY_WEIGHT_THREE, KEY_WEIGHT)
    p_ga = is_ga[pb] & tbl3
    idx_b = torch.where(tbl3, base3[pb], 0)
    lo0 = torch.where(tbl3, s3.reshape(-1)[rem], s2.reshape(-1)[rem])
    hi0 = torch.where(tbl3, e3.reshape(-1)[rem], e2.reshape(-1)[rem])
    Dl = (lens[pb] - poff - kw_l).clamp(0, dqmax)
    jx = torch.arange(8 * qw, device=dev)[None, :] + (poff + kw_l)[:, None]
    qa = torch.where(jx < stride,
                     ip[pb[:, None], jx.clamp(max=stride - 1)], 0)
    qcn = _nib_cls(qa, tbl3[:, None], p_ga[:, None]).reshape(P, qw, 8)
    qcls = qcn[:, :, 0]
    for k in range(1, 8):
        qcls = qcls | (qcn[:, :, k] << (4 * k))
    wj8 = 8 * torch.arange(qw, device=dev)

    def positions(idx):
        return index_all[idx.clamp(0, n_idx - 1)]

    calls = []
    kf = torch.arange(1, ways, device=dev)[:, None]
    aL, bL, aU, bU = lo0, hi0, lo0, hi0
    for _ in range(kary_iters):
        wL, wU = bL - aL, bU - aU
        pL = (aL[None] + kf * (wL[None] // ways)
              + (kf * (wL[None] % ways)) // ways)
        pU = (aU[None] + kf * (wU[None] // ways)
              + (kf * (wU[None] % ways)) // ways)
        mids = torch.cat([pL.reshape(-1), pU.reshape(-1)])
        D2x = Dl.repeat(2 * nprb)
        gpos = positions(idx_b.repeat(2 * nprb) + mids) + kw_l.repeat(
            2 * nprb)
        lcp, cmp = _lex(_gwin_cls(genome32, gpos, tbl3.repeat(2 * nprb),
                                  p_ga.repeat(2 * nprb), qw),
                        qcls.repeat(2 * nprb, 1), D2x, wj8)
        calls.append((lcp, cmp, D2x))
        half = nprb * P
        gL = cmp[:half].reshape(nprb, P) < 0
        gU = cmp[half:].reshape(nprb, P) <= 0
        cL, cU = (aL < bL)[None], (aU < bU)[None]
        aL, bL, aU, bU = (
            torch.where(cL & gL, pL + 1, aL[None]).max(dim=0).values,
            torch.where(cL & ~gL, pL, bL[None]).min(dim=0).values,
            torch.where(cU & gU, pU + 1, aU[None]).max(dim=0).values,
            torch.where(cU & ~gU, pU, bU[None]).min(dim=0).values)
    wi = torch.arange(ext_w, device=dev)[None, :]
    wofs = torch.cat([aL[:, None] - 1 - wi, aU[:, None] + wi], dim=1)
    wc = torch.clamp(wofs, min=lo0[:, None],
                     max=torch.maximum(lo0, hi0 - 1)[:, None])
    n_w = 2 * ext_w
    wposf = (positions((idx_b[:, None] + wc).reshape(-1))
             + kw_l.repeat_interleave(n_w))
    Dw = Dl.repeat_interleave(n_w)
    lcp_w, cmp_w = _lex(_gwin_cls(genome32, wposf,
                                  tbl3.repeat_interleave(n_w),
                                  p_ga.repeat_interleave(n_w), qw),
                        qcls[:, None, :].expand(P, n_w, qw).reshape(-1, qw),
                        Dw, wj8)
    calls.append((lcp_w, cmp_w, Dw))
    return calls, lane_id


def k4_bound(args):
    """K4 (seed_extend) on its 19 arguments: bytes, the cells' flags,
    counts and bucket bounds read and their six extended arrays and
    ext_fb written, each once; each live lane's own inputs, 8 per index
    entry a probe of an open bound or a valid window position reads, and
    the genome words each compare reads up to its first differing class
    word (two for the first); ops, OPS_PER_CLASS_WORD a class word.  None
    when no lane is live."""
    import torch

    calls, lane_id = _search_compares(args)
    (_g, _i, _p, _l, _ga, _b, s2, e2, s3, e3, _fa, _ca, _pool, lmax,
     _mc, ways, kary_iters, ext_w, _ns) = args
    P = lane_id.shape[0]
    n_lanes = s2.numel()
    pvv = lane_id < 2 * n_lanes
    n_live = int(pvv.sum())
    if not n_live:
        return None
    lid = lane_id.clamp(max=2 * n_lanes - 1)
    t3, rem = lid >= n_lanes, lid % n_lanes
    lo0 = torch.where(t3, s3.reshape(-1)[rem], s2.reshape(-1)[rem])
    hi0 = torch.where(t3, e3.reshape(-1)[rem], e2.reshape(-1)[rem])

    def words(lcp, D):
        return torch.where(D > 0, torch.minimum(lcp, D - 1) // 8 + 2, 0)

    nprb = ways - 1
    kf = torch.arange(1, ways, device=lane_id.device)[:, None]

    def probe(a, b):
        w = (b - a)[None]
        return a[None] + kf * (w // ways) + (kf * (w % ways)) // ways

    probes = gwords = 0
    aL, bL, aU, bU = lo0, hi0, lo0, hi0
    for lcp, cmp, D in calls[:kary_iters]:
        cL, cU = (aL < bL) & pvv, (aU < bU) & pvv
        live = torch.cat([cL.repeat(nprb), cU.repeat(nprb)])
        probes += int(live.sum())
        gwords += int(words(lcp, D)[live].sum())
        pL, pU = probe(aL, bL), probe(aU, bU)
        gL = cmp[: nprb * P].reshape(nprb, P) < 0
        gU = cmp[nprb * P :].reshape(nprb, P) <= 0
        aL, bL, aU, bU = (
            torch.where(cL & gL, pL + 1, aL[None]).max(dim=0).values,
            torch.where(cL & ~gL, pL, bL[None]).min(dim=0).values,
            torch.where(cU & gU, pU + 1, aU[None]).max(dim=0).values,
            torch.where(cU & ~gU, pU, bU[None]).min(dim=0).values)
    lcp_w, _, Dw = calls[kary_iters]
    wi = torch.arange(ext_w, device=lane_id.device)[None]
    wofs = torch.cat([aL[:, None] - 1 - wi, aU[:, None] + wi], dim=1)
    valid = ((wofs >= lo0[:, None]) & (wofs < hi0[:, None])
             & pvv[:, None]).reshape(-1)
    n_win = int(valid.sum())
    gwords += int(words(lcp_w, Dw)[valid].sum())
    per_lane = 8 + 1 + 8 + 16 + 4 * class_words(lmax)[1]
    cell_bytes = 2 * n_lanes * 9 + n_lanes * (32 + 48) + s2.shape[0]
    nbytes = (cell_bytes + n_live * per_lane + 8 * (probes + n_win)
              + 4 * gwords)
    return bound(nbytes, OPS_PER_CLASS_WORD * gwords)
