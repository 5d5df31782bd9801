"""K4: the pooled seed extension of the candidate core, from the pool's
prefix count to the extended cells, in one launch.

Replaces abismal_tpu/map/pipeline.py:523-806 of _make_core's pooled
extension but its prefix count: the pool's lane ids (jnp.nonzero,
:556-557), the per-lane body (:579-787: the k-ary lower/upper-bound
search, a jax.lax.fori_loop over bis_body, :701-745, the LCP window
around the match range, :746-772, and the stop depth, rollback and final
range, :767-787), the overflow and deep flags and the scatter back into
the per-cell arrays (:789-806).  It is not a pl.pallas_call: the JAX core
leaves it to XLA.  The caller keeps the active cells' flags and their
prefix count (map/pipeline.py, extension).

The cells are (B, o_spec) per table, in the lane order [two-letter cells
| three-letter cells] of (unit, offset); flat_act flags the active ones
(bucket > max_candidates) and cum_act is its cumsum.  Pool slot k holds
the k-th active cell while k < pool (pool_lanes); the cells past the pool
spill.  For each pooled lane:
  - the lane's bucket [lo0, hi0) of index_all (its list starts at idx_b:
    0 for the two-letter table, base3[unit] for the three-letter one)
    and its query: the class string of the unit's nibbles from offset
    poff + kw (two- or three-letter classes), compared to depth
    Dl = clip(len - poff - kw, 0, lmax - KEY_WEIGHT_THREE);
  - kary_iters trips of ways - 1 probes a bound, each probe the class
    string of the genome at index_all[idx_b + p] + kw against the query:
    Lb, the first position not below it, and Ub, the first above it;
  - the LCP of each of the 2 ext_w positions on either side of [Lb, Ub)
    inside [lo0, hi0) (-1 outside), the stop depth from the
    (mc - (Ub - Lb))-th largest of them, and from it the lane's depth
    l_out, range [lo_f, hi_f) and deep flag (a read longer than the sort
    depth).
A pooled lane's (l_out, lo_f, hi_f) replaces its cell's (KEY_WEIGHT or
KEY_WEIGHT_THREE, s, e); ext_fb flags the units with a spilled or a deep
lane.  seed_extend_plain is the JAX core's arithmetic in torch ops, the
reference; seed_extend launches csrc/seed_extend.cu for CUDA tensors."""

from __future__ import annotations

import torch

from ..constants import KEY_WEIGHT, KEY_WEIGHT_THREE
from . import _build
from .banded_align import unpack_nibbles
from .popcount_compare import M32, genome_words, popcount32

I64 = torch.int64
BIGI = 0x3FFFFFFF


def class_words(lmax: int) -> tuple[int, int]:
    """(deepest compare, u32 class words of a query): lmax - 16 nibbles,
    eight a word."""
    dqmax = lmax - KEY_WEIGHT_THREE
    return dqmax, (dqmax + 7) // 8


def lookahead_depth(ways: int) -> int:
    """Trips of the k-ary search that one round of K4's lane warp takes:
    the largest d <= 4 at which both bounds' ways^d - 1 probes fit a warp
    of 32 threads (ways 2: 4, ways 3 and 4: 2, from ways 5 on: 1)."""
    d, p = 1, ways
    while d < 4 and 2 * (p * ways - 1) <= 32:
        p, d = p * ways, d + 1
    return d


def kary_iters_for(ext_iters: int, ways: int) -> int:
    """Trips of the k-ary search that cover a binary search of ext_iters
    steps: the interval shrinks by ~ways a trip, plus one trip of slack
    for the floor-probe rounding (as the JAX core counts them)."""
    kbits = max(1, ways.bit_length() - 1)
    return -(-ext_iters // kbits) + 1


def nib_cls(nib, t3, ga):
    """Per-nibble reduced-alphabet class (two- or three-letter)."""
    b0, b1 = nib & 1, (nib >> 1) & 1
    b2, b3 = (nib >> 2) & 1, (nib >> 3) & 1
    hi3 = torch.where(ga, b3, b2)
    lo3 = torch.where(ga, b1, b0) | hi3
    c3v = 2 * hi3 + (lo3 & (1 - hi3))
    return torch.where(t3, c3v, 1 - (b0 | b2))


def gwin_cls(genome32, g0, t3, ga, qw: int):
    """Genome class words (P, qw) for flat nibble positions g0."""
    ar = torch.arange(qw + 1, device=g0.device)
    A = genome_words(genome32, (g0 >> 3)[:, None] + ar[None, :])
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


def lex(gcls, qcls, D, wj8):
    """(lcp, cmp) of genome vs query class strings to depth D."""
    qw = qcls.shape[1]
    nrem = (D[:, None] - wj8[None, :]).clamp(0, 8)
    full = nrem >= 8
    dmask = torch.where(full, M32,
                        (1 << (4 * torch.where(full, 0, nrem))) - 1)
    diff = (gcls ^ qcls) & dmask
    ctz = popcount32((~diff) & (diff - 1) & M32)
    candn = torch.where(diff != 0, wj8[None, :] + (ctz >> 2), BIGI)
    mis = candn.min(dim=1).values
    lcp = torch.minimum(mis, D)
    wjx = (mis >> 3).clamp(0, qw - 1)[:, None]
    shx = (mis & 7) * 4
    gv = (gcls.gather(1, wjx)[:, 0] >> shx) & 0xF
    qv = (qcls.gather(1, wjx)[:, 0] >> shx) & 0xF
    cmp = torch.where(mis < D, torch.where(gv < qv, -1, 1), 0)
    return lcp, cmp


def lanes_plain(genome32, index_all, pnib, lens, is_ga, base3, s2, e2, s3, e3,
                lane_id, lmax, mc, ways, kary_iters, ext_w, n_sort):
    """The pooled lanes' search, window and stop depth: seed_extend_plain's
    arguments, but lane_id (P,) int64, the pooled lane ids (2 B o_spec for
    an empty slot; pool_lanes) for the flags and the pool.  Returns
    (l_out, lo_f, hi_f, deep), (P,) int64 each: the lane's extended
    depth, range, and 1 where it reaches past n_sort."""
    dev = lane_id.device
    P = lane_id.shape[0]
    B, o_spec = s2.shape
    n_idx = index_all.shape[0]
    n_lanes = B * o_spec
    dqmax, qw = class_words(lmax)
    nprb = ways - 1
    ip = unpack_nibbles(pnib)
    stride = ip.shape[1]

    def ar(n):
        return torch.arange(n, device=dev)

    pvv = lane_id < 2 * n_lanes
    lid = lane_id.clamp(max=2 * n_lanes - 1)
    tbl3 = lid >= n_lanes
    rem = lid % n_lanes
    pb = rem // o_spec
    poff = rem % o_spec
    kw_l = torch.where(tbl3, KEY_WEIGHT_THREE, KEY_WEIGHT)
    p_ga = is_ga[pb] & tbl3
    idx_b = torch.where(tbl3, base3[pb], 0)
    lo0 = torch.where(tbl3, s3.reshape(-1)[rem], s2.reshape(-1)[rem])
    hi0 = torch.where(tbl3, e3.reshape(-1)[rem], e2.reshape(-1)[rem])
    rl = lens[pb] - poff
    Dl = (rl - kw_l).clamp(0, dqmax)
    deep = (pvv & (rl > n_sort)).to(I64)

    # query class words from read offset poff + kw
    jx = ar(8 * qw)[None, :] + (poff + kw_l)[:, None]
    qa = torch.where(jx < stride,
                     ip[pb[:, None], jx.clamp(max=stride - 1)], 0)
    qcn = nib_cls(qa, tbl3[:, None], p_ga[:, None]).reshape(P, qw, 8)
    qcls = qcn[:, :, 0]
    for k in range(1, 8):
        qcls = qcls | (qcn[:, :, k] << (4 * k))
    wj8 = 8 * ar(qw)

    def positions(idx):
        return index_all[idx.clamp(0, n_idx - 1)]

    tbl2x = tbl3.repeat(2 * nprb)
    ga2x = p_ga.repeat(2 * nprb)
    D2x = Dl.repeat(2 * nprb)
    ib2x = idx_b.repeat(2 * nprb)
    kw2x = kw_l.repeat(2 * nprb)
    qcls2x = qcls.repeat(2 * nprb, 1)
    kf = torch.arange(1, ways, device=dev)[:, None]
    aL, bL, aU, bU = lo0, hi0, lo0, hi0
    for _ in range(kary_iters):
        wL, wU = bL - aL, bU - aU
        # interior probes a + floor(w k / ways), written so k w cannot
        # overflow (as the JAX core does)
        pL = (aL[None] + kf * (wL[None] // ways)
              + (kf * (wL[None] % ways)) // ways)
        pU = (aU[None] + kf * (wU[None] // ways)
              + (kf * (wU[None] % ways)) // ways)
        mids = torch.cat([pL.reshape(-1), pU.reshape(-1)])
        gpos = positions(ib2x + mids) + kw2x
        _, cmp = lex(gwin_cls(genome32, gpos, tbl2x, ga2x, qw), qcls2x, D2x,
                     wj8)
        half = nprb * P
        gL = cmp[:half].reshape(nprb, P) < 0
        gU = cmp[half:].reshape(nprb, P) <= 0
        cL, cU = (aL < bL)[None], (aU < bU)[None]
        aL, bL, aU, bU = (
            torch.where(cL & gL, pL + 1, aL[None]).max(dim=0).values,
            torch.where(cL & ~gL, pL, bL[None]).min(dim=0).values,
            torch.where(cU & gU, pU + 1, aU[None]).max(dim=0).values,
            torch.where(cU & ~gU, pU, bU[None]).min(dim=0).values)
    Lb, Ub = aL, aU

    # LCP window: ext_w positions on each side of [L, U)
    wi = ar(ext_w)[None, :]
    wofs = torch.cat([Lb[:, None] - 1 - wi, Ub[:, None] + wi], dim=1)
    wvalid = ((wofs >= lo0[:, None]) & (wofs < hi0[:, None])
              & pvv[:, None])
    wc = torch.clamp(wofs, min=lo0[:, None],
                     max=torch.maximum(lo0, hi0 - 1)[:, None])
    n_w = 2 * ext_w
    wposf = (positions((idx_b[:, None] + wc).reshape(-1))
             + kw_l.repeat_interleave(n_w))
    gcls_w = gwin_cls(genome32, wposf, tbl3.repeat_interleave(n_w),
                      p_ga.repeat_interleave(n_w), qw)
    qcls_w = qcls[:, None, :].expand(P, n_w, qw).reshape(-1, qw)
    lcp_w, _ = lex(gcls_w, qcls_w, Dl.repeat_interleave(n_w), wj8)
    lcp_w = torch.where(wvalid.reshape(-1), lcp_w, -1).reshape(P, n_w)

    # stop depth t*, rollback and final range from the window LCPs
    c0 = Ub - Lb
    topv = torch.topk(lcp_w, mc + 1, dim=1, sorted=True).values
    kth = topv.gather(1, (mc - c0).clamp(0, mc)[:, None])[:, 0]
    tstar = torch.where(c0 > mc, BIGI, torch.clamp(kth + 1, min=1))
    tfin = torch.minimum(tstar, Dl)
    cnt_fin = c0 + (lcp_w >= tfin[:, None]).sum(dim=1)
    rollb = (cnt_fin == 0) & (tfin >= 1)
    t_use = torch.where(rollb, tfin - 1, tfin)
    l_out = kw_l + t_use
    thr_t = t_use.clamp(min=1)[:, None]
    nl = (lcp_w[:, :ext_w] >= thr_t).sum(dim=1)
    nr = (lcp_w[:, ext_w:] >= thr_t).sum(dim=1)
    fullr = t_use == 0
    lo_f = torch.where(fullr, lo0, Lb - nl)
    hi_f = torch.where(fullr, hi0, Ub + nr)
    return l_out, lo_f, hi_f, deep


def pool_lanes(flat_act, cum_act, pool: int):
    """The pool's lane ids (pool,): the active cells' ids in order, then
    2 B o_spec for each empty slot (JAX's nonzero(size=pool,
    fill_value=2 n_lanes)), from the flags and their prefix count, without
    a host sync."""
    n_cells = flat_act.shape[0]
    pdest = torch.where(flat_act & (cum_act <= pool), cum_act - 1, pool)
    lane_id = torch.full((pool + 1,), n_cells, dtype=I64,
                         device=flat_act.device)
    lane_id.scatter_(0, pdest, torch.arange(n_cells, device=flat_act.device))
    return lane_id[:pool]


def seed_extend_plain(genome32, index_all, pnib, lens, is_ga, base3, s2, e2,
                      s3, e3, flat_act, cum_act, pool, lmax, mc, ways,
                      kary_iters, ext_w, n_sort):
    """Plain PyTorch K4.  genome32 (NG,) int32 (u32 bits); index_all (N,)
    int64 positions; pnib (B, W) u8 packed units; lens, base3 (B,) int64;
    is_ga (B,) bool; s2, e2, s3, e3 (B, o_spec) int64 bucket ranges into
    index_all (three-letter ones relative to base3); flat_act (2 B o_spec,)
    bool, the active cells, and cum_act its cumsum (int64); pool (slots),
    lmax, mc (max candidates), ways, kary_iters, ext_w (window
    half-width) and n_sort (the sort depth) ints.  Returns the extended
    cells (l2, s2x, e2x, l3, s3x, e3x), (B, o_spec) int64 each, and ext_fb
    (B,) bool, the units whose lanes spilled from the pool or reach past
    n_sort."""
    dev = pnib.device
    B, o_spec = s2.shape
    n_lanes = B * o_spec
    lane_id = pool_lanes(flat_act, cum_act, pool)
    # lanes beyond the pool flag their units for host fallback
    over_lane = flat_act & (cum_act > pool)
    ext_fb = over_lane.reshape(2, B, o_spec).any(dim=2).any(dim=0)

    # the pooled lanes' search, window and stop depth
    l_out, lo_f, hi_f, deep = lanes_plain(
        genome32, index_all, pnib, lens, is_ga, base3, s2, e2, s3, e3,
        lane_id, lmax, mc, ways, kary_iters, ext_w, n_sort)
    pvv = lane_id < 2 * n_lanes
    lid = lane_id.clamp(max=2 * n_lanes - 1)
    tbl3 = lid >= n_lanes
    rem = lid % n_lanes
    deep_u = torch.zeros(B, dtype=I64, device=dev).scatter_reduce(
        0, torch.where(pvv, rem // o_spec, 0), deep, "amax")
    ext_fb = ext_fb | (deep_u > 0)

    # scatter pooled results back into the per-cell arrays
    d_t2 = torch.where(pvv & ~tbl3, rem, n_lanes)
    d_t3 = torch.where(pvv & tbl3, rem, n_lanes)

    def put_back(init, dst, val):
        flat = torch.cat([init.reshape(-1),
                          torch.zeros(1, dtype=I64, device=dev)])
        return flat.scatter(0, dst, val)[:n_lanes].reshape(B, o_spec)

    kw2 = torch.full((B, o_spec), KEY_WEIGHT, dtype=I64, device=dev)
    kw3 = torch.full((B, o_spec), KEY_WEIGHT_THREE, dtype=I64, device=dev)
    l2, s2x, e2x = (put_back(kw2, d_t2, l_out), put_back(s2, d_t2, lo_f),
                    put_back(e2, d_t2, hi_f))
    l3, s3x, e3x = (put_back(kw3, d_t3, l_out), put_back(s3, d_t3, lo_f),
                    put_back(e3, d_t3, hi_f))
    return l2, s2x, e2x, l3, s3x, e3x, ext_fb


def seed_extend(genome32, index_all, pnib, lens, is_ga, base3, s2, e2, s3,
                e3, flat_act, cum_act, pool, lmax, mc, ways, kary_iters,
                ext_w, n_sort):
    """K4 wrapper: the plain version for CPU tensors, for CUDA tensors the
    CUDA kernel (or an error), one launch that takes no host sync and
    allocates only its outputs.  Same arguments and result as
    seed_extend_plain; cum_act must be flat_act's cumsum."""
    if pnib.device.type == "cpu":
        return seed_extend_plain(genome32, index_all, pnib, lens, is_ga,
                                 base3, s2, e2, s3, e3, flat_act, cum_act,
                                 pool, lmax, mc, ways, kary_iters, ext_w,
                                 n_sort)
    genome32 = genome32.to(torch.int32).contiguous()
    index_all, lens, base3, s2, e2, s3, e3, cum_act = (
        t.to(I64).contiguous()
        for t in (index_all, lens, base3, s2, e2, s3, e3, cum_act))
    pnib = pnib.to(torch.uint8).contiguous()
    is_ga = is_ga.to(torch.bool).contiguous()
    flat_act = flat_act.to(torch.bool).contiguous()
    _build.require_device("seed_extend", genome32, index_all, pnib, lens,
                          is_ga, base3, s2, e2, s3, e3, flat_act, cum_act)
    B, o_spec = s2.shape
    if (any(t.shape != s2.shape for t in (e2, s3, e3))
            or any(t.shape != (B,) for t in (lens, is_ga, base3))
            or pnib.shape[0] != B
            or any(t.shape != (2 * B * o_spec,) for t in (flat_act,
                                                         cum_act))):
        raise ValueError("seed_extend: operand shapes disagree")
    if ways < 2:
        raise ValueError(f"seed_extend: ways {ways} < 2")
    if not mc + 1 <= 2 * ext_w < 1 << 16:
        raise ValueError(f"seed_extend: max_candidates {mc} and a window of "
                         f"{2 * ext_w} positions: it needs more than mc + 1 "
                         "and fewer than 65536")
    dqmax, qw = class_words(lmax)
    if qw + 1 > 63 or 2 * B * o_spec >= 1 << 31:
        raise ValueError(f"seed_extend: lmax {lmax} above 512, or "
                         f"{2 * B * o_spec} cells, 2^31 or more")
    cells = torch.empty((6, B, o_spec), dtype=I64, device=pnib.device)
    ext_fb = torch.empty(B, dtype=torch.bool, device=pnib.device)
    if B * o_spec:
        lib = _build.load()
        with torch.cuda.device(pnib.device):
            rc = lib.seed_extend_launch(
                genome32.data_ptr(), genome32.shape[0], index_all.data_ptr(),
                index_all.shape[0], pnib.data_ptr(), pnib.shape[1],
                lens.data_ptr(), is_ga.data_ptr(), base3.data_ptr(),
                s2.data_ptr(), e2.data_ptr(), s3.data_ptr(), e3.data_ptr(),
                flat_act.data_ptr(), cum_act.data_ptr(), B, o_spec, pool,
                dqmax, qw, KEY_WEIGHT, KEY_WEIGHT_THREE, mc, ways,
                kary_iters, ext_w, n_sort, cells.data_ptr(),
                ext_fb.data_ptr(), _build.stream_of(pnib))
        _build.check(rc, "seed_extend")
        seed_extend.launches += 1
    return (*cells.unbind(0), ext_fb)


seed_extend.launches = 0
