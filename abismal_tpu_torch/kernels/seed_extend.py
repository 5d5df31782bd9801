"""K4: the pooled seed extension of the candidate core, one warp a lane.

Replaces abismal_tpu/map/pipeline.py:679-787, the per-lane body of
_make_core's pooled extension: the k-ary lower/upper-bound search (a
jax.lax.fori_loop over bis_body, :701-745), the LCP window around the
match range (:746-772) and the stop depth, rollback and final range
(:767-787).  It is not a pl.pallas_call: the JAX core leaves it to XLA.
The compaction of active cells into the pool and the scatter back into
the per-cell arrays stay with the caller (map/pipeline.py, extension).

For each pooled lane (lane_id, 2 * B * o_spec for an empty slot), in the
lane order [two-letter cells | three-letter cells] of (unit, offset):
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
seed_extend_plain is the JAX core's arithmetic in torch ops, the
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


def seed_extend_plain(genome32, index_all, pnib, lens, is_ga, base3, s2, e2,
                      s3, e3, lane_id, lmax, mc, ways, kary_iters, ext_w,
                      n_sort):
    """Plain PyTorch K4.  genome32 (NG,) int32 (u32 bits); index_all (N,)
    int64 positions; pnib (B, W) u8 packed units; lens, base3 (B,) int64;
    is_ga (B,) bool; s2, e2, s3, e3 (B, o_spec) int64 bucket ranges into
    index_all (three-letter ones relative to base3); lane_id (P,) int64
    pooled lane ids, 2 B o_spec for an empty slot; lmax, mc (max
    candidates), ways, kary_iters, ext_w (window half-width) and n_sort
    (the sort depth) ints.  Returns (l_out, lo_f, hi_f, deep), (P,) int64
    each: the lane's extended depth, range, and 1 where it reaches past
    n_sort."""
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


def seed_extend(genome32, index_all, pnib, lens, is_ga, base3, s2, e2, s3,
                e3, lane_id, lmax, mc, ways, kary_iters, ext_w, n_sort):
    """K4 wrapper: the plain version for CPU tensors, for CUDA tensors the
    CUDA kernel (or an error), one launch that takes no host sync and
    allocates only its four outputs.  Same arguments and result as
    seed_extend_plain."""
    if lane_id.device.type == "cpu":
        return seed_extend_plain(genome32, index_all, pnib, lens, is_ga,
                                 base3, s2, e2, s3, e3, lane_id, lmax, mc,
                                 ways, kary_iters, ext_w, n_sort)
    genome32 = genome32.to(torch.int32).contiguous()
    index_all, lens, base3, s2, e2, s3, e3, lane_id = (
        t.to(I64).contiguous()
        for t in (index_all, lens, base3, s2, e2, s3, e3, lane_id))
    pnib = pnib.to(torch.uint8).contiguous()
    is_ga = is_ga.to(torch.bool).contiguous()
    _build.require_device("seed_extend", genome32, index_all, pnib, lens,
                          is_ga, base3, s2, e2, s3, e3, lane_id)
    B, o_spec = s2.shape
    if (any(t.shape != s2.shape for t in (e2, s3, e3))
            or any(t.shape != (B,) for t in (lens, is_ga, base3))
            or pnib.shape[0] != B or lane_id.dim() != 1):
        raise ValueError("seed_extend: operand shapes disagree")
    if ways < 2:
        raise ValueError(f"seed_extend: ways {ways} < 2")
    if not mc + 1 <= 2 * ext_w:
        raise ValueError(f"seed_extend: max_candidates {mc} needs a window "
                         f"of more than {2 * ext_w} positions")
    dqmax, qw = class_words(lmax)
    P = lane_id.shape[0]
    out = torch.empty((4, P), dtype=I64, device=lane_id.device)
    if P:
        lib = _build.load()
        with torch.cuda.device(lane_id.device):
            rc = lib.seed_extend_launch(
                genome32.data_ptr(), genome32.shape[0], index_all.data_ptr(),
                index_all.shape[0], pnib.data_ptr(), pnib.shape[1],
                lens.data_ptr(), is_ga.data_ptr(), base3.data_ptr(),
                s2.data_ptr(), e2.data_ptr(), s3.data_ptr(), e3.data_ptr(),
                B, o_spec, lane_id.data_ptr(), P, dqmax, qw, KEY_WEIGHT,
                KEY_WEIGHT_THREE, mc, ways, kary_iters, ext_w, n_sort,
                out.data_ptr(), _build.stream_of(lane_id))
        _build.check(rc, "seed_extend")
        seed_extend.launches += 1
    return out[0], out[1], out[2], out[3]


seed_extend.launches = 0
