"""PyTorch port of the single-end device pipeline of
abismal_tpu/map/pipeline.py: the candidate core (_make_core), the fused
stage-1+2 program with on-device traceback (build_stage12; JAX's
build_tb_block is the kernel wrapper kernels.banded_align.banded_trace),
the engine half that feeds the native finalize (TorchNativeEngine) and its
factory.  Names follow the JAX module so each counterpart is easy to find.

The NumPy helpers (budgets, genome packing, unit patterns, constants) are
in host_units.py beside this module, and the host side -- the C++ native
engine, run_map, I/O -- is the port's own (map/native_engine.py,
map/engine.py, io/).

Integer conventions: genome positions, bucket offsets and index entries
are int64 tensors carrying u32 values, so the TPU layout's i32 modular
wrap and its overlapped genome rows are not needed; the packed genome is
int32 storage of u32 words.  Every program here is sync-free on the
device (no data-dependent shapes), so a chunk's work is enqueued in one
go and collected with one copy in finish_se."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..constants import (
    KEY_WEIGHT, KEY_WEIGHT_THREE, MIN_FOLD_SIZE, N_SORTING_POSITIONS,
    WINDOW_SIZE,
)
from ..device import resolve_device
from ..kernels.banded_align import (
    BW_MAX, QOFF, banded_score, banded_trace_packed, unpack_nibbles,
    win_start, window_nibbles,
)
from ..kernels.popcount_compare import M32, genome_words, popcount32
from ..kernels.popcount_compare import popcount_compare
from ..parallel.mesh import (
    make_mesh, replicate_tables, shard_stage12, shard_stage12pe,
)
from ..utils.dna import ENCODE_A_RICH, ENCODE_T_RICH
from .host_units import (
    DEVICE_MIN_LEN, HASH3_MOD, REC_FALLBACK, SLOT, TB_NOPS, _ascii_matrices,
    _pe_is_ga_pattern, _resolve_cand_budget, _se_scode_pattern,
    estimate_cand_budget, ext_iters_for, get_conv_is_ga, o_spec_for,
    pack_genome_u32,
)
from .native_engine import NativeMappingEngine

I64 = torch.int64
INF32 = 0x7FFFFFFF
POS_EMPTY = 0xFFFFFFFF
F_RC, F_SECONDARY, F_A_RICH = 0x10, 0x100, 0x1000


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 (or i32) values -> int32 with the same bits."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _pad1(x, n: int, value):
    if n == 0:
        return x
    return torch.cat([x, torch.full((n,), value, dtype=x.dtype,
                                    device=x.device)])


def _phase_marker(marks):
    """mark(name): appends (name, a recorded CUDA event) to the list
    marks, or does nothing when marks is None."""

    def mark(name):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

    return mark


def _unit_base(start, value, n):
    """(n,) per-candidate value of its unit: value[u] scattered at the
    unit's first candidate start[u] (clamped to n), then carried forward
    by a running max (unit values never decrease)."""
    m = torch.zeros(n + 1, dtype=I64, device=start.device).scatter_reduce(
        0, start, value, "amax")
    return torch.cummax(m[:n], dim=0).values


class DeviceIndex:
    """Device-resident index tables (↔ the JAX DeviceIndex):
      genome32  (NG,) int32  u32 words of the 4-bit genome, 8 bases each;
      counter2  (2^25 + 1,) int64  two-letter bucket offsets;
      counter3  (2 (3^16 + 1),) int64  three-letter offsets [C->T | G->A];
      index_all (n2 + 2 n3,) int64  positions [two | C->T | G->A]."""

    def __init__(self, genome32, counter2, counter3, index_all, n_index2,
                 n_index3, max_candidates, ext_iters):
        self.genome32 = genome32
        self.counter2 = counter2
        self.counter3 = counter3
        self.index_all = index_all
        self.n_index2 = int(n_index2)
        self.n_index3 = int(n_index3)
        self.max_candidates = int(max_candidates)
        self.ext_iters = int(ext_iters)

    def tables(self):
        return (self.genome32, self.counter2, self.counter3, self.index_all)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tables())

    @classmethod
    def _from_arrays(cls, g32, c2, c3, idx, n2, n3, mc, ext_iters, device):
        dev = resolve_device(device)
        if idx.shape[0] == 0:
            idx = np.zeros(1, np.int64)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(put(g32.view(np.int32)), put(c2), put(c3), put(idx),
                   n2, n3, mc, ext_iters)

    @classmethod
    def from_index(cls, index, device):
        c3 = np.concatenate([index.counter_t, index.counter_a])
        idx = np.concatenate([index.index, index.index_t, index.index_a])
        return cls._from_arrays(
            pack_genome_u32(index.genome_words),
            index.counter.astype(np.int64), c3.astype(np.int64),
            idx.astype(np.int64), index.index.shape[0],
            index.index_t.shape[0], index.max_candidates,
            ext_iters_for(index), device)

    @classmethod
    def from_numpy_tables(cls, genome32, counter2, counter3, index_all,
                          n_index2, n_index3, max_candidates, ext_iters,
                          device):
        """From the arrays the JAX DeviceIndex holds (np.asarray of its
        tables(), genome2o excluded): (N, 2) i32 counter pair rows with
        modular wrap, i32 index_all.  Values are re-read as u32."""

        def prefix(pairs):
            p = np.asarray(pairs).astype(np.int64) & M32
            return np.concatenate([p[:, 0], p[-1:, 1]])

        c3 = np.asarray(counter3)
        half = c3.shape[0] // 2
        return cls._from_arrays(
            np.asarray(genome32).astype(np.uint32), prefix(counter2),
            np.concatenate([prefix(c3[:half]), prefix(c3[half:])]),
            np.asarray(index_all).astype(np.int64) & M32, n_index2, n_index3,
            max_candidates, ext_iters, device)


def _make_core(lmax: int, max_candidates: int, n_index2: int, n_index3: int,
               cand_per_unit: int, ext_iters: int = 31,
               ext_pool: int | None = None):
    """Candidate core (↔ JAX _make_core, non-TP): rolling hashes, bucket
    ranges, pooled k-ary seed extension, check gates, the global candidate
    list and the K1 compare.  Returns (core, o_spec); core(genome32,
    counter2, counter3, index_all, pnib, lens, is_ga, uextra) -> dict of
    per-candidate (pos, d, b_of, cell_of, slot, valid, extras) and per-unit
    (unit_start, unit_total, overflow) tensors."""
    ext_iters = int(os.environ.get("ABISMAL_TPU_EXT_ITERS", ext_iters))
    ways = int(os.environ.get("ABISMAL_TPU_EXT_WAYS", 4))
    o_spec = o_spec_for(lmax)
    o_sens = lmax - KEY_WEIGHT + 1
    n_cells = (o_spec + o_sens) * 2
    n_words = 2 * ((lmax + 15) // 16)  # u32 words incl. the 0xF tail block
    CELLCAP = SLOT
    mc = max_candidates
    assert n_words + 1 + 63 <= 128, "lmax too long"
    assert o_spec <= o_sens, "lmax too small for the shared range gather"
    EXT_W = SLOT + 1  # LCP window half-width
    DQMAX = lmax - KEY_WEIGHT_THREE
    QW = (DQMAX + 7) // 8  # u32 class words, 8 nibbles each
    BIGI = 0x3FFFFFFF
    NPRB = ways - 1
    kary_iters = -(-ext_iters // max(1, int(np.log2(ways)))) + 1

    def windowed_full(sym, width, radix):
        """Sliding-window polynomial values (msd first) by width doubling:
        H_{w+v}(i) = H_w(i) radix^v + H_v(i + w)."""
        h, w = sym, 1
        while 2 * w <= width:
            h = h[:, : h.shape[1] - w] * radix ** w + h[:, w:]
            w *= 2
        rem = width - w
        if rem:
            hr = windowed_full(sym, rem, radix)
            n = min(h.shape[1], hr.shape[1] - w)
            h = h[:, :n] * radix ** rem + hr[:, w : w + n]
        return h

    def nib_cls(nib, t3, ga):
        """Per-nibble reduced-alphabet class (two- or three-letter)."""
        b0, b1 = nib & 1, (nib >> 1) & 1
        b2, b3 = (nib >> 2) & 1, (nib >> 3) & 1
        hi3 = torch.where(ga, b3, b2)
        lo3 = torch.where(ga, b1, b0) | hi3
        c3v = 2 * hi3 + (lo3 & (1 - hi3))
        return torch.where(t3, c3v, 1 - (b0 | b2))

    def gwin_cls(genome32, g0, t3, ga):
        """Genome class words (P, QW) for flat nibble positions g0."""
        ar = torch.arange(QW + 1, device=g0.device)
        A = genome_words(genome32, (g0 >> 3)[:, None] + ar[None, :])
        sh = ((g0 & 7) * 4)[:, None]
        wal = ((A[:, :QW] >> sh) | (A[:, 1:] << (32 - sh))) & M32
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
        nrem = (D[:, None] - wj8[None, :]).clamp(0, 8)
        full = nrem >= 8
        dmask = torch.where(full, M32,
                            (1 << (4 * torch.where(full, 0, nrem))) - 1)
        diff = (gcls ^ qcls) & dmask
        ctz = popcount32((~diff) & (diff - 1) & M32)
        candn = torch.where(diff != 0, wj8[None, :] + (ctz >> 2), BIGI)
        mis = candn.min(dim=1).values
        lcp = torch.minimum(mis, D)
        wjx = (mis >> 3).clamp(0, QW - 1)[:, None]
        shx = (mis & 7) * 4
        gv = (gcls.gather(1, wjx)[:, 0] >> shx) & 0xF
        qv = (qcls.gather(1, wjx)[:, 0] >> shx) & 0xF
        cmp = torch.where(mis < D, torch.where(gv < qv, -1, 1), 0)
        return lcp, cmp

    def core(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
             uextra):
        dev = pnib.device
        B = pnib.shape[0]
        EXT_POOL = int(os.environ.get(
            "ABISMAL_TPU_EXT_POOL",
            max(512, B // 4) if ext_pool is None else ext_pool))
        gflat = B * cand_per_unit
        n_idx = index_all.shape[0]
        lens = lens.to(I64)
        is_ga = is_ga.to(torch.bool)

        def ar(n):
            return torch.arange(n, device=dev)

        ip = unpack_nibbles(pnib)  # (B, stride)
        stride = ip.shape[1]

        # --- read words, tail padded with 0xF match-any (abismal.cpp:1388)
        base = ar(n_words * 8)[None, :]
        pad16 = ((lens + 15) // 16) * 16
        nibv = torch.where(base < lens[:, None], ip[:, : n_words * 8],
                           torch.where(base < pad16[:, None], 0xF, 0))
        nibv = nibv.reshape(B, n_words, 8)
        packed = nibv[:, :, 0]
        for k in range(1, 8):
            packed = packed | (nibv[:, :, k] << (4 * k))

        # --- rolling hashes for every offset (AbismalIndex.hpp:271-305)
        bits = ((ip & 5) == 0).to(I64)
        k2_all = windowed_full(bits, KEY_WEIGHT, 2)[:, :o_sens]
        tct = (((ip & 4) != 0).to(I64) << 1) | ((ip & 1) != 0).to(I64)
        tga = (((ip & 8) != 0).to(I64) << 1) | ((ip & 2) != 0).to(I64)
        k3t = windowed_full(tct, KEY_WEIGHT_THREE, 3)[:, :o_sens]
        k3a = windowed_full(tga, KEY_WEIGHT_THREE, 3)[:, :o_sens]
        k3_all = torch.where(is_ga[:, None], k3a % HASH3_MOD, k3t % HASH3_MOD)

        # --- bucket ranges for all cells (both phases share the gather)
        specific_len = torch.minimum(lens - WINDOW_SIZE, lens >> 1)
        specific_lim = torch.where(
            lens > 0, torch.clamp(lens >> 1, min=WINDOW_SIZE), 0)
        sens_lim = lens - KEY_WEIGHT + 1
        base3 = n_index2 + is_ga.to(I64) * n_index3  # into index_all
        c3_base = is_ga.to(I64) * (counter3.shape[0] // 2)
        act_sp = ar(o_spec)[None, :] < specific_lim[:, None]
        act_sn = ((ar(o_sens)[None, :] < sens_lim[:, None])
                  & (lens[:, None] > 0))
        gmask = act_sn.clone()
        gmask[:, :o_spec] |= act_sp
        k2n = torch.where(gmask, k2_all, 0)
        k3n = torch.where(gmask, k3_all, 0) + c3_base[:, None]
        p2s, p2e = counter2[k2n], counter2[k2n + 1]
        p3s, p3e = counter3[k3n], counter3[k3n + 1]
        s2 = torch.where(act_sp, p2s[:, :o_spec], 0)
        e2 = torch.where(act_sp, p2e[:, :o_spec], 0)
        s3 = torch.where(act_sp, p3s[:, :o_spec], 0)
        e3 = torch.where(act_sp, p3e[:, :o_spec], 0)

        # --- pooled seed extension, LCP-window method (see the JAX core,
        # pipeline.py:513-806): active lanes (bucket > max_candidates)
        # compact into EXT_POOL slots, a k-ary lower/upper-bound search
        # finds the class-string match range, and the stop depth falls out
        # of the window LCPs around it
        n_lanes = B * o_spec
        flat_act = torch.cat([(act_sp & ((e2 - s2) > mc)).reshape(-1),
                              (act_sp & ((e3 - s3) > mc)).reshape(-1)])
        cum_act = torch.cumsum(flat_act.to(I64), dim=0)
        # nonzero(size=EXT_POOL, fill_value=2 n_lanes) without a host sync
        pdest = torch.where(flat_act & (cum_act <= EXT_POOL), cum_act - 1,
                            EXT_POOL)
        lane_id = torch.full((EXT_POOL + 1,), 2 * n_lanes, dtype=I64,
                             device=dev)
        lane_id.scatter_(0, pdest, ar(2 * n_lanes))
        lane_id = lane_id[:EXT_POOL]
        # lanes beyond the pool flag their units for host fallback
        over_lane = flat_act & (cum_act > EXT_POOL)
        ext_fb = over_lane.reshape(2, B, o_spec).any(dim=2).any(dim=0)

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
        Dl = (rl - kw_l).clamp(0, DQMAX)
        deep = (pvv & (rl > N_SORTING_POSITIONS)).to(I64)
        deep_u = torch.zeros(B, dtype=I64, device=dev).scatter_reduce(
            0, torch.where(pvv, pb, 0), deep, "amax")
        ext_fb = ext_fb | (deep_u > 0)

        # query class words from read offset poff + kw
        jx = ar(8 * QW)[None, :] + (poff + kw_l)[:, None]
        qa = torch.where(jx < stride,
                         ip[pb[:, None], jx.clamp(max=stride - 1)], 0)
        qcn = nib_cls(qa, tbl3[:, None], p_ga[:, None]).reshape(
            EXT_POOL, QW, 8)
        qcls = qcn[:, :, 0]
        for k in range(1, 8):
            qcls = qcls | (qcn[:, :, k] << (4 * k))
        wj8 = 8 * ar(QW)

        def positions(idx):
            return index_all[idx.clamp(0, n_idx - 1)]

        tbl2x = tbl3.repeat(2 * NPRB)
        ga2x = p_ga.repeat(2 * NPRB)
        D2x = Dl.repeat(2 * NPRB)
        ib2x = idx_b.repeat(2 * NPRB)
        kw2x = kw_l.repeat(2 * NPRB)
        qcls2x = qcls.repeat(2 * NPRB, 1)
        kf = torch.arange(1, ways, device=dev)[:, None]
        aL, bL, aU, bU = lo0, hi0, lo0, hi0
        for _ in range(kary_iters):
            wL, wU = bL - aL, bU - aU
            # interior probes a + floor(w k / WAYS), written so k w cannot
            # overflow (as the JAX core does)
            pL = (aL[None] + kf * (wL[None] // ways)
                  + (kf * (wL[None] % ways)) // ways)
            pU = (aU[None] + kf * (wU[None] // ways)
                  + (kf * (wU[None] % ways)) // ways)
            mids = torch.cat([pL.reshape(-1), pU.reshape(-1)])
            gpos = positions(ib2x + mids) + kw2x
            _, cmp = lex(gwin_cls(genome32, gpos, tbl2x, ga2x), qcls2x, D2x,
                         wj8)
            half = NPRB * EXT_POOL
            gL = cmp[:half].reshape(NPRB, EXT_POOL) < 0
            gU = cmp[half:].reshape(NPRB, EXT_POOL) <= 0
            cL, cU = (aL < bL)[None], (aU < bU)[None]
            aL, bL, aU, bU = (
                torch.where(cL & gL, pL + 1, aL[None]).max(dim=0).values,
                torch.where(cL & ~gL, pL, bL[None]).min(dim=0).values,
                torch.where(cU & gU, pU + 1, aU[None]).max(dim=0).values,
                torch.where(cU & ~gU, pU, bU[None]).min(dim=0).values)
        Lb, Ub = aL, aU

        # LCP window: EXT_W positions on each side of [L, U)
        wi = ar(EXT_W)[None, :]
        wofs = torch.cat([Lb[:, None] - 1 - wi, Ub[:, None] + wi], dim=1)
        wvalid = ((wofs >= lo0[:, None]) & (wofs < hi0[:, None])
                  & pvv[:, None])
        wc = torch.clamp(wofs, min=lo0[:, None],
                         max=torch.maximum(lo0, hi0 - 1)[:, None])
        n_w = 2 * EXT_W
        wposf = (positions((idx_b[:, None] + wc).reshape(-1))
                 + kw_l.repeat_interleave(n_w))
        gcls_w = gwin_cls(genome32, wposf, tbl3.repeat_interleave(n_w),
                          p_ga.repeat_interleave(n_w))
        qcls_w = qcls[:, None, :].expand(EXT_POOL, n_w, QW).reshape(-1, QW)
        lcp_w, _ = lex(gcls_w, qcls_w, Dl.repeat_interleave(n_w), wj8)
        lcp_w = torch.where(wvalid.reshape(-1), lcp_w, -1).reshape(
            EXT_POOL, n_w)

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
        nl = (lcp_w[:, :EXT_W] >= thr_t).sum(dim=1)
        nr = (lcp_w[:, EXT_W:] >= thr_t).sum(dim=1)
        fullr = t_use == 0
        lo_f = torch.where(fullr, lo0, Lb - nl)
        hi_f = torch.where(fullr, hi0, Ub + nr)

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

        # --- check gates and the two- vs three-letter fold rule
        d2, d3 = e2x - s2x, e3x - s3x
        check2_sp = act_sp & ((d2 <= mc) | (l2 >= specific_len[:, None]))
        check3_sp = act_sp & ((d3 <= mc) | (l3 >= specific_len[:, None]))
        s2n = torch.where(act_sn, p2s, 0)
        d2n = torch.where(act_sn, p2e, 0) - s2n
        s3n = torch.where(act_sn, p3s, 0)
        d3n = torch.where(act_sn, p3e, 0) - s3n
        check2_sn = act_sn & (d2n != 0) & (d2n <= mc) & (
            (d3n == 0) | (d2n <= MIN_FOLD_SIZE * d3n))
        check3_sn = act_sn & (d3n != 0) & (d3n <= mc)

        def interleave(a, b):
            return torch.stack([a, b], dim=2).reshape(B, -1)

        cnt_cells = torch.cat([
            interleave(torch.where(check2_sp, d2, 0),
                       torch.where(check3_sp, d3, 0)),
            interleave(torch.where(check2_sn, d2n, 0),
                       torch.where(check3_sn, d3n, 0))], dim=1)
        overflow = (cnt_cells > CELLCAP).any(dim=1) | ext_fb
        cnt_cells = cnt_cells.clamp(max=CELLCAP)
        lo_cells = torch.cat([interleave(s2x, base3[:, None] + s3x),
                              interleave(s2n, base3[:, None] + s3n)], dim=1)

        # --- global candidate list: prefix sums, then each candidate's
        # cell by a binary search over the cells' start offsets
        cnt_flat = cnt_cells.reshape(-1)
        inc = torch.cumsum(cnt_flat, dim=0)
        unit_total = cnt_cells.sum(dim=1)
        unit_start = torch.cumsum(unit_total, dim=0) - unit_total
        overflow = overflow | (unit_start + unit_total > gflat)
        f = ar(gflat)
        starts = inc - cnt_flat
        cell_gid = torch.searchsorted(starts, f, right=True) - 1
        b_of = cell_gid // n_cells
        cell_of = cell_gid % n_cells
        valid = f < inc[-1]
        slot = f - starts[cell_gid]
        lo_flat = lo_cells.reshape(-1)[cell_gid]
        nw_unit = 2 * ((lens + 15) // 16)
        extras = uextra[b_of]
        coff = torch.where(cell_of < 2 * o_spec, cell_of >> 1,
                           (cell_of - 2 * o_spec) >> 1)
        pos = (index_all[torch.where(valid, lo_flat + slot, 0)] - coff) & M32
        pos = torch.where(valid, pos, 0)

        # --- K1 popcount compare over the genome windows
        d = popcount_compare(genome32, pos, u32_to_i32(packed), b_of,
                             nw_unit[b_of])
        return dict(pos=pos, d=d, b_of=b_of, cell_of=cell_of, slot=slot,
                    valid=valid, extras=extras, unit_start=unit_start,
                    unit_total=unit_total, overflow=overflow)

    return core, o_spec


def build_stage12(lmax: int, max_candidates: int, n_index2: int,
                  n_index3: int, per: int, cand_per_unit: int | None = None,
                  k_slots: int = 50, jobs_per_read: int = 8,
                  ext_iters: int = 31, device_tb: bool | None = None,
                  ext_pool: int | None = None):
    """Fused stage-1+2 for single-end mapping (↔ JAX build_stage12; the
    exactness argument is in that docstring).  Returns (stage12, o_spec);
    stage12(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
    scode, max_diffs_r, marks=None) -> (R, 8 + TB_NOPS) i32 packed rows
    [rec(4) | cig_meta(4) | cig_ops(TB_NOPS)] (only rec with device_tb
    off).  marks, a list, collects (name, CUDA event) pairs at the
    program's phase boundaries: start, core, decide, score (K2 done),
    select (winners and records done), end (traceback done)."""
    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    K = int(os.environ.get("ABISMAL_TPU_K_SLOTS", k_slots))
    jobs_per_read = int(os.environ.get("ABISMAL_TPU_JOBS_PER_READ",
                                       jobs_per_read))
    if device_tb is None:
        device_tb = os.environ.get("ABISMAL_TPU_DEVTB", "1") == "1"
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, ext_iters=ext_iters,
                              ext_pool=ext_pool)
    WW3 = lmax + QOFF  # window rows per job
    K2 = ((K + 14 + 15) // 16) * 16

    def stage12(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
                scode, max_diffs_r, marks=None):
        dev = pnib.device
        mark = _phase_marker(marks)

        def ar(n):
            return torch.arange(n, device=dev)

        mark("start")
        B = pnib.shape[0]
        R = B // per
        J = ((jobs_per_read * R + 127) // 128) * 128
        rlen = lens.to(I64).reshape(R, per).max(dim=1).values
        good_cut = rlen // 10  # == int(0.1 * len)
        sens_gate = (2 * rlen) // 5  # == int(0.4 * len)
        max_scr = 2 * rlen
        uextra = torch.stack([good_cut.repeat_interleave(per),
                              sens_gate.repeat_interleave(per),
                              scode.to(I64).repeat(R)], dim=1)
        c = core(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
                 uextra)
        mark("core")
        pos, b_of = c["pos"], c["b_of"]
        cell_of, valid = c["cell_of"], c["valid"]
        d = c["d"].to(I64)
        unit_total, overflow, extras = (c["unit_total"], c["overflow"],
                                        c["extras"])
        ncand = pos.shape[0]
        r_of = b_of // per

        # --- decision gates (constant per phase while the heap is not full)
        phase_sp = cell_of < 2 * o_spec
        gate = valid & torch.where(phase_sp, d <= extras[:, 0],
                                   d <= extras[:, 1])
        is_ex = gate & (d == 0)

        # --- the first K2 gated events of each read, in discovery order,
        # into a dense (R, K2) slot table (one writer per slot)
        span = unit_total.reshape(R, per).sum(dim=1)
        rstart = torch.cumsum(span, dim=0) - span
        rend = (rstart + span).clamp(max=ncand)
        rst_c = rstart.clamp(max=ncand)
        gt = gate.to(I64)
        g_inc = torch.cumsum(gt, dim=0)
        g_exc = g_inc - gt
        g_at = torch.cat([g_exc, g_inc[-1:]])
        n_gated = g_at[rend] - g_at[rst_c]
        ex_at = torch.cat([torch.zeros(1, dtype=I64, device=dev),
                           torch.cumsum(is_ex.to(I64), dim=0)])
        total_ex = ex_at[rend] - ex_at[rst_c]
        # 49 non-exact inserts fill the 50-slot heap
        heap_would_fill = (n_gated - total_ex) > 48
        base_of = _unit_base(rst_c, g_at[rst_c], ncand)
        wslot = g_exc - base_of  # per-read gated rank
        keepw = gate & (wslot < K2)
        dest = torch.where(keepw, r_of * K2 + wslot, R * K2)
        # diffs ride the 10-bit field +512-biased (IUPAC diffs go negative)
        scd = (extras[:, 2] << 10) | ((d + 512) & 1023)
        slots = torch.full((R * K2 + 1, 4), INF32, dtype=I64, device=dev)
        slots[dest] = torch.stack([pos, scd, r_of, ar(ncand)], dim=1)
        st = slots[: R * K2].reshape(R, K2, 4)
        wocc = st[:, :, 2] < R
        wpos, wscd, wcidx = st[:, :, 0], st[:, :, 1], st[:, :, 3]

        # --- exact-match tracking (update_exact_match, abismal.cpp:347-355)
        is_exW = wocc & ((wscd & 1023) == 512)
        kidx = ar(K2)[None, :]
        j0 = torch.where(is_exW, kidx, K2).min(dim=1).values
        has_ex = j0 < K2
        j0c = j0.clamp(max=K2 - 1)[:, None]
        e_pos0 = wpos.gather(1, j0c)[:, 0]
        e_s0 = (wscd >> 10).gather(1, j0c)[:, 0]
        mism = is_exW & ((wpos != e_pos0[:, None])
                         | ((wscd >> 10) != e_s0[:, None]))
        ex_ambig = mism.any(dim=1)
        ex_over = total_ex > is_exW.sum(dim=1)
        # sure-ambig heap-fill refinement (see the JAX program, :1368-1390)
        idx_amb = torch.where(mism, wcidx, INF32).min(dim=1).values
        nonexW = wocc & ~is_exW
        is49 = nonexW & (torch.cumsum(nonexW.to(I64), dim=1) == 49)
        idx_fill = torch.where(is49, wcidx, INF32).min(dim=1).values
        heap_fb = heap_would_fill & ~(ex_ambig & (idx_amb < idx_fill))

        # --- dedup sort by (pos, flags); empty slots sort last.  One int64
        # key: pos (u32) above the 31-bit scd
        key = ((torch.where(wocc, wpos, POS_EMPTY) << 31)
               | torch.where(wocc, wscd, INF32))
        key = torch.sort(key, dim=1).values
        posK, scdK = key >> 31, key & INF32
        sK = scdK >> 10
        dK = torch.where(scdK == INF32, INF32, (scdK & 1023) - 512)
        dup = torch.zeros_like(wocc)
        dup[:, 1:] = (posK[:, 1:] == posK[:, :-1]) & (sK[:, 1:] == sK[:, :-1])
        vh = ((posK != POS_EMPTY) & ~dup & (dK < sens_gate[:, None])
              & (dK != 0))
        mark("decide")

        # --- job build and the banded scorer (K2)
        bwK = 2 * torch.minimum(dK, max_diffs_r.to(I64)[:, None]) + 1
        # bands wider than BW_MAX fall back, never clamp
        bw_over = (vh & (bwK >= 0) & (bwK > BW_MAX)).any(dim=1)
        bwK = torch.where(bwK < 0, BW_MAX, bwK.clamp(max=BW_MAX))
        rc = (sK & F_RC) != 0
        if per == 2:
            uoff = rc.to(I64)
        else:
            ar_ = (sK & F_A_RICH) != 0
            uoff = torch.where(rc, torch.where(ar_, 2, 3),
                               torch.where(ar_, 1, 0))
        qrowK = ar(R)[:, None] * per + uoff
        jm = vh.reshape(-1).to(I64)
        jexc = torch.cumsum(jm, dim=0) - jm
        job_ok = (jm != 0) & (jexc < J)
        job_fb = ((jm != 0) & (jexc >= J)).reshape(R, K2).any(dim=1)
        jrows = torch.tensor([0, 32767, 1, 0], dtype=I64, device=dev).repeat(
            J + 1, 1)
        jrows[torch.where(job_ok, jexc, J)] = torch.stack(
            [qrowK.reshape(-1), posK.reshape(-1), bwK.reshape(-1),
             rlen.repeat_interleave(K2)], dim=1)
        if J:
            junit, jpos, jbw, jqsz = jrows[:J].unbind(dim=1)
            q = unpack_nibbles(pnib[junit])[:, :lmax].to(torch.uint8)
            win = window_nibbles(genome32, win_start(jpos, jbw) & M32, WW3)
            scores_j = banded_score(q, win, jbw, jqsz)[:, 0].to(I64)
            scrK = torch.where(job_ok.reshape(R, K2),
                               scores_j[jexc.clamp(max=J - 1)].reshape(R, K2),
                               0)
        else:
            scrK = torch.zeros((R, K2), dtype=I64, device=dev)
        mark("score")

        # --- winner selection (align_se_candidates, abismal.cpp:1435-1497)
        M = torch.where(vh, scrK, 0).max(dim=1).values
        isM = vh & (scrK == M[:, None]) & (M[:, None] > 0)
        istar = torch.where(isM, kidx, K2).min(dim=1).values
        ist = istar.clamp(max=K2 - 1)[:, None]
        bpos = posK.gather(1, ist)[:, 0]
        bs = sK.gather(1, ist)[:, 0]
        bd = dK.gather(1, ist)[:, 0]
        distinct = torch.where((M == max_scr)[:, None], posK != bpos[:, None],
                               (posK - bpos[:, None]).abs() > 3)
        amb = (isM & (kidx > istar[:, None]) & distinct).any(dim=1)
        amb0 = (vh & (scrK == 0)).any(dim=1) & (M == 0)

        # --- per-read records
        ex_over_fb = ex_over & ~(has_ex & ex_ambig)
        unit_fb = overflow.reshape(R, per).any(dim=1)
        fb = (unit_fb | heap_fb | job_fb | bw_over | ex_over_fb
              | ((rlen > 0) & (rlen < DEVICE_MIN_LEN)))
        aligned = ~has_ex & (M > 0)
        status = torch.where(fb, REC_FALLBACK, torch.where(
            has_ex, 1, torch.where(aligned, 2, 0)))
        sec = torch.where(has_ex, ex_ambig, torch.where(aligned, amb, amb0))
        flags = (torch.where(has_ex, e_s0, torch.where(aligned, bs, 0))
                 | torch.where(sec, F_SECONDARY, 0))
        rec = torch.stack([
            status | (flags << 3), torch.where(has_ex, 0, bd),
            torch.where(has_ex, e_pos0, torch.where(aligned, bpos, 0)),
            torch.where(aligned, M, 0)], dim=1)
        rec = u32_to_i32(rec)
        mark("select")
        if not device_tb:
            mark("end")
            return rec

        # --- traceback of the winners: K3 with the walk fused reads each
        # winner's packed query row and genome window itself (untraced
        # lanes carry bw = 1, qsz = 0)
        do_tb = aligned & ~fb
        wunit = qrowK.gather(1, ist)[:, 0]
        wbw = torch.where(do_tb, bwK.gather(1, ist)[:, 0], 1)
        wqsz = torch.where(do_tb, rlen, 0)
        wpos2 = torch.where(do_tb, bpos, 0)
        ops, meta = banded_trace_packed(genome32, pnib, wunit, wbw, wqsz,
                                        wpos2, do_tb, lmax)
        out = torch.cat([rec, meta, ops], dim=1)
        mark("end")
        return out

    return stage12, o_spec


def build_stage12pe(lmax: int, max_candidates: int, n_index2: int,
                    n_index3: int, per: int = 4,
                    cand_per_unit: int | None = None, k_slots: int = 32,
                    jobs_per_unit: int = 8, ext_iters: int = 31,
                    ext_pool: int | None = None):
    """Fused stage-1+2 for paired-end mapping (↔ JAX build_stage12pe; the
    exactness argument is in that docstring).  Returns (stage12pe,
    o_spec); stage12pe(genome32, counter2, counter3, index_all, pnib,
    lens, is_ga, max_diffs_u, pe_dist, marks=None) -> (B, 2K + 6) i32,
    one packed row per unit [pos(K) | ds(K) | cnt | mate-slice(5)]:
      pos   candidate positions (u32 bits), discovery order;
      ds    (diffs << 16) | (score & 0xFFFF), i32 wrap;
      cnt   accepted count, or -1 => native-seeding fallback;
      mate  unit per r + u carries mate[r, 5u : 5u + 5] of the (B / per,
            O 10) per-orientation mating sweep records.
    pe_dist (2,) int = (pe_min, pe_max).  marks, a list, collects (name,
    CUDA event) pairs at the program's phase boundaries."""
    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    jobs_per_unit = int(os.environ.get("ABISMAL_TPU_JOBS_PER_UNIT",
                                       jobs_per_unit))
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, ext_iters=ext_iters,
                              ext_pool=ext_pool)
    K = k_slots
    WW3 = lmax + QOFF

    def stage12pe(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
                  max_diffs_u, pe_dist, marks=None):
        dev = pnib.device
        mark = _phase_marker(marks)
        mark("start")
        B = pnib.shape[0]
        J = ((jobs_per_unit * B + 127) // 128) * 128
        lens = lens.to(I64)
        # PE ends differ in length: every cutoff is per unit
        uextra = torch.stack([lens // 10, (2 * lens) // 5,
                              max_diffs_u.to(I64), lens], dim=1)
        c = core(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
                 uextra)
        mark("core")
        pos, b_of = c["pos"], c["b_of"]
        cell_of, valid = c["cell_of"], c["valid"]
        d = c["d"].to(I64)
        unit_start, unit_total = c["unit_start"], c["unit_total"]
        overflow, extras = c["overflow"], c["extras"]
        ncand = pos.shape[0]

        # --- acceptance gates and per-unit slot ranks, discovery order
        phase_sp = cell_of < 2 * o_spec
        gate = valid & torch.where(phase_sp, d <= extras[:, 0],
                                   d <= extras[:, 1])
        acc = gate.to(I64)
        c_inc = torch.cumsum(acc, dim=0)
        c_exc = c_inc - acc
        c_at = torch.cat([c_exc, c_inc[-1:]])
        ust_c = unit_start.clamp(max=ncand)
        uend_at = (unit_start + unit_total).clamp(max=ncand)
        base = c_at[ust_c]
        n_acc = c_at[uend_at] - base
        heap_fb = n_acc > K - 1  # insert #32 fills the heap
        base_of = _unit_base(ust_c, base, ncand)
        keep = gate & (c_exc - base_of < K - 1)
        mark("decide")

        # --- job build and the banded scorer (K2).  Bands are not
        # remapped: IUPAC diffs give negative bands, which score 0
        bw_c = 2 * torch.minimum(d, extras[:, 2]) + 1
        jm = keep.to(I64)
        k_inc = torch.cumsum(jm, dim=0)
        jexc = k_inc - jm
        job_ok = keep & (jexc < J)
        k_atx = torch.cat([torch.zeros(1, dtype=I64, device=dev), k_inc])
        job_fb = k_atx[uend_at] > torch.clamp(k_atx[ust_c], min=J)
        b_atx = torch.cat([torch.zeros(1, dtype=I64, device=dev),
                           torch.cumsum((keep & (bw_c > BW_MAX)).to(I64),
                                        dim=0)])
        bw_fb = (b_atx[uend_at] - b_atx[ust_c]) > 0
        jdest = torch.where(job_ok & (bw_c <= BW_MAX), jexc, J)
        # d rides the high half of the qsz column, as in the JAX rows
        jrows = torch.tensor([0, 32767, 1, 0], dtype=I64, device=dev).repeat(
            J + 1, 1)
        jrows[jdest] = torch.stack(
            [b_of, pos, bw_c.clamp(max=BW_MAX), (d << 16) | extras[:, 3]],
            dim=1)
        junit, jpos, jbw, jqd = jrows[:J].unbind(dim=1)
        q = unpack_nibbles(pnib[junit])[:, :lmax].to(torch.uint8)
        win = window_nibbles(genome32, win_start(jpos, jbw) & M32, WW3)
        scores_j = banded_score(q, win, jbw, jqd & 0xFFFF)[:, 0].to(I64)
        mark("score")

        # --- slot (u, k): the unit's k-th kept candidate, gathered from
        # the job rows at rank kbase + k; dead slots read INF32.  Row J
        # (a fill row, score 0) is read only when J is 0: then every
        # unit with a kept candidate has fallen back (job_fb)
        kidx = torch.arange(K, device=dev)[None, :]
        live = kidx < torch.clamp(n_acc, max=K - 1)[:, None]
        jrank = torch.clamp(k_atx[ust_c][:, None] + kidx, max=max(J - 1, 0))
        scores_j = _pad1(scores_j, 1, 0)
        scrK = torch.where(live, scores_j[jrank], 0)
        fb = (overflow | heap_fb | bw_fb | job_fb
              | ((lens > 0) & (lens < DEVICE_MIN_LEN)))
        cnt = torch.where(fb, -1, n_acc)
        posKm = torch.where(live, jrows[:, 1][jrank], INF32)
        dKm = torch.where(live, jrows[:, 3][jrank] >> 16, INF32)
        ds = (dKm << 16) | (scrK & 0xFFFF)  # wraps as i32 when packed

        # --- mating sweep (best_pair, abismal.cpp:1722-1831): per pair
        # and orientation, the local best over the K x K slot grid; the
        # stable (pos, slot) order comes from pairwise ranks
        Rp, O = B // per, per // 2
        posM = torch.where(live, posKm, POS_EMPTY)
        pi, pj = posM[:, :, None], posM[:, None, :]
        jlt = kidx < kidx.reshape(K, 1)  # [i, j]: slot j before slot i
        eqp = pi == pj
        rank = ((pj < pi) | (eqp & jlt)).sum(dim=2)
        vM = live & ~(eqp & jlt).any(dim=2)
        posP, dP, sP = (x.reshape(Rp, per, K) for x in (posM, dKm, scrK))
        vP, rP = vM.reshape(Rp, per, K), rank.reshape(Rp, per, K)
        lensP = lens.reshape(Rp, per)
        pe_dist = pe_dist.to(I64) & M32
        mins, maxs = pe_dist[0], pe_dist[1]

        def sel(a, rr, rw):
            """The element of a whose rank is rw (no match selects 0)."""
            return torch.where(rr == rw[:, None], a, 0).sum(dim=1)

        def amax(x):
            return x.amax(dim=(1, 2))

        recs = []
        for o in range(O):
            p1, d1, s1, v1, r1 = (x[:, 2 * o] for x in (posP, dP, sP, vP, rP))
            p2, d2, s2, v2, r2 = (x[:, 2 * o + 1]
                                  for x in (posP, dP, sP, vP, rP))
            # grid axes: i over end-1 slots (dim 1), j over end-2 (dim 2);
            # the window test is u32 arithmetic, as on the TPU
            limj = ((p2 + lensP[:, 2 * o + 1, None]) & M32)[:, None, :]
            p1i = p1[:, :, None]
            conc = (v1[:, :, None] & v2[:, None, :]
                    & (((p1i + mins) & M32) <= limj)
                    & (((p1i + maxs) & M32) >= limj))
            scrP = s1[:, :, None] + s2[:, None, :]
            sdP = d1[:, :, None] + d2[:, None, :]
            # traversal order: end-2 rank outer, end-1 rank inner
            ordg = r2[:, None, :] * K + r1[:, :, None]
            M = amax(torch.where(conc, scrP, -1))
            isM = conc & (scrP == M[:, None, None])
            key2 = sdP * (K * K) + ordg
            k2m = torch.where(isM, key2, 0x3FFFFFFF).amin(dim=(1, 2))
            sd_w = torch.div(k2m, K * K, rounding_mode="floor")
            ord_w = torch.remainder(k2m, K * K)
            r1_w, r2_w = ord_w % K, ord_w // K
            eq_after = (isM & (sdP == sd_w[:, None, None])
                        & (ordg > ord_w[:, None, None])).any(dim=2).any(dim=1)
            # stale end-1 score: the last computed one (first window of
            # its end-1 slot, or a zero-score recompute) up to the winner
            firstr2 = torch.where(conc, r2[:, None, :], K).amin(dim=2)
            computed = conc & ((r2[:, None, :] == firstr2[:, :, None])
                               | (s1[:, :, None] == 0))
            cmax = amax(torch.where(
                computed & (ordg <= ord_w[:, None, None]), ordg, -1))
            r1_c = cmax.clamp(min=0) % K
            # max-score ties with differing diff-sums: host replay
            maxscr = 2 * (lensP[:, 2 * o] + lensP[:, 2 * o + 1])
            fbm = (M == maxscr) & (isM & (sdP != sd_w[:, None, None])).any(
                dim=2).any(dim=1)
            recs.append(torch.stack([
                (M >= 0).to(I64), M, sel(p1, r1, r1_w), sel(p2, r2, r2_w),
                sel(d1, r1, r1_w), sel(d2, r2, r2_w), sel(s1, r1, r1_c),
                sel(s2, r2, r2_w), eq_after.to(I64), fbm.to(I64)], dim=1))
        mate = torch.cat(recs, dim=1)  # (Rp, O 10)
        out = u32_to_i32(torch.cat([posKm, ds, cnt[:, None],
                                    mate.reshape(B, 5)], dim=1))
        mark("end")
        return out

    return stage12pe, o_spec


class TorchNativeEngine:
    """The JAX TpuNativeEngine's fused device path on a torch device: the
    stage-1+2 programs (build_stage12 for single-end, build_stage12pe for
    paired-end) run on the device and their packed rows go to the native
    engine's finalize, which formats the SAM and re-maps the fallback
    reads exactly.  Implements the dispatch/finish pipeline interface of
    run_map_pipelined.

    mesh_devices (an int, "all" or a list of devices: parallel.mesh.
    make_mesh) splits every chunk over the mesh's slots, each with its
    replica of the tables, in place of the one device; unit_batch must
    divide by the mesh size.  With a mesh, device_decisions adds up the
    SE decision counts [unmapped, exact, aligned, fallback] of every
    read, and no phase marks are kept."""

    supports_pipeline = True
    pipeline_depth = 2  # batches in flight ahead of the native finish

    def __init__(self, index, allow_ambig=False, valid_frac=0.1,
                 pe_min_dist=32, pe_max_dist=3000, lmax: int = 128,
                 unit_batch: int = 2048, n_threads: int = 1,
                 device="cuda", mesh_devices=None, index_shards=None):
        if index_shards:
            raise NotImplementedError(
                "index_shards: the key-range-sharded index is not ported "
                "yet (ROADMAP.md item 8)")
        if index.genome_size > POS_EMPTY - 1:
            # positions are u32 and POS_EMPTY marks a dead PE slot
            raise ValueError(f"genome of {index.genome_size} bases exceeds "
                             f"the device path's {POS_EMPTY - 1}")
        self.mesh = None
        self.n_shards = 1
        if mesh_devices:
            self.mesh = make_mesh(mesh_devices)
            self.n_shards = len(self.mesh)
            if unit_batch % self.n_shards:
                raise ValueError("unit_batch must divide by mesh size")
            self.device = self.mesh[0]
        else:
            self.device = resolve_device(device)
        self.native = NativeMappingEngine(index, allow_ambig, valid_frac,
                                          pe_min_dist, pe_max_dist,
                                          n_threads=n_threads)
        self.lmax = lmax
        self.valid_frac = valid_frac
        self.unit_batch = unit_batch
        self.device_tb = os.environ.get("ABISMAL_TPU_DEVTB", "1") == "1"
        if self.mesh is None:
            self.dev = DeviceIndex.from_index(index, self.device)
        else:
            self.replicas = replicate_tables(index, self.mesh)
            self.dev = self.replicas[0]
        self.device_decisions = np.zeros(4, dtype=np.int64)
        self._host_counters = (index.counter, index.counter_t,
                               index.counter_a)
        self.cand_budget = None
        self._ext_mean = None
        self._stage12_progs = {}
        self.n_fallback = 0
        self.n_units = 0
        self.stage_time = {"device dispatch": 0.0, "device collect": 0.0,
                           "native stage-2": 0.0}
        # per-chunk phase marks (CUDA events) when profile is on
        self.profile = False
        self.chunk_marks = []

    def preferred_read_batch(self, paired, random_pbat):
        per = ((8 if random_pbat else 4) if paired
               else (4 if random_pbat else 2))
        return max(250, self.unit_batch // per)

    @property
    def n_threads(self):
        return self.native.n_threads

    @n_threads.setter
    def n_threads(self, v):
        self.native.n_threads = max(1, v)

    def _budget_for(self, units, is_ga_pat, per):
        """Workload-informed candidate budget, measured once on the first
        batch's units (estimate_cand_budget); units is the (pnib, lens_u)
        pair of _se_units_mat."""
        if self.cand_budget is None:
            pnib, lens_u = units
            unp = np.empty((pnib.shape[0], 2 * pnib.shape[1]), np.uint8)
            unp[:, 0::2] = pnib & np.uint8(0xF)
            unp[:, 1::2] = pnib >> np.uint8(4)
            ulist = [unp[i, : lens_u[i]] for i in range(pnib.shape[0])]
            is_ga = [bool(is_ga_pat[i % per]) for i in range(len(ulist))]
            self.cand_budget, self._ext_mean = estimate_cand_budget(
                self._host_counters, self.dev.max_candidates, ulist, is_ga,
                self.lmax)
        return self.cand_budget

    def _informed_ext_pool(self):
        """Extension-pool size from the measured oversized-bucket rate
        (mean + 8 sigma of chunk demand, 2x floor); None = static default."""
        if self._ext_mean is None:
            return None
        d = self._ext_mean * self.unit_batch
        want = max(d + 8.0 * d ** 0.5, 2.0 * d)
        return int(np.clip((int(want) + 127) & ~63, 128, 4096))

    def _stage12_prog(self, per, cand_budget=None):
        ext_pool = self._informed_ext_pool()
        key = (per, cand_budget, ext_pool)
        prog = self._stage12_progs.get(key)
        if prog is None:
            prog, _ = build_stage12(
                self.lmax, self.dev.max_candidates, self.dev.n_index2,
                self.dev.n_index3, per, cand_per_unit=cand_budget,
                ext_iters=self.dev.ext_iters, device_tb=self.device_tb,
                ext_pool=ext_pool)
            if self.mesh is not None:
                prog = shard_stage12(prog, self.mesh)
            self._stage12_progs[key] = prog
        return prog

    def _se_units_mat(self, reads, a_rich_mode, random_pbat):
        """(pnib, lens_u, per, oversized): every read's `per` encoded units
        as packed nibble rows, in whole-batch NumPy (↔ JAX _se_units_mat);
        oversized reads upload zero-length rows and fall back."""
        per = 4 if random_pbat else 2
        R = len(reads)
        seqs = [s for _, s in reads]
        oversized = np.fromiter(
            (bool(s) and len(s) > self.lmax for s in seqs), dtype=bool,
            count=R)
        if oversized.any():
            seqs = [b"" if o else s for s, o in zip(seqs, oversized)]
        A, Arc, L = _ascii_matrices(seqs, self.lmax)
        U = np.zeros((per * max(R, 1), self.lmax + 32), np.uint8)
        if not random_pbat:
            ef, er = ((ENCODE_A_RICH, ENCODE_T_RICH) if a_rich_mode
                      else (ENCODE_T_RICH, ENCODE_A_RICH))
            U[0::2, : self.lmax] = ef[A]
            U[1::2, : self.lmax] = er[Arc]
        else:
            U[0::4, : self.lmax] = ENCODE_T_RICH[A]
            U[1::4, : self.lmax] = ENCODE_A_RICH[A]
            U[2::4, : self.lmax] = ENCODE_T_RICH[Arc]
            U[3::4, : self.lmax] = ENCODE_A_RICH[Arc]
        pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
        lens_u = np.repeat(L, per).astype(np.int32)
        return pnib, lens_u, per, oversized

    def _put(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def dispatch_se(self, reads, a_rich_mode, random_pbat):
        """Enqueues the device program for every chunk of the batch."""
        t0 = time.perf_counter()
        pnib_all, lens_all, per, oversized = self._se_units_mat(
            reads, a_rich_mode, random_pbat)
        scode_pat = _se_scode_pattern(a_rich_mode,
                                                      random_pbat)
        is_ga_pat = np.array([get_conv_is_ga(int(c)) for c in scode_pat],
                             dtype=bool)
        prog = self._stage12_prog(
            per, self._budget_for((pnib_all, lens_all), is_ga_pat, per))
        q = per * self.n_shards  # batch quantum (units/read x mesh slots)
        B = max(q, self.unit_batch - (self.unit_batch % q))
        rpc = B // per  # reads per chunk
        if self.mesh is None:
            scode, tables = self._put(scode_pat), self.dev.tables()
        pending = []
        for start in range(0, len(reads), rpc):
            n = min(rpc, len(reads) - start)
            nu = n * per
            preads = pnib_all[start * per : start * per + nu]
            lens = lens_all[start * per : start * per + nu]
            if B - nu:
                preads = np.pad(preads, ((0, B - nu), (0, 0)))
                lens = np.pad(lens, (0, B - nu))
            lens_r = lens.reshape(rpc, per).max(axis=1)
            # int(valid_frac * len), truncated like the C cast
            max_diffs_r = (self.valid_frac
                           * lens_r.astype(np.float64)).astype(np.int32)
            is_ga = np.tile(is_ga_pat, rpc)
            counts = None
            if self.mesh is not None:
                rows, counts = prog(self.replicas, preads, lens, is_ga,
                                    scode_pat, max_diffs_r)
            else:
                marks = [] if self.profile else None
                rows = prog(*tables, self._put(preads), self._put(lens),
                            self._put(is_ga), scode, self._put(max_diffs_r),
                            marks=marks)
                if marks is not None:
                    self.chunk_marks.append(marks)
            pending.append((start, n, rows, counts))
        self.stage_time["device dispatch"] += time.perf_counter() - t0
        return (reads, a_rich_mode, random_pbat, per, pending, oversized)

    def finish_se(self, handle, stats, out):
        """Collects the chunks' packed rows (one copy each) and hands them
        to the native finalize."""
        reads, arm, rp, per, pending, oversized = handle
        t1 = time.perf_counter()
        R = len(reads)
        W = 8 + TB_NOPS if self.device_tb else 4
        packed = np.zeros((max(R, 1), W), dtype=np.int32)
        if self.device_tb:
            packed[:, 4] = -1  # n_ops sentinel for rows without a chunk
        for start, n, rows, counts in pending:
            packed[start : start + n] = rows.cpu().numpy()[:n]
            if counts is not None:
                # padded reads are unmapped (status 0): take them out
                c = counts.numpy().astype(np.int64)
                c[0] -= rows.shape[0] - n
                self.device_decisions += c
        records = packed[:, :4]
        cig_ops = cig_meta = None
        if self.device_tb:
            cig_meta = np.ascontiguousarray(packed[:, 4:8])
            cig_ops = np.ascontiguousarray(packed[:, 8:])
        idx = np.flatnonzero(oversized)
        if idx.size:
            records[idx] = np.array([REC_FALLBACK, 0, 0, 0], dtype=np.int32)
        n_fb = int(((records[:R, 0] & 7) == REC_FALLBACK).sum())
        self.n_units += R * per
        self.n_fallback += n_fb * per
        t2 = time.perf_counter()
        self.stage_time["device collect"] += t2 - t1
        self.native._finalize_se(
            reads, arm, rp, records[:R], stats, out,
            cig_ops=None if cig_ops is None else cig_ops[:R],
            cig_meta=None if cig_meta is None else cig_meta[:R])
        self.stage_time["native stage-2"] += time.perf_counter() - t2
        return R

    def map_se_reads(self, reads, a_rich_mode, random_pbat, stats, out):
        self.finish_se(self.dispatch_se(reads, a_rich_mode, random_pbat),
                       stats, out)

    def _stage12pe_prog(self, per, cand_budget=None):
        ext_pool = self._informed_ext_pool()
        key = ("pe", per, cand_budget, ext_pool)
        prog = self._stage12_progs.get(key)
        if prog is None:
            prog, _ = build_stage12pe(
                self.lmax, self.dev.max_candidates, self.dev.n_index2,
                self.dev.n_index3, per=per, cand_per_unit=cand_budget,
                ext_iters=self.dev.ext_iters, ext_pool=ext_pool)
            if self.mesh is not None:
                prog = shard_stage12pe(prog, self.mesh)
            self._stage12_progs[key] = prog
        return prog

    def _pe_units_mat(self, reads1, reads2, a_rich_mode, random_pbat):
        """(pnib, lens_u, per, oversized): every pair's `per` encoded units
        in the JAX _pe_units_flat row order, whole-batch NumPy (↔ JAX
        _pe_units_mat); pairs with an oversized end upload zero-length
        rows and fall back."""
        per = 8 if random_pbat else 4
        R = len(reads1)
        s1 = [s for _, s in reads1]
        s2 = [s for _, s in reads2]
        oversized = np.fromiter(
            ((bool(a) and len(a) > self.lmax)
             or (bool(b) and len(b) > self.lmax)
             for a, b in zip(s1, s2)), dtype=bool, count=R)
        if oversized.any():
            s1 = [b"" if o else s for s, o in zip(s1, oversized)]
            s2 = [b"" if o else s for s, o in zip(s2, oversized)]
        A1, Arc1, L1 = _ascii_matrices(s1, self.lmax)
        A2, Arc2, L2 = _ascii_matrices(s2, self.lmax)
        U = np.zeros((per * max(R, 1), self.lmax + 32), np.uint8)
        lens_u = np.zeros(per * max(R, 1), np.int32)
        convs = [a_rich_mode] if not random_pbat else [False, True]
        for ci, conv in enumerate(convs):
            e1, e2 = ((ENCODE_A_RICH, ENCODE_T_RICH) if conv
                      else (ENCODE_T_RICH, ENCODE_A_RICH))
            o = 4 * ci
            for u, (enc, A, L) in enumerate(((e1, A1, L1), (e1, Arc2, L2),
                                             (e2, A2, L2), (e2, Arc1, L1))):
                U[o + u :: per, : self.lmax] = enc[A]
                lens_u[o + u :: per] = L
        pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
        return pnib, lens_u, per, oversized

    @property
    def n_device_mated(self):
        """Orientations decided by the device mating sweep."""
        return self.native.n_device_mated

    def dispatch_pe(self, reads1, reads2, a_rich_mode, random_pbat):
        """Enqueues the PE device program for every chunk of the batch."""
        t0 = time.perf_counter()
        pnib_all, lens_all, per, oversized = self._pe_units_mat(
            reads1, reads2, a_rich_mode, random_pbat)
        is_ga_pat = _pe_is_ga_pattern(a_rich_mode,
                                                      random_pbat)
        prog = self._stage12pe_prog(
            per, self._budget_for((pnib_all, lens_all), is_ga_pat, per))
        q = per * self.n_shards
        B = max(q, self.unit_batch - (self.unit_batch % q))
        ppc = B // per  # pairs per chunk
        pe_dist = np.array([self.native.pe_min_dist,
                            self.native.pe_max_dist], np.int32)
        is_ga = np.tile(is_ga_pat, ppc)
        if self.mesh is None:
            pe_dist_d, is_ga_d = self._put(pe_dist), self._put(is_ga)
            tables = self.dev.tables()
        pending = []
        for start in range(0, len(reads1), ppc):
            nu = min(ppc, len(reads1) - start) * per
            preads = pnib_all[start * per : start * per + nu]
            lens = lens_all[start * per : start * per + nu]
            if B - nu:
                preads = np.pad(preads, ((0, B - nu), (0, 0)))
                lens = np.pad(lens, (0, B - nu))
            # int(valid_frac * len) per unit (the ends differ in length)
            max_diffs_u = (self.valid_frac
                           * lens.astype(np.float64)).astype(np.int32)
            if self.mesh is not None:
                rows, _ = prog(self.replicas, preads, lens, is_ga,
                               max_diffs_u, pe_dist)
            else:
                marks = [] if self.profile else None
                rows = prog(*tables, self._put(preads), self._put(lens),
                            is_ga_d, self._put(max_diffs_u), pe_dist_d,
                            marks=marks)
                if marks is not None:
                    self.chunk_marks.append(marks)
            pending.append((start, nu, rows))
        self.stage_time["device dispatch"] += time.perf_counter() - t0
        return (reads1, reads2, a_rich_mode, random_pbat, per, pending,
                oversized)

    def finish_pe(self, handle, stats, out):
        """Collects the chunks' packed slot rows (one copy each) and hands
        them to the native PE finalize."""
        reads1, reads2, arm, rp, per, pending, oversized = handle
        t1 = time.perf_counter()
        n_pairs = len(reads1)
        n_units = per * n_pairs
        K = 32
        packed = np.zeros((max(n_units, 1), 2 * K + 6), dtype=np.int32)
        packed[:, 2 * K] = -1  # cnt sentinel for rows without a chunk
        for start, nu, rows in pending:
            packed[start * per : start * per + nu] = rows.cpu().numpy()[:nu]
        pos_all = np.ascontiguousarray(packed[:n_units, :K]).view(np.uint32)
        ds_all = np.ascontiguousarray(packed[:n_units, K : 2 * K])
        cnt_all = np.ascontiguousarray(packed[:n_units, 2 * K])
        mate_all = np.ascontiguousarray(
            packed[:n_units, 2 * K + 1 :].reshape(n_pairs, 5 * per))
        cnt_all.reshape(n_pairs, per)[oversized] = -1
        self.n_units += n_units
        self.n_fallback += int((cnt_all < 0).sum())
        t2 = time.perf_counter()
        self.stage_time["device collect"] += t2 - t1
        self.native._call_pe_slots(reads1, reads2, arm, rp, stats, out,
                                   pos_all, ds_all, cnt_all, mate_all)
        self.stage_time["native stage-2"] += time.perf_counter() - t2
        return n_pairs

    def map_pe_reads(self, reads1, reads2, a_rich_mode, random_pbat, stats,
                     out):
        self.finish_pe(self.dispatch_pe(reads1, reads2, a_rich_mode,
                                        random_pbat), stats, out)


_engine_memo = {}


def make_torch_native_engine_factory(device, lmax: int = 128,
                                     unit_batch: int = 2048,
                                     n_threads: int = 1, mesh_devices=None):
    """run_map engine factory for TorchNativeEngine on `device`, or over
    the mesh mesh_devices, memoized per index (the device tables are ~1 GB
    at any genome size)."""
    mesh_key = (tuple(str(d) for d in mesh_devices)
                if isinstance(mesh_devices, (list, tuple)) else mesh_devices)

    def factory(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
        key = ("torch-native", id(index), int(index.max_candidates),
               allow_ambig, valid_frac, pe_min_dist, pe_max_dist, lmax,
               unit_batch, str(device), mesh_key)
        hit = _engine_memo.get(key)
        if hit is not None and hit[0] is index:
            hit[1].n_threads = n_threads
            return hit[1]
        eng = TorchNativeEngine(index, allow_ambig, valid_frac, pe_min_dist,
                                pe_max_dist, lmax=lmax, unit_batch=unit_batch,
                                n_threads=n_threads, device=device,
                                mesh_devices=mesh_devices)
        _engine_memo[key] = (index, eng)
        return eng

    factory.is_native = True
    return factory
