"""PyTorch port of the device pipeline of abismal_tpu/map/pipeline.py: the
candidate core (_make_core), the event-stream program (build_stage1), the
fused stage-1+2 programs with on-device traceback (build_stage12; JAX's
build_tb_block is the kernel wrapper kernels.banded_align.banded_trace)
and build_stage12pe, the key-range-sharded index (DeviceIndexTP), the
engine half that feeds the native engine (TorchNativeEngine) and its
factory, and the replay engines (TorchMappingEngine, EventReplayEngine:
the exact engine of map/engine.py seeded from build_stage1's events).
Names follow the JAX module so each counterpart is easy to find.

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
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..constants import (
    KEY_WEIGHT, KEY_WEIGHT_THREE, MIN_FOLD_SIZE, N_SORTING_POSITIONS,
    WINDOW_SIZE,
)
from ..device import put, resolve_device
from ..graphs import use_graphs
from ..kernels.banded_align import (
    BW_MAX, QOFF, banded_score_packed, banded_trace_packed, unpack_nibbles,
    win_start, window_nibbles,
)
from ..kernels.popcount_compare import M32, genome_words, popcount32
from ..kernels.popcount_compare import popcount_compare
from ..parallel.mesh import (
    make_mesh, replicate_tables, shard_stage1, shard_stage1_tp, shard_stage12,
    shard_stage12pe,
)
from ..utils.dna import ENCODE_A_RICH, ENCODE_T_RICH, revcomp_str
from .engine import MappingEngine
from .host_units import (
    DEVICE_MIN_LEN, HASH3_MOD, REC_FALLBACK, SLOT, TB_NOPS, _ascii_matrices,
    _merge_tp_streams, _pe_is_ga_pattern, _resolve_cand_budget,
    _se_scode_pattern, _tp_key_bounds, estimate_cand_budget, ext_iters_for,
    get_conv_is_ga, o_spec_for, pack_genome_u32, prepare_units, strand_code,
)
from .native_engine import NativeMappingEngine
from .seeds import pack_read, prep_read, process_seeds

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
        return cls(*(put(a, dev) for a in (g32.view(np.int32), c2, c3, idx)),
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


class DeviceIndexTP:
    """Key-range-sharded index tables (↔ the JAX DeviceIndexTP): each shard
    owns a contiguous key range of each of the three tables, the bounds
    chosen so position counts balance.  Host arrays:
      index_local (n_shards, P2 + 2 P3) int64  each shard's position lists
          [two | C->T | G->A] at offsets 0, P2 and P2 + P3, zero-padded;
      shardinfo (n_shards, 9) int64  each shard's key bounds [k2lo, k2hi,
          k3tlo, k3thi, k3alo, k3ahi] and list bases [pb2, pb3t, pb3a],
          exact (JAX stores the bases modulo 2^32: the same i32 bits).
    slots[s] holds slot s's device tensors (genome32, counter2, counter3,
    index_local[s], shardinfo[s]): the genome and counter tables are
    uploaded once per distinct device and shared by its slots, the lists
    and the shard row once per slot."""

    def __init__(self, index, devices):
        n = len(devices)
        self.n_shards = n
        self.ext_iters = ext_iters_for(index)
        self.max_candidates = int(index.max_candidates)
        counters = (index.counter, index.counter_t, index.counter_a)
        lists = (index.index, index.index_t, index.index_a)
        bounds = [_tp_key_bounds(c, n) for c in counters]
        bases = [c.astype(np.int64)[b] for c, b in zip(counters, bounds)]
        self.P2 = max(1, int(np.diff(bases[0]).max()))
        self.P3 = max(1, int(max(np.diff(bases[1]).max(),
                                 np.diff(bases[2]).max())))
        offs = (0, self.P2, self.P2 + self.P3)
        self.index_local = np.zeros((n, self.P2 + 2 * self.P3), np.int64)
        for s in range(n):
            for lst, b, off in zip(lists, bases, offs):
                part = lst[b[s] : b[s + 1]]
                self.index_local[s, off : off + part.shape[0]] = part
        self.shardinfo = np.stack(
            [bounds[0][:-1], bounds[0][1:], bounds[1][:-1], bounds[1][1:],
             bounds[2][:-1], bounds[2][1:], bases[0][:-1], bases[1][:-1],
             bases[2][:-1]], axis=1)
        host = (pack_genome_u32(index.genome_words).view(np.int32),
                index.counter.astype(np.int64),
                np.concatenate(counters[1:]).astype(np.int64))
        shared = {}
        self.slots = []
        for s, dev in enumerate(devices):
            if dev not in shared:
                shared[dev] = tuple(put(a, dev) for a in host)
            self.slots.append(shared[dev] + (
                put(self.index_local[s], dev), put(self.shardinfo[s], dev)))

    def nbytes(self) -> int:
        """Bytes of the device tensors, each distinct tensor once."""
        seen = {id(t): t for slot in self.slots for t in slot}
        return sum(t.numel() * t.element_size() for t in seen.values())


def _cut_sums(*xs) -> torch.Tensor:
    """(len(xs),) i32: the sum of each tensor, wrapped to 32 bits as the JAX
    programs' i32 sums wrap (u32 values count by their i32 bits)."""
    return u32_to_i32(torch.stack([x.to(I64).sum() for x in xs]))


# the profiling and diagnostic cuts of the candidate core (↔ JAX CORE_CUTS)
# that the fused programs forward to it; "extdbg" is the core's alone
CORE_CUTS = ("hash", "ranges", "extend", "list", "unitstats")
SE_CUTS = CORE_CUTS + ("core", "compact", "decide", "jobs", "score",
                       "fbstats")
PE_CUTS = CORE_CUTS + ("pegate", "pescan", "pecompact", "pejobs", "pescore",
                       "pesort", "pegrid")


def _check_cut(cut, allowed):
    if cut is not None and cut not in allowed:
        raise ValueError(f"unknown cut {cut!r}; one of {allowed}")


def _make_core(lmax: int, max_candidates: int, n_index2: int, n_index3: int,
               cand_per_unit: int, ext_iters: int = 31,
               ext_pool: int | None = None, tp: bool = False,
               cut: str | None = None):
    """Candidate core (↔ JAX _make_core): rolling hashes, bucket ranges,
    pooled k-ary seed extension, check gates, the global candidate list
    and the K1 compare.  Returns (core, o_spec); core(genome32, counter2,
    counter3, index_all, pnib, lens, is_ga, uextra, shard=None) -> dict of
    per-candidate (pos, d, b_of, cell_of, slot, valid, extras) and per-unit
    (unit_start, unit_total, overflow) tensors.

    cut (profiling and diagnostics, as in JAX; None for the whole core)
    ends the core early with dict(cut=...) of JAX's values, i32: "hash",
    "ranges", "extend" and "list" the sums of the stage's outputs (packed
    read words, hashes and word masks; the specific bucket ranges; the
    extended ranges; positions, units, slots and unit totals),
    "unitstats" the (2, B) candidates and overflow flag of each unit;
    "extdbg" returns the per-cell extension arrays (l2, s2x, e2x, l3,
    s3x, e3x, ext_fb, s2, e2, s3, e3) instead.  ABISMAL_TPU_NOEXT, read
    here, skips the seed extension (profiling only: it changes the
    output).

    With tp (the key-range-sharded index, DeviceIndexTP), index_all is
    one shard's local lists [two | C->T | G->A] at offsets 0, n_index2 and
    n_index2 + n_index3 (the engine passes P2 and P3), and shard its
    shardinfo row: cells whose key lies outside the shard's ranges are
    masked off, and the list offsets of the others are rebased onto the
    local lists.  Bucket sizes stay the global ones (the fold rule of the
    sensitive phase compares the two tables, and a shard may own one
    bucket of a cell and not the other), so the union of the shards'
    candidates, in rank order, is the unsharded core's."""
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
    noext = bool(os.environ.get("ABISMAL_TPU_NOEXT"))
    _check_cut(cut, CORE_CUTS + ("extdbg",))

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

    def extension(genome32, index_all, ip, lens, is_ga, base3, act2_sp,
                  act3_sp, s2, e2, s3, e3, EXT_POOL):
        """The pooled seed extension, LCP-window method (see the JAX core,
        pipeline.py:513-806): active lanes (bucket > max_candidates)
        compact into EXT_POOL slots, a k-ary lower/upper-bound search
        finds the class-string match range, and the stop depth falls out
        of the window LCPs around it.  Returns the extended cells (l2,
        s2x, e2x, l3, s3x, e3x) and ext_fb, the units whose lanes spilled
        from the pool or reach past the sort depth."""
        dev = ip.device
        B, stride = ip.shape
        n_idx = index_all.shape[0]

        def ar(n):
            return torch.arange(n, device=dev)

        n_lanes = B * o_spec
        flat_act = torch.cat([(act2_sp & ((e2 - s2) > mc)).reshape(-1),
                              (act3_sp & ((e3 - s3) > mc)).reshape(-1)])
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

        return l2, s2x, e2x, l3, s3x, e3x, ext_fb

    def core(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
             uextra, shard=None):
        dev = pnib.device
        B = pnib.shape[0]
        EXT_POOL = int(os.environ.get(
            "ABISMAL_TPU_EXT_POOL",
            max(512, B // 4) if ext_pool is None else ext_pool))
        gflat = B * cand_per_unit
        lens = lens.to(I64)
        is_ga = is_ga.to(torch.bool)

        def ar(n):
            return torch.arange(n, device=dev)

        ip = unpack_nibbles(pnib)  # (B, stride)

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
        if cut == "hash":  # + read words and rolling hashes
            wmask = ar(n_words)[None, :] < (2 * ((lens + 15) // 16))[:, None]
            return dict(cut=_cut_sums(packed, k2_all, k3_all, wmask))

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
        if tp:
            # the shard's key bounds and list bases (each unit reads the
            # three-letter table of its conversion)
            k2lo, k2hi, pb2 = shard[0], shard[1], shard[6]
            lo3u = torch.where(is_ga, shard[4], shard[2])[:, None]
            hi3u = torch.where(is_ga, shard[5], shard[3])[:, None]
            pb3u = torch.where(is_ga, shard[8], shard[7])[:, None]

            def owned(act, keys, lo, hi):
                return act & (keys >= lo) & (keys < hi)

            act2_sp = owned(act_sp, k2_all[:, :o_spec], k2lo, k2hi)
            act3_sp = owned(act_sp, k3_all[:, :o_spec], lo3u, hi3u)
        else:
            act2_sp = act3_sp = act_sp
        # the gather is not masked by ownership: sizes are global
        gmask = act_sn.clone()
        gmask[:, :o_spec] |= act_sp
        k2n = torch.where(gmask, k2_all, 0)
        k3n = torch.where(gmask, k3_all, 0) + c3_base[:, None]
        p2s, p2e = counter2[k2n], counter2[k2n + 1]
        p3s, p3e = counter3[k3n], counter3[k3n + 1]
        if tp:  # rebased onto the shard's local lists
            p2s_sp, p2e_sp = p2s[:, :o_spec] - pb2, p2e[:, :o_spec] - pb2
            p3s_sp, p3e_sp = p3s[:, :o_spec] - pb3u, p3e[:, :o_spec] - pb3u
        else:
            p2s_sp, p2e_sp = p2s[:, :o_spec], p2e[:, :o_spec]
            p3s_sp, p3e_sp = p3s[:, :o_spec], p3e[:, :o_spec]
        s2 = torch.where(act2_sp, p2s_sp, 0)
        e2 = torch.where(act2_sp, p2e_sp, 0)
        s3 = torch.where(act3_sp, p3s_sp, 0)
        e3 = torch.where(act3_sp, p3e_sp, 0)
        if cut == "ranges":  # + the specific phase's bucket ranges
            return dict(cut=_cut_sums(s2, e2, s3, e3))

        if noext:
            # ABISMAL_TPU_NOEXT, profiling only (as in JAX): no extension,
            # which changes the output; no mapping path sets it
            l2, s2x, e2x = torch.full_like(s2, KEY_WEIGHT), s2, e2
            l3, s3x, e3x = torch.full_like(s3, KEY_WEIGHT_THREE), s3, e3
            ext_fb = torch.zeros(B, dtype=torch.bool, device=dev)
        else:
            l2, s2x, e2x, l3, s3x, e3x, ext_fb = extension(
                genome32, index_all, ip, lens, is_ga, base3, act2_sp,
                act3_sp, s2, e2, s3, e3, EXT_POOL)
        if cut == "extend":  # + the seed extension
            return dict(cut=_cut_sums(l2, s2x, l3, e3x))
        if cut == "extdbg":  # the extension's per-cell arrays
            out = dict(l2=l2, s2x=s2x, e2x=e2x, l3=l3, s3x=s3x, e3x=e3x,
                       ext_fb=ext_fb, s2=s2, e2=e2, s3=s3, e3=e3)
            return {k: v if v.dtype == torch.bool else u32_to_i32(v)
                    for k, v in out.items()}
        # --- check gates and the two- vs three-letter fold rule
        d2, d3 = e2x - s2x, e3x - s3x
        check2_sp = act2_sp & ((d2 <= mc) | (l2 >= specific_len[:, None]))
        check3_sp = act3_sp & ((d3 <= mc) | (l3 >= specific_len[:, None]))
        s2n = torch.where(act_sn, p2s, 0)
        d2n = torch.where(act_sn, p2e, 0) - s2n
        s3n = torch.where(act_sn, p3s, 0)
        d3n = torch.where(act_sn, p3e, 0) - s3n
        if tp:  # sizes global; the offsets owned and rebased
            act2_sn = owned(act_sn, k2_all, k2lo, k2hi)
            act3_sn = owned(act_sn, k3_all, lo3u, hi3u)
            s2n = torch.where(act2_sn, s2n - pb2, 0)
            s3n = torch.where(act3_sn, s3n - pb3u, 0)
        else:
            act2_sn = act3_sn = act_sn
        check2_sn = act2_sn & (d2n != 0) & (d2n <= mc) & (
            (d3n == 0) | (d2n <= MIN_FOLD_SIZE * d3n))
        check3_sn = act3_sn & (d3n != 0) & (d3n <= mc)

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
        if cut == "list":  # + the global candidate list
            return dict(cut=_cut_sums(pos, b_of, slot, unit_total))
        if cut == "unitstats":  # each unit's candidates and overflow flag
            return dict(cut=u32_to_i32(torch.stack([unit_total,
                                                    overflow.to(I64)])))

        # --- K1 popcount compare over the genome windows
        d = popcount_compare(genome32, pos, u32_to_i32(packed), b_of,
                             nw_unit[b_of])
        return dict(pos=pos, d=d, b_of=b_of, cell_of=cell_of, slot=slot,
                    valid=valid, extras=extras, unit_start=unit_start,
                    unit_total=unit_total, overflow=overflow)

    return core, o_spec


_stage1_memo = {}


def build_stage1(lmax: int, max_candidates: int, n_index2: int,
                 n_index3: int, cand_per_unit: int | None = None,
                 gcap_per_unit: int | None = None, ext_iters: int = 31,
                 ext_pool: int | None = None, tp: bool = False):
    """Stage 1 of the event-stream route (↔ JAX build_stage1): the
    candidate core plus the compaction of accepted events (diffs <= thr,
    the unit's largest cutoff 0.4 len) into one dense stream that the
    native engine replays.  Returns (stage1, o_spec); stage1(genome32,
    counter2, counter3, index_all, pnib, lens, is_ga, thr, shard=None) ->
    (ev, cf), with tp one shard's stream (index_all and shard that shard's
    index_local and shardinfo rows of DeviceIndexTP; n_index2 and n_index3
    its P2 and P3):
      ev  (2, gcap) i32 of u32 bits: row 0 the positions, row 1 (diffs +
          512) << 22 | rank (rank = cell * SLOT + slot), units in order and
          each unit's events in discovery order; gcap = B * gcap_per_unit
          (ABISMAL_TPU_GCAP_PER_UNIT, default 32), events past it dropped;
      cf  (B,) i32: accepted count | overflow << 30 (overflow: the unit
          goes to the native seeding).
    Sync-free, like build_stage12.  Memoized per parameter tuple."""
    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    gcap_per_unit = int(os.environ.get(
        "ABISMAL_TPU_GCAP_PER_UNIT",
        32 if gcap_per_unit is None else gcap_per_unit))
    # the NOEXT variant is another program: never under the product's key
    key = (lmax, max_candidates, n_index2, n_index3, cand_per_unit,
           gcap_per_unit, ext_iters, ext_pool, tp,
           bool(os.environ.get("ABISMAL_TPU_NOEXT")))
    if key in _stage1_memo:
        return _stage1_memo[key]
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, ext_iters=ext_iters,
                              ext_pool=ext_pool, tp=tp)

    def stage1(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
               thr, shard=None):
        dev = pnib.device
        B = pnib.shape[0]
        gcap = B * gcap_per_unit
        gflat = B * cand_per_unit
        lens, thr = lens.to(I64), thr.to(I64)
        c = core(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
                 thr[:, None], shard)
        d = c["d"].to(I64)
        accept = c["valid"] & (d <= c["extras"][:, 0])

        # --- compact accepted events into the stream (one cumsum)
        acc = accept.to(I64)
        acc_inc = torch.cumsum(acc, dim=0)
        gdest = acc_inc - acc
        ok = accept & (gdest < gcap)
        # diffs +512-biased into a 10-bit field (IUPAC codes drive them
        # below zero), rank in the low 22 bits
        meta = ((d + 512) << 22) | (c["cell_of"] * SLOT + c["slot"])
        gev = torch.zeros((gcap + 1, 2), dtype=I64, device=dev)
        gev[torch.where(ok, gdest, gcap)] = torch.stack(
            [c["pos"], torch.where(ok, meta, 0)], dim=1)

        # --- per-unit counts from the accept prefix sums; a unit dropped
        # events iff its accepted span crosses gcap
        acc_at = torch.cat([torch.zeros(1, dtype=I64, device=dev), acc_inc])
        ustart = c["unit_start"].clamp(max=gflat)
        uend = (c["unit_start"] + c["unit_total"]).clamp(max=gflat)
        count = acc_at[uend] - acc_at[ustart]
        dropped = acc_at[uend] > torch.clamp(acc_at[ustart], min=gcap)
        # reads under DEVICE_MIN_LEN and those whose length or cutoff
        # leaves the 10-bit diffs field go to the native seeding
        overflow = (c["overflow"] | dropped
                    | ((lens > 0) & (lens < DEVICE_MIN_LEN))
                    | (thr > 511) | (lens > 512))
        ev = u32_to_i32(gev[:gcap].T).contiguous()
        cf = (count | (overflow.to(I64) << 30)).to(torch.int32)
        return ev, cf

    _stage1_memo[key] = (stage1, o_spec)
    return stage1, o_spec


def _fill_job_rows(n: int, dev) -> torch.Tensor:
    """(4, n) int64 job rows (unit, pos, bw, qsz) of fill jobs, which score
    0: unit 0, pos 32767, bw 1, qsz 0; made on the device, with no copy
    from the host (a captured program may not make one)."""
    return torch.stack([torch.full((n,), v, dtype=I64, device=dev)
                        for v in (0, 32767, 1, 0)])


def _job_operand_sums(genome32, pnib, junit, jpos, jbw, jqsz, lmax):
    """The "jobs" cuts' sums of the J job rows (unit, pos, bw, qsz): every
    query nibble of the job's unit row, the lmax + QOFF genome nibbles of
    its window, bw and qsz (JAX builds these operands for its scorer; K2
    reads them itself from the packed rows and genome)."""
    q = unpack_nibbles(pnib[junit])
    win = window_nibbles(genome32, win_start(jpos, jbw) & M32, lmax + QOFF)
    return _cut_sums(q, win, jbw, jqsz)


def build_stage12(lmax: int, max_candidates: int, n_index2: int,
                  n_index3: int, per: int, cand_per_unit: int | None = None,
                  k_slots: int = 50, jobs_per_read: int = 8,
                  ext_iters: int = 31, device_tb: bool | None = None,
                  ext_pool: int | None = None, cut: str | None = None):
    """Fused stage-1+2 for single-end mapping (↔ JAX build_stage12; the
    exactness argument is in that docstring).  Returns (stage12, o_spec);
    stage12(genome32, counter2, counter3, index_all, pnib, lens, is_ga,
    scode, max_diffs_r, marks=None) -> (R, 8 + TB_NOPS) i32 packed rows
    [rec(4) | cig_meta(4) | cig_ops(TB_NOPS)] (only rec with device_tb
    off).  marks, a list, collects (name, CUDA event) pairs at the
    program's phase boundaries: start, core, decide, score (K2 done),
    select (winners and records done), end (traceback done).

    cut (profiling and diagnostics, as in JAX; one of SE_CUTS) ends the
    program early with JAX's i32 values: a core cut (CORE_CUTS) the
    core's; "core", "compact", "decide", "jobs" and "score" the (4,) sums
    of the stage's outputs (candidates; the slot table; the sorted
    window; the job rows and their operands; K2's scores), "fbstats" the
    (R, 8) fallback causes of each read [unit_fb, heap_would_fill,
    heap_fb, job_fb, bw_over, ex_over_fb, has_ex, ex_ambig].  The marks
    past the cut are not recorded."""
    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    K = int(os.environ.get("ABISMAL_TPU_K_SLOTS", k_slots))
    jobs_per_read = int(os.environ.get("ABISMAL_TPU_JOBS_PER_READ",
                                       jobs_per_read))
    if device_tb is None:
        device_tb = os.environ.get("ABISMAL_TPU_DEVTB", "1") == "1"
    _check_cut(cut, SE_CUTS)
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, ext_iters=ext_iters,
                              ext_pool=ext_pool,
                              cut=cut if cut in CORE_CUTS else None)
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
        if "cut" in c:
            return c["cut"]
        mark("core")
        pos, b_of = c["pos"], c["b_of"]
        cell_of, valid = c["cell_of"], c["valid"]
        d = c["d"].to(I64)
        unit_total, overflow, extras = (c["unit_total"], c["overflow"],
                                        c["extras"])
        ncand = pos.shape[0]
        if cut == "core":  # the candidate core alone
            return _cut_sums(pos, d, valid, unit_total)
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
        if cut == "compact":  # + gates, prefixes and the slot table
            # JAX's slot of every candidate, kept or not
            dest_all = r_of * K2 + wslot.clamp(max=K2 - 1)
            return _cut_sums(slots[: R * K2], dest_all, total_ex,
                             heap_would_fill)
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
        if cut == "decide":  # + the window reductions and the dedup sort
            return _cut_sums(posK, dK, vh, has_ex)
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
        # job columns (unit, pos, bw, qsz) as rows, so that each is one
        # contiguous tensor for K2, which reads the packed rows and genome
        jrows = _fill_job_rows(J + 1, dev)
        jrows[:, torch.where(job_ok, jexc, J)] = torch.stack(
            [qrowK.reshape(-1), posK.reshape(-1), bwK.reshape(-1),
             rlen.repeat_interleave(K2)])
        if cut == "jobs":  # + the job rows; K2 reads its operands itself
            return _job_operand_sums(genome32, pnib, *jrows[:, :J], lmax)
        if J:
            scores_j = banded_score_packed(genome32, pnib, *jrows[:, :J],
                                           lmax).to(I64)
            scrK = torch.where(job_ok.reshape(R, K2),
                               scores_j[jexc.clamp(max=J - 1)].reshape(R, K2),
                               0)
        else:
            scores_j = scrK = torch.zeros((R, K2), dtype=I64, device=dev)
        if cut == "score":  # + K2
            return _cut_sums(scores_j, jrows[2, :J], jrows[3, :J], vh)
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
        if cut == "fbstats":  # each read's fallback causes
            return torch.stack([unit_fb, heap_would_fill, heap_fb, job_fb,
                                bw_over, ex_over_fb, has_ex, ex_ambig],
                               dim=1).to(torch.int32)
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
                    ext_pool: int | None = None, cut: str | None = None):
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
    CUDA event) pairs at the program's phase boundaries.

    cut (profiling, as in JAX; one of PE_CUTS) ends the program early with
    JAX's (4,) i32 sums: a core cut (CORE_CUTS) the core's, "pegate",
    "pescan", "pecompact", "pejobs", "pescore", "pesort" and "pegrid"
    those of the stage's outputs (gates and unit spans; the slot ranks;
    the job rows and their operands; K2's scores; the slot grid's ranks
    and dedup; the mating records).  The marks past the cut are not
    recorded."""
    cand_per_unit = _resolve_cand_budget(cand_per_unit, n_index2, n_index3,
                                         lmax)
    jobs_per_unit = int(os.environ.get("ABISMAL_TPU_JOBS_PER_UNIT",
                                       jobs_per_unit))
    _check_cut(cut, PE_CUTS)
    core, o_spec = _make_core(lmax, max_candidates, n_index2, n_index3,
                              cand_per_unit, ext_iters=ext_iters,
                              ext_pool=ext_pool,
                              cut=cut if cut in CORE_CUTS else None)
    K = k_slots

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
        if "cut" in c:
            return c["cut"]
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
        if cut == "pegate":  # + gates, prefixes and unit spans
            return _cut_sums(c_exc, n_acc, heap_fb, base)
        base_of = _unit_base(ust_c, base, ncand)
        slot_u = c_exc - base_of
        keep = gate & (slot_u < K - 1)
        if cut == "pescan":  # + each candidate's unit base
            return _cut_sums(base_of, slot_u, keep, n_acc)
        if cut == "pecompact":  # + the slot ranks
            return _cut_sums(slot_u, n_acc, heap_fb, keep)
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
        # d rides the high half of the qsz column, as in the JAX rows; the
        # columns are rows, so that each is one contiguous tensor for K2,
        # which reads the packed rows and genome
        jrows = _fill_job_rows(J + 1, dev)
        jrows[:, jdest] = torch.stack(
            [b_of, pos, bw_c.clamp(max=BW_MAX), (d << 16) | extras[:, 3]])
        junit, jpos, jbw, jqd = jrows[:, :J]
        if cut == "pejobs":  # + the job rows; K2 reads its operands itself
            return _job_operand_sums(genome32, pnib, junit, jpos, jbw,
                                     jqd & 0xFFFF, lmax)
        scores_j = banded_score_packed(genome32, pnib, junit, jpos, jbw,
                                       jqd & 0xFFFF, lmax).to(I64)
        if cut == "pescore":  # + K2
            return _cut_sums(scores_j, jbw, jqd & 0xFFFF, n_acc)
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
        posKm = torch.where(live, jrows[1][jrank], INF32)
        dKm = torch.where(live, jrows[3][jrank] >> 16, INF32)
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
        dup = (eqp & jlt).any(dim=2)
        vM = live & ~dup
        if cut == "pesort":  # + the slot grid's ranks and dedup
            return _cut_sums(posM, rank, vM, dup)
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
        if cut == "pegrid":  # + the mating grids of every orientation
            return _cut_sums(mate, cnt, torch.zeros(1), n_acc)
        out = u32_to_i32(torch.cat([posKm, ds, cnt[:, None],
                                    mate.reshape(B, 5)], dim=1))
        mark("end")
        return out

    return stage12pe, o_spec


def _slot_streams(ev: np.ndarray, cf: np.ndarray):
    """The streams of build_stage1 on one device or a mesh (slot s's on
    rows (2s, 2s + 1), each slot covering its slice of cf), each cut to
    the length its slot wrote (gcap at most), so that the offsets of later
    slots hold.  Returns (pos, diffs, rank, start, count, overflow) as
    _merge_tp_streams does."""
    cnt = (cf & 0x3FFFFFFF).astype(np.int64)
    n_sh = ev.shape[0] // 2
    cnt2d = cnt.reshape(n_sh, -1)
    within = np.cumsum(cnt2d, axis=1) - cnt2d
    totals = np.minimum(within[:, -1] + cnt2d[:, -1], ev.shape[1])
    ustart = (np.concatenate(([0], np.cumsum(totals)[:-1]))[:, None]
              + within).reshape(-1)
    pos = np.concatenate([ev[2 * s, : totals[s]] for s in range(n_sh)])
    meta = np.concatenate([ev[2 * s + 1, : totals[s]] for s in range(n_sh)])
    return (pos, (meta >> 22).astype(np.int32) - 512,
            (meta & 0x3FFFFF).astype(np.int32), ustart, cnt, (cf >> 30) != 0)


class TorchNativeEngine:
    """The JAX TpuNativeEngine on a torch device.  Implements the
    dispatch/finish pipeline interface of run_map_pipelined, by one of two
    routes:
      fused (device_stage2, the default): the stage-1+2 programs
        (build_stage12 for single-end, build_stage12pe for paired-end) run
        on the device and their packed rows go to the native engine's
        finalize, which formats the SAM and re-maps the fallback reads
        exactly;
      event stream (device_stage2=False, or ABISMAL_TPU_STAGE2=0):
        build_stage1's accepted events go to the native engine, which
        replays them in place of its own seeding (units flagged overflow
        re-seed natively) and decides, aligns and formats.  With
        device_align (ABISMAL_TPU_DEVICE_ALIGN=1; not with a mesh) the
        native engine hands its alignment jobs back, K2 scores up to
        align_jcap of them a chunk on the device from the chunk's resident
        unit rows (banded_score_packed), and the native engine scores the
        rest and finishes.

    mesh_devices (an int, "all" or a list of devices: parallel.mesh.
    make_mesh) splits every chunk over the mesh's slots, each with its
    replica of the tables, in place of the one device; unit_batch must
    divide by the mesh size.  With a mesh, device_decisions adds up the
    fused route's SE decision counts [unmapped, exact, aligned, fallback]
    of every read, and no phase marks are kept.

    index_shards (the same forms; not with mesh_devices) splits the index
    instead: each slot holds the position lists of one key range
    (DeviceIndexTP) and runs build_stage1 on the whole chunk, and the
    host merges the slots' streams by rank (_merge_tp_streams).  It takes
    the event route, without device_align.

    On a CUDA device every device program of every route runs as a CUDA
    graph captured once per shape key and device (graphs.Graphs, the
    counterpart of jax.jit); graphs=False, or the CPU, runs the programs
    eagerly, op by op (graphs.Eager).  With graphs and profile on, a
    chunk's marks are one ("start", "end") pair around its replay."""

    supports_pipeline = True
    pipeline_depth = 2  # batches in flight ahead of the native finish

    def __init__(self, index, allow_ambig=False, valid_frac=0.1,
                 pe_min_dist=32, pe_max_dist=3000, lmax: int = 128,
                 unit_batch: int = 2048, n_threads: int = 1,
                 device="cuda", mesh_devices=None, index_shards=None,
                 device_stage2=None, device_align=None,
                 align_jcap: int = 8192, graphs: bool = True):
        if mesh_devices and index_shards:
            raise ValueError(
                "mesh_devices (data parallel) and index_shards (sharded "
                "index) are alternative mesh layouts; pick one")
        if index.genome_size > POS_EMPTY - 1:
            # positions are u32 and POS_EMPTY marks a dead PE slot
            raise ValueError(f"genome of {index.genome_size} bases exceeds "
                             f"the device path's {POS_EMPTY - 1}")
        self.mesh = None
        self.n_shards = 1
        self.tp = None  # the sharded index (DeviceIndexTP)
        if mesh_devices:
            self.mesh = make_mesh(mesh_devices)
            self.n_shards = len(self.mesh)
            if unit_batch % self.n_shards:
                raise ValueError("unit_batch must divide by mesh size")
            self.device = self.mesh[0]
        elif index_shards:
            tp_mesh = make_mesh(index_shards)
            self.device = tp_mesh[0]
        else:
            self.device = resolve_device(device)
        self.graphs = use_graphs(graphs, self.device)
        self.native = NativeMappingEngine(index, allow_ambig, valid_frac,
                                          pe_min_dist, pe_max_dist,
                                          n_threads=n_threads)
        self.lmax = lmax
        self.valid_frac = valid_frac
        self.unit_batch = unit_batch
        self.device_tb = os.environ.get("ABISMAL_TPU_DEVTB", "1") == "1"
        if index_shards:
            # the position lists split by key range over the slots, every
            # slot maps the whole chunk; the host merges the streams
            self.tp = DeviceIndexTP(index, tp_mesh)
            self.dev = None
            self._stage1_tp = shard_stage1_tp(build_stage1(
                lmax, self.tp.max_candidates, self.tp.P2, self.tp.P3,
                ext_iters=self.tp.ext_iters, tp=True)[0], tp_mesh,
                self.graphs)
        elif self.mesh is None:
            self.dev = DeviceIndex.from_index(index, self.device)
        else:
            self.replicas = replicate_tables(index, self.mesh)
            self.dev = self.replicas[0]
        if device_stage2 is None:
            device_stage2 = bool(int(os.environ.get("ABISMAL_TPU_STAGE2",
                                                    "1")))
        # the sharded index runs the event route: candidate lists span
        # the shards, so only the host sees a unit's whole stream
        self.device_stage2 = bool(device_stage2) and not index_shards
        if device_align is None:
            device_align = bool(int(os.environ.get(
                "ABISMAL_TPU_DEVICE_ALIGN", "0")))
        self.device_align = (bool(device_align) and self.mesh is None
                             and not index_shards)
        self.align_jcap = int(align_jcap)
        self.n_device_aligned = 0
        self.device_decisions = np.zeros(4, dtype=np.int64)
        self._host_counters = (index.counter, index.counter_t,
                               index.counter_a)
        self.cand_budget = None
        self._ext_mean = None
        self._stage12_progs = {}
        self.n_fallback = 0
        self.n_units = 0
        self._pool = None  # collector threads of the event route
        self._counter_lock = threading.Lock()
        self.stage_time = {"unit prep": 0.0, "device dispatch": 0.0,
                           "device collect": 0.0, "native stage-2": 0.0}
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
                prog = shard_stage12(prog, self.mesh, self.graphs)
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
        return put(a, self.device)

    def close(self):
        """Stops the event route's collector threads, once the batches in
        flight are collected (a later dispatch starts them anew)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # --- the event-stream route (device_stage2 off) ------------------------
    def _stage1_prog(self, cand_budget):
        ext_pool = self._informed_ext_pool()
        key = ("stage1", cand_budget, ext_pool)
        prog = self._stage12_progs.get(key)
        if prog is None:
            prog, _ = build_stage1(
                self.lmax, self.dev.max_candidates, self.dev.n_index2,
                self.dev.n_index3, cand_per_unit=cand_budget,
                ext_iters=self.dev.ext_iters, ext_pool=ext_pool)
            if self.mesh is not None:
                prog = shard_stage1(prog, self.mesh, self.graphs)
            self._stage12_progs[key] = prog
        return prog

    def _dispatch_events(self, pnib_all, lens_all, wanted, is_ga_pat, t0):
        """Enqueues build_stage1 on every unit_batch units of the batch's
        unit rows (unit id = row, as in the JAX _se_units_flat and
        _pe_units_flat) and starts their collection on the collector
        threads.  Empty and oversized reads' rows have length 0: their
        units are not resident and re-seed natively.  Returns (pending,
        future of (events, unit_loc)); pending holds (first unit, units,
        ev, cf, the chunk's unit rows on the device for device_align)."""
        per = is_ga_pat.shape[0]
        t1 = time.perf_counter()
        if self.tp is None:
            prog = self._stage1_prog(self._budget_for((pnib_all, lens_all),
                                                      is_ga_pat, per))
        n = wanted.shape[0]  # per units a read (the rows pad an empty batch)
        resident = lens_all[:n] > 0
        B = max(self.n_shards, self.unit_batch - self.unit_batch
                % self.n_shards)
        if self.dev is not None and self.mesh is None:
            tables = self.dev.tables()
        pending = []
        for u0 in range(0, n, B):
            nu = min(B, n - u0)
            if not resident[u0 : u0 + nu].any():
                continue
            preads, lens = pnib_all[u0 : u0 + nu], lens_all[u0 : u0 + nu]
            if B - nu:
                preads = np.pad(preads, ((0, B - nu), (0, 0)))
                lens = np.pad(lens, (0, B - nu))
            is_ga = is_ga_pat[(u0 + np.arange(B)) % per]
            thr = ((2 * lens.astype(np.int64)) // 5).astype(np.int32)
            pn = None
            if self.tp is not None:
                ev, cf = self._stage1_tp(self.tp.slots, preads, lens, is_ga,
                                         thr)
            elif self.mesh is not None:
                ev, cf, _total = prog(self.replicas, preads, lens, is_ga, thr)
            else:
                ev, cf = self.graphs.run(prog, tables,
                                         (preads, lens, is_ga, thr))
                if self.device_align:
                    pn = self._put(preads)
            pending.append((u0, nu, ev, cf, pn))
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.pipeline_depth)
        fut = self._pool.submit(self._collect_flat, pending, resident, wanted)
        t2 = time.perf_counter()
        self.stage_time["unit prep"] += t1 - t0
        self.stage_time["device dispatch"] += t2 - t1
        return pending, fut

    def _collect_flat(self, pending, resident, wanted):
        """The chunks' streams in the native engine's event format (↔ JAX
        _collect_flat): ((pos u32, diffs i32, rank i32, start i64, count
        i64, boundary), (unit_chunk, unit_row)).  count -1 sends a unit to
        the native seeding: overflowed units, and those that are not
        resident.  A sharded index's streams are merged by rank
        (_merge_tp_streams); a mesh's are cut each to the length its slot
        wrote (_slot_streams).  Runs on a collector thread: the shared
        counters are guarded."""
        n = resident.shape[0]
        start = np.zeros(n, dtype=np.int64)
        count = np.full(n, -1, dtype=np.int64)
        unit_chunk = np.full(n, -1, dtype=np.int32)  # -1: not on the device
        unit_row = np.zeros(n, dtype=np.int32)
        parts = []
        base = n_fb = 0
        for ci, (u0, nu, ev_t, cf_t, _pn) in enumerate(pending):
            ev = ev_t.cpu().numpy().view(np.uint32)
            cf = cf_t.cpu().numpy()
            streams = _merge_tp_streams if cf.ndim == 2 else _slot_streams
            pos, diffs, rank, ustart, cnt, overflow = streams(ev, cf)
            parts.append((pos, diffs, rank))
            res = resident[u0 : u0 + nu]
            ok = res & ~overflow[:nu]
            start[u0 : u0 + nu] = np.where(ok, base + ustart[:nu], 0)
            count[u0 : u0 + nu] = np.where(ok, cnt[:nu], -1)
            unit_chunk[u0 : u0 + nu] = np.where(res, ci, -1)
            unit_row[u0 : u0 + nu] = np.arange(nu)
            n_fb += int((res & overflow[:nu]).sum())
            base += pos.shape[0]
        with self._counter_lock:
            self.n_units += int(wanted.sum())
            self.n_fallback += n_fb + int((wanted & ~resident).sum())
        if parts:
            ev_pos, diffs, rank = (np.concatenate(c) for c in zip(*parts))
        else:
            ev_pos = np.zeros(1, dtype=np.uint32)
            diffs = rank = np.zeros(1, dtype=np.int32)
        events = (ev_pos, diffs, rank, start, count,
                  o_spec_for(self.lmax) * 2 * SLOT)
        return events, (unit_chunk, unit_row)

    def _finish_events(self, handle, stats, out):
        """The native engine on the batch's events; with device_align, its
        alignment jobs scored on the device in between."""
        _, paired, reads, arm, rp, per, pending, fut = handle
        t0 = time.perf_counter()
        events, unit_loc = fut.result()
        t1 = time.perf_counter()
        self.stage_time["device collect"] += t1 - t0
        nat = self.native
        if not self.device_align:
            call = nat._call_pe if paired else nat._call_se
            call(*reads, arm, rp, stats, out, events)
        else:
            phase1 = nat._phase1_pe if paired else nat._phase1_se
            n_jobs, jobs = phase1(*reads, arm, rp, events)
            scores = np.full(n_jobs, np.iinfo(np.int32).min, dtype=np.int32)
            if n_jobs:
                # PE: jobs[:, 1] is the unit's offset in its pair's block;
                # SE: the encoding (pt, pt_rc, pa, pa_rc), mapped to it
                enc = jobs[:, 1].astype(np.int64)
                if paired:
                    uoff = enc
                elif rp:
                    uoff = np.array([0, 2, 1, 3], dtype=np.int64)[enc]
                else:
                    uoff = ((enc == 1) | (enc == 3)).astype(np.int64)
                self._score_jobs_on_device(
                    jobs, scores, per * jobs[:, 0].astype(np.int64) + uoff,
                    pending, unit_loc)
            (nat._phase2_pe if paired else nat._phase2_se)(scores, stats, out)
        self.stage_time["native stage-2"] += time.perf_counter() - t1
        return len(reads[0])

    def _score_jobs_on_device(self, jobs, scores, uid, pending, unit_loc):
        """Scores the native engine's alignment jobs (read, enc or slot,
        pos, bw, qsz) with K2 on the unit rows each chunk left on the
        device; uid is each job's unit.  At most align_jcap jobs a chunk
        go to the device; the rest, and jobs of units not on the device,
        keep the sentinel and are scored natively in phase 2."""
        uc, ur = unit_loc
        cidx, row = uc[uid], ur[uid]
        for ci, (_u0, _nu, _ev, _cf, pn) in enumerate(pending):
            take = np.flatnonzero(cidx == ci)[: self.align_jcap]
            if not take.size:
                continue
            cols = self._put(np.stack([
                row[take].astype(np.int64),
                jobs[take, 2].astype(np.int64) & M32,
                jobs[take, 3].astype(np.int64),
                jobs[take, 4].astype(np.int64)]))
            res = banded_score_packed(self.dev.genome32, pn, *cols,
                                      self.lmax)
            scores[take] = res.cpu().numpy()
            self.n_device_aligned += int(take.size)

    def dispatch_se(self, reads, a_rich_mode, random_pbat):
        """Enqueues the device program for every chunk of the batch."""
        t0 = time.perf_counter()
        pnib_all, lens_all, per, oversized = self._se_units_mat(
            reads, a_rich_mode, random_pbat)
        scode_pat = _se_scode_pattern(a_rich_mode, random_pbat)
        is_ga_pat = np.array([get_conv_is_ga(int(c)) for c in scode_pat],
                             dtype=bool)
        if not self.device_stage2:
            # every unit of a read with bases is on the native side's list
            wanted = np.repeat(np.fromiter((bool(s) for _, s in reads),
                                           dtype=bool, count=len(reads)),
                               per)
            return ("events", False, (reads,), a_rich_mode, random_pbat,
                    per) + self._dispatch_events(pnib_all, lens_all, wanted,
                                                 is_ga_pat, t0)
        prog = self._stage12_prog(
            per, self._budget_for((pnib_all, lens_all), is_ga_pat, per))
        q = per * self.n_shards  # batch quantum (units/read x mesh slots)
        B = max(q, self.unit_batch - (self.unit_batch % q))
        rpc = B // per  # reads per chunk
        if self.mesh is None:
            tables = self.dev.tables()
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
                rows = self.graphs.run(
                    prog, tables, (preads, lens, is_ga, scode_pat,
                                   max_diffs_r), marks)
                if marks is not None:
                    self.chunk_marks.append(marks)
            pending.append((start, n, rows, counts))
        self.stage_time["device dispatch"] += time.perf_counter() - t0
        return (reads, a_rich_mode, random_pbat, per, pending, oversized)

    def finish_se(self, handle, stats, out):
        """Collects the chunks' packed rows (one copy each) and hands them
        to the native finalize."""
        if handle[0] == "events":
            return self._finish_events(handle, stats, out)
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
                prog = shard_stage12pe(prog, self.mesh, self.graphs)
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
        is_ga_pat = _pe_is_ga_pattern(a_rich_mode, random_pbat)
        if not self.device_stage2:
            # units 0 and 3 of an orientation block carry end 1, 1 and 2
            # end 2 (the JAX _pe_units_flat order)
            has = [np.fromiter((bool(s) for _, s in r), dtype=bool,
                               count=len(r)) for r in (reads1, reads2)]
            end2 = np.tile([False, True, True, False], per // 4)
            wanted = np.where(end2[None, :], has[1][:, None],
                              has[0][:, None]).reshape(-1)
            return ("events", True, (reads1, reads2), a_rich_mode,
                    random_pbat, per) + self._dispatch_events(
                        pnib_all, lens_all, wanted, is_ga_pat, t0)
        prog = self._stage12pe_prog(
            per, self._budget_for((pnib_all, lens_all), is_ga_pat, per))
        q = per * self.n_shards
        B = max(q, self.unit_batch - (self.unit_batch % q))
        ppc = B // per  # pairs per chunk
        pe_dist = np.array([self.native.pe_min_dist,
                            self.native.pe_max_dist], np.int32)
        is_ga = np.tile(is_ga_pat, ppc)
        if self.mesh is None:
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
                rows = self.graphs.run(
                    prog, tables, (preads, lens, is_ga, max_diffs_u,
                                   pe_dist), marks)
                if marks is not None:
                    self.chunk_marks.append(marks)
            pending.append((start, nu, rows))
        self.stage_time["device dispatch"] += time.perf_counter() - t0
        return (reads1, reads2, a_rich_mode, random_pbat, per, pending,
                oversized)

    def finish_pe(self, handle, stats, out):
        """Collects the chunks' packed slot rows (one copy each) and hands
        them to the native PE finalize."""
        if handle[0] == "events":
            return self._finish_events(handle, stats, out)
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


def release_engines():
    """Closes and drops every memoized engine, and with it its tables."""
    for _index, eng in _engine_memo.values():
        if isinstance(eng, TorchNativeEngine):  # its collector threads
            eng.close()
    _engine_memo.clear()


def _mesh_key(spec):
    return (tuple(str(d) for d in spec) if isinstance(spec, (list, tuple))
            else spec)


def make_torch_native_engine_factory(device, lmax: int = 128,
                                     unit_batch: int = 2048,
                                     n_threads: int = 1, mesh_devices=None,
                                     device_align=None,
                                     align_jcap: int = 8192,
                                     device_stage2=None, index_shards=None):
    """run_map engine factory for TorchNativeEngine on `device`, over the
    mesh mesh_devices or over the index shards index_shards, memoized per
    index (the device tables are ~1 GB at any genome size).  device_stage2
    and device_align pick the route (None: the environment's default; see
    TorchNativeEngine)."""

    def factory(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
        key = ("torch-native", id(index), int(index.max_candidates),
               allow_ambig, valid_frac, pe_min_dist, pe_max_dist, lmax,
               unit_batch, str(device), _mesh_key(mesh_devices),
               device_align, align_jcap, device_stage2,
               _mesh_key(index_shards))
        hit = _engine_memo.get(key)
        if hit is not None and hit[0] is index:
            hit[1].n_threads = n_threads
            return hit[1]
        eng = TorchNativeEngine(index, allow_ambig, valid_frac, pe_min_dist,
                                pe_max_dist, lmax=lmax, unit_batch=unit_batch,
                                n_threads=n_threads, device=device,
                                mesh_devices=mesh_devices,
                                device_align=device_align,
                                align_jcap=align_jcap,
                                device_stage2=device_stage2,
                                index_shards=index_shards)
        _engine_memo[key] = (index, eng)
        return eng

    factory.is_native = True
    return factory


# --- the replay engines: the exact engine on device candidates -------------

def replay_events(res, sc: int, ev_pos, ev_diffs, ev_rank, count: int,
                  o_spec: int) -> None:
    """Replays process_seeds' sequential candidate-set updates
    (abismal.cpp:1269-1375) over device-computed events.  Events arrive in
    discovery order; rank encodes (phase, offset, table, slot)."""
    boundary = o_spec * 2 * SLOT
    res.set_specific()
    i = 0
    while i < count and ev_rank[i] < boundary:
        if res.sure_ambig:
            break
        d = int(ev_diffs[i])
        if d <= res.cutoff:
            res.update(True, d, sc, int(ev_pos[i]))
        i += 1
    # skip remaining specific events after a sure-ambig abort
    while i < count and ev_rank[i] < boundary:
        i += 1
    if not res.should_do_sensitive():
        return
    res.set_sensitive()
    while i < count:
        if res.sure_ambig:
            break
        d = int(ev_diffs[i])
        if d <= res.cutoff:
            res.update(True, d, sc, int(ev_pos[i]))
        i += 1


class EventReplayEngine(MappingEngine):
    """The exact engine seeded from event caches handed to it (↔ JAX
    EventReplayEngine): run_map_hybrid's workers, which touch no device,
    replay the events the parent's TorchMappingEngine collected.  A cache
    maps a unit's key to (pos, diffs, rank, count), NumPy arrays, or to
    None: that unit, and any unit not in it, is seeded on the host."""

    def __init__(self, *args, **kwargs):
        MappingEngine.__init__(self, *args, **kwargs)
        self._cache = {}
        self.o_spec = o_spec_for(128)

    def set_cache(self, cache, o_spec):
        self._cache = cache
        self.o_spec = o_spec

    def _seeds(self, pread, sc, res, key=None):
        ev = self._cache.get(key, None) if key is not None else None
        if ev is None:
            process_seeds(self.view, pread, pack_read(pread), sc, res)
            return
        ev_pos, ev_diffs, ev_rank, c = ev
        replay_events(res, sc, ev_pos, ev_diffs, ev_rank, c, self.o_spec)


class TorchMappingEngine(EventReplayEngine):
    """The exact engine with its candidates from the device (↔ JAX
    TpuMappingEngine, `--engine torch-replay`): before each batch every
    read's units go through build_stage1 (K1) on `device`, unit_batch
    units a chunk, and the sequential decision logic replays each unit's
    events; units flagged overflow, and those longer than lmax, are
    seeded on the host.  The output is the exact engine's.  The streams
    are copied to the host when a batch is collected (_collect_units).
    graphs as for TorchNativeEngine."""

    def __init__(self, index, allow_ambig=False, valid_frac=0.1,
                 pe_min_dist=32, pe_max_dist=3000, lmax: int = 128,
                 unit_batch: int = 1024, device="cuda", graphs: bool = True):
        self.device = resolve_device(device)
        self.graphs = use_graphs(graphs, self.device)
        if index.genome_size > POS_EMPTY - 1:
            raise ValueError(f"genome of {index.genome_size} bases exceeds "
                             f"the device path's {POS_EMPTY - 1}")
        EventReplayEngine.__init__(self, index, allow_ambig, valid_frac,
                                   pe_min_dist, pe_max_dist)
        self.lmax = lmax
        self.unit_batch = unit_batch
        self.dev = DeviceIndex.from_index(index, self.device)
        self.stage1, self.o_spec = build_stage1(
            lmax, self.dev.max_candidates, self.dev.n_index2,
            self.dev.n_index3, ext_iters=self.dev.ext_iters)
        self.n_fallback = 0
        self.n_units = 0

    def _dispatch_units(self, units):
        """units: list of (key, pread nibbles, is_ga).  Enqueues stage 1 on
        every unit_batch units; returns the handle of _collect_units:
        (keys seeded on the host, [(chunk, ev, cf)])."""
        pre_cache = {}
        pending = []
        B = self.unit_batch
        for start in range(0, len(units), B):
            chunk = units[start : start + B]
            for u in chunk:
                if u[1].shape[0] > self.lmax:  # seeded on the host
                    pre_cache[u[0]] = None
            chunk = [u for u in chunk if u[1].shape[0] <= self.lmax]
            if not chunk:
                continue
            preads, lens = prepare_units([u[1] for u in chunk], self.lmax)
            pad = B - len(chunk)
            if pad:
                preads = np.pad(preads, ((0, pad), (0, 0)))
                lens = np.pad(lens, (0, pad))
            is_ga = np.zeros(B, dtype=bool)
            is_ga[: len(chunk)] = [u[2] for u in chunk]
            thr = ((2 * lens.astype(np.int64)) // 5).astype(np.int32)
            ev, cf = self.graphs.run(self.stage1, self.dev.tables(),
                                     (preads, lens, is_ga, thr))
            pending.append((chunk, ev, cf))
        return pre_cache, pending

    def _collect_units(self, dispatched):
        """Copies the dispatched streams to the host: the event cache
        {unit key: (pos, diffs, rank, count), or None to seed on the
        host}."""
        pre_cache, pending = dispatched
        cache = dict(pre_cache)
        for chunk, ev_t, cf_t in pending:
            gpos, gmeta = ev_t.cpu().numpy().view(np.uint32)
            cf = cf_t.cpu().numpy()
            count = cf & 0x3FFFFFFF
            overflow = (cf >> 30) != 0
            prefix = np.concatenate(([0], np.cumsum(count)))
            diffs_all = (gmeta >> 22).astype(np.int32) - 512
            rank_all = (gmeta & 0x3FFFFF).astype(np.int32)
            for i, u in enumerate(chunk):
                self.n_units += 1
                if overflow[i]:
                    self.n_fallback += 1
                    cache[u[0]] = None
                else:
                    s, e = int(prefix[i]), int(prefix[i + 1])
                    cache[u[0]] = (gpos[s:e], diffs_all[s:e], rank_all[s:e],
                                   e - s)
        return cache

    def _run_units(self, units):
        self._cache = self._collect_units(self._dispatch_units(units))

    def _se_units(self, reads, a_rich_mode, random_pbat):
        """The units of a batch of reads, keyed as map_se_reads asks."""
        units = []
        for ri, (_, read) in enumerate(reads):
            if not read:
                continue
            rc = revcomp_str(read.decode()).encode()
            if not random_pbat:
                conv = a_rich_mode
                units.append((
                    (ri, "f", conv), prep_read(read, conv),
                    get_conv_is_ga(strand_code("+", conv))))
                units.append((
                    (ri, "r", not conv), prep_read(rc, not conv),
                    get_conv_is_ga(strand_code("-", conv))))
            else:
                units.append(((ri, "f", False), prep_read(read, False),
                              get_conv_is_ga(strand_code("+", False))))
                units.append(((ri, "f", True), prep_read(read, True),
                              get_conv_is_ga(strand_code("+", True))))
                units.append(((ri, "r", False), prep_read(rc, False),
                              get_conv_is_ga(strand_code("-", True))))
                units.append(((ri, "r", True), prep_read(rc, True),
                              get_conv_is_ga(strand_code("-", False))))
        return units

    def _prepare_batch_se(self, reads, a_rich_mode, random_pbat):
        self._run_units(self._se_units(reads, a_rich_mode, random_pbat))

    def _pe_units(self, reads1, reads2, a_rich_mode, random_pbat):
        """The units of a batch of pairs, keyed as map_pe_reads asks."""
        units = []

        def add(ri, end, orient, enc, read_bytes, sc):
            if not read_bytes:
                return
            seq = read_bytes
            if orient == "r":
                seq = revcomp_str(read_bytes.decode()).encode()
            units.append(((ri, end, orient, enc), prep_read(seq, enc),
                          get_conv_is_ga(sc)))

        convs = [a_rich_mode] if not random_pbat else [False, True]
        for ri, ((_, r1), (_, r2)) in enumerate(zip(reads1, reads2)):
            for conv in convs:
                add(ri, 1, "f", conv, r1, strand_code("+", conv))
                add(ri, 2, "r", conv, r2, strand_code("-", not conv))
                add(ri, 2, "f", not conv, r2, strand_code("+", not conv))
                add(ri, 1, "r", not conv, r1, strand_code("-", conv))
        return units

    def _prepare_batch_pe(self, reads1, reads2, a_rich_mode, random_pbat):
        self._run_units(self._pe_units(reads1, reads2, a_rich_mode,
                                       random_pbat))


def make_torch_engine_factory(device="cuda", lmax: int = 128,
                              unit_batch: int = 1024):
    """run_map engine factory for TorchMappingEngine on `device`, memoized
    per index.  It is a replay factory (factory.is_replay): run_map with
    threads > 1 runs its engine's stage 1 in the calling process and the
    replay in worker processes (runner.run_map_hybrid)."""

    def factory(index, allow_ambig, valid_frac, pe_min_dist, pe_max_dist):
        key = ("torch-replay", id(index), int(index.max_candidates),
               allow_ambig, valid_frac, pe_min_dist, pe_max_dist, lmax,
               unit_batch, str(device))
        hit = _engine_memo.get(key)
        if hit is not None and hit[0] is index:
            return hit[1]
        eng = TorchMappingEngine(index, allow_ambig, valid_frac, pe_min_dist,
                                 pe_max_dist, lmax=lmax,
                                 unit_batch=unit_batch, device=device)
        _engine_memo[key] = (index, eng)
        return eng

    factory.is_replay = True
    return factory
