#!/usr/bin/env python3
"""Smoke test of abismal_tpu_torch, the PyTorch + CUDA port, on one GPU.

Phases (each prints one JSON line; any failure exits non-zero):
  1. probe    torch / CUDA / nvcc versions, the card's name and power limit;
  2. build    nvcc-builds the port's kernels (csrc/*.cu) from the checkout,
              one nvcc per source at once, and prints what ptxas says of
              their registers and spills;
  3. kernels  each kernel (K1 popcount_compare, K2 banded_score_packed,
              which reads packed query rows and the packed genome, K3
              banded_trace and banded_trace_packed, its entry point on
              the main path) against its plain PyTorch version on the card,
              at main-path shapes (K2 at J = 8192 over a 256 MB packed
              genome with the bands of real reads, at J = 8192 with mixed
              bands, at the paired-end program's J = 16384, with negative
              bands and fill rows, and at J = 8192 with the narrow bands of
              the default -m 0.1; K3 at
              J2 = 1024 mixed bands, at the bands and length of real
              reads, and on 1024 and 2048 winners read from packed rows
              and a 256 MB packed genome), exact equality; both timed
              with CUDA events in turns (plain, kernel, kernel, plain),
              the kernel also as a CUDA graph of
              its launches, which leaves the host out (K1 also over 16
              input sets in turn, which L2 cannot hold); for each case the
              bytes and operations counted from its inputs, the bound
              they give on this card, and the kernel's share of it; for
              K3, whose launches fill under one wave of warps, also
              chain_ms, a model of its longest job's serial chain (rows
              plus walk steps at an assumed cycle count a link; it is in
              this phase's line only, not in the kernels' summary); K4,
              whose cases are pools of real lanes, runs in kernels_ext;
  4. goldens  maps tests/golden small_1.fq (500 reads) and reads_1.fq (10k)
              with the port engine on the card; the SAM and mstats must
              equal the upstream goldens byte for byte, and every kernel's
              launch counter must move during these runs; the bands K2
              gets on the 10k reads (and, in phase 5, on the 10k pairs)
              are counted in one more run, not timed, and printed as a
              histogram;
  5. goldens_pe  maps the six paired-end goldens (small_pe, small_pbat_pe,
              small_rpbat_pe: 500 pairs; reads_pe, reads_pbat_pe,
              reads_rpbat_pe: 10k) with the argv of tests/golden/MANIFEST.md;
              SAM and mstats must equal the goldens byte for byte, and the
              K1, K2, K4, K5 and K6 counters must move during these runs;
              then
              small_rpbat_pe under -a with random PBAT must equal the
              native engine, with pairs mated on the device;
  6. events   the event-stream route (device_stage2=False: build_stage1's
              events replayed by the native engine) on small, reads and
              the six paired-end goldens, without and with device_align
              (the native engine's alignment jobs scored by
              banded_score_packed): SAM and mstats byte for byte; K1, K4
              and K6 must launch in both, banded_score_packed in the align
              runs only;
              then `map --device-align` with ABISMAL_TPU_STAGE2=0 in a
              process of its own on small gives the golden but for @PG;
  7. scale    the 1 Gb synthetic genome of tools/scale_test.py:gen_genome:
              20k simulated SE reads, then 20k simulated pairs, each mapped
              by the port and by the native engine: the SAM bytes must be
              equal; the SE reads also through the event route with
              device_align (reads/s beside the native control, fallback,
              jobs scored on the device);
  7b. kernels_ext  K4 (seed_extend, the pooled seed extension from the
              pool's prefix count to the extended cells: each slot's lane,
              its search, LCP window and stop depth, and the cells no lane
              holds) against its plain version on the card on the pools
              that the first 2048-unit chunk of the 10k golden reads and
              of the 1 Gb SE set hand it (lmax 128; the engine sizes the
              pool from a sample of the index), on the 1 Gb chunk's pool
              at the core's static 512 lanes, and on a pool of 512 slots
              all live (a chunk of reads of the repeat genome of
              tools/debug_ext.py), recorded from the eager program: exact
              equality, the device time from a CUDA graph of 20 launches
              beside the earlier design's (K4_LANE_BODY_US), the plain
              version's in turns, the bytes the cells and these lanes'
              trips and windows need and their bound, and chain_ms, a
              model of the longest lane's chain of dependent loads in
              this design beside the earlier design's (chain_ms_old;
              neither measured, no bound);
              K5 (segment_rank, the slot ranks) and K6 (candidate_list,
              the global candidate list) the same way on what the
              programs hand them on the first chunk of the 10k golden
              reads, the 10k golden pairs and the 1 Gb SE set, each beside
              the PyTorch call their kernels took the place of
              (torch.cummax, torch.searchsorted) on the same sizes;
  8. profile  the profiling and diagnostic cuts of the fused programs
              through the port's tools (abismal_tpu_torch/tools/): the
              single-end and paired-end cut bisections (profile_stage12,
              profile_stage12pe: each cut's ms a 2048-unit chunk and its
              delta) on the 10k golden reads and pairs; "fbstats" on
              every chunk of the 10k reads, its fallback causes equal to
              the uncut program's fallback flags; cut programs run with
              the phase marks on; "unitstats" (candidates a unit, the
              overflow share) and the single-end bisection on the 1 Gb
              SE set, on the scale phase's tables; trace_ops' top 10
              CUDA kernels of a tRex1 chunk;
              K1-K6 must launch in the phase;
  9. shards_replay  the key-range-sharded index (--index-shards) over two
              slots of the card (and over every card, given two): small,
              reads, small_pe, reads_pe give the goldens' SAM and mstats,
              and the 1 Gb SE set of phase 7 the native engine's SAM; the
              replay engine (--engine torch-replay) on small and small_pe
              gives the goldens in this process (-t 1) and through three
              forked workers (-t 3); K1 must launch in every run, and
              every run prints its rate beside this call's native rate;
  10. scaleout the scale-out paths, on the goldens and the 1 Gb sets:
              mesh      two slots on cuda:0 (unit_batch 4096: each slot
                        maps 2048 units, the one-card chunk): small, reads,
                        small_pe, reads_pe give the goldens' SAM and mstats
                        and SE decision counts cover every read; the 1 Gb
                        SE and PE SAMs equal the native engine's; with two
                        or more cards the 1 Gb runs go over every card too
                        (2048 units per card);
              hybrid    the in-process split on the 1 Gb sets, its share
                        dev_rate / (dev_rate + host_rate) from this call's
                        rates, equals the native SAM; the NativeShardServer
                        split on reads and reads_pe gives the goldens;
              multihost run_map_multihost with 2 shards on small and
                        reads_pe gives the goldens, and the two
                        `map --shard I:2`
                        processes on small (single-end), concatenated,
                        give the golden but for the @PG line;
              K1-K6 must launch during the mesh and the hybrid runs, and
              every run prints its rate beside this call's port-only and
              native-only rates;
  11. graphs  every route's device programs as CUDA graphs (the default on
              the card, as in every phase from 4 on) against the eager
              programs (graphs=False): fused SE and PE, the event route
              with device_align, --index-shards over two slots, the mesh
              of two slots (fused SE and PE, the event route), the
              replay engine's stage 1; each route's outputs on a batch of
              4096 reads or pairs bit-equal, the chunk span and the
              dispatch's host time in turns (eager, graphed, graphed,
              eager), launches a chunk (torch.profiler), capture seconds
              and pool bytes of every key; whole-path rates of both in
              turns with the native engine once, on the 10k golden reads
              and pairs and the 1 Gb SE set, each SAM checked, with the
              peak device memory of a map; each route's K1-K6 runs on
              the card, counted by name in torch.profiler, must equal
              the launch counters' growth, graphed and eager alike, and
              the top 10 card ops a chunk by device time (graphed: a
              replay's breakdown); then the K4 engine against an engine
              whose core runs K4's plain version (the wrapper swapped for
              that engine's runs alone), and the K5 and K6 engine against
              one whose programs run their plain versions, on fused SE
              and PE and the 1 Gb SE set: outputs bit-equal, card ops and
              the top 10 of a replay, replay spans and rates in turns
              (plain, kernels, kernels, plain), the native engine once;
              K1-K6 must launch in the phase;
  12. tools   the port's bench and tuning tools (abismal_tpu_torch/tools/):
              the bench over its five modes (native, torch, split,
              pe_native, pe_torch; each in a child process, one
              repetition), every mode's best rate verified (> 0), the
              torch mode's fallback fraction equal to the goldens phase's
              on `reads` (the same 10k reads); tune_stage2 2048 (every
              repetition verified), sweep_unit_batch 2048 8192 (SAMs
              equal to the golden), tune_hybrid 2048, multihost_scale
              --hosts 1 2 --per-host 10000 --reps 1 with native and with
              torch shards, and `map --hosts 2 --engine native` on reads,
              equal to the golden but for the @PG line; K1-K6 must launch
              in the phase's in-process tools.
It imports only the port (abismal_tpu_torch), which has its own host
side; nothing of JAX and nothing of the JAX package (checked at the end).
The line before the last is the kernels' JSON summary, the last line
{"ok": true, "device": {...}}.  Without a CUDA card, or outside a
checkout of the repository, it fails before printing any result.

Usage: python3 chip_smoke.py
"""

import contextlib
import gzip
import hashlib
import json
import os
import re
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
GOLDEN = os.path.join(ROOT, "tests", "golden")
TOL = 0  # integer kernels: exact equality
SCALE_MB = 1000  # the hg38-size stand-in genome of the scale phase

# the kernels of the main path, by the wrapper that launches each
REPLACES = {
    "popcount_compare": "abismal_tpu/kernels/popcount_compare.py:34",
    # K2, at the fused programs' call sites and behind build_device_align
    # (banded_align.py:358)
    "banded_score_packed": "abismal_tpu/kernels/banded_align.py:44",
    "banded_trace_packed": "abismal_tpu/kernels/banded_align.py:99",
    # K4: not a Pallas kernel; the JAX core's fori_loop over bis_body
    # (pipeline.py:679-787: the search, the LCP window, the stop depth),
    # with the pool's lane ids, flags and scatter back (:523-806)
    "seed_extend": "abismal_tpu/map/pipeline.py:743",
    # K5, K6: not Pallas kernels; the JAX programs' associative_scan
    # carries: the SE slot ranks (:1296-1323; PE :1680-1697) and the
    # core's candidate list (:868-921)
    "segment_rank": "abismal_tpu/map/pipeline.py:1317",
    "candidate_list": "abismal_tpu/map/pipeline.py:889",
}
# the kernels phase's cases of each entry point
CASES = {
    "popcount_compare": ("popcount_compare",),
    "banded_score_packed": ("banded_score_packed", "banded_score_mixed",
                            "banded_score_pe", "banded_score_narrow"),
    "banded_trace_packed": ("banded_trace", "banded_trace_reads",
                            "banded_trace_packed",
                            "banded_trace_packed_2048"),
    "seed_extend": ("seed_extend_trex1", "seed_extend",
                    "seed_extend_1gb_512", "seed_extend_full_pool"),
    "segment_rank": ("segment_rank", "segment_rank_pe", "segment_rank_1gb"),
    "candidate_list": ("candidate_list_trex1", "candidate_list_pe",
                       "candidate_list"),
}
# Peak rates of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3, and
# 67 TFLOP/s of fp32 outside the tensor cores, which counts an FMA as two
# on 128 lanes per SM.  int32 has 64 lanes per SM and one op per lane and
# clock: a quarter of that figure.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4
# integer ops per table cell: and, select, add, max (diagonal), add, max
# (deletion), max, add (insertion); the tracer adds 3 compares and 3
# selects for the arrow
OPS_PER_CELL_SCORE = 8
OPS_PER_CELL_TRACE = 14
OPS_PER_WORD_COMPARE = 4  # funnel shift, and, popc, accumulate
NARROW_BANDS = (1, 3, 5, 9, 13, 21)  # 2 d + 1 for d <= 10: -m 0.1 at 100 b
# the bands recorded on the 10k golden reads: four in five at the cap 21
READ_BANDS = (21, 21, 21, 21, 3, 21, 21, 21, 21, 9, 21, 21, 21, 21, 13, 21,
              21, 21, 21, 1, 21, 21, 5)
READ_LENGTH = 100
PACKED_GENOME_WORDS = 1 << 26  # 256 MB of packed genome, beyond the L2
# K3's chain: cycles of one link, a table row or a walk step.  A row is
# two shuffles one after the other, each followed by an add-and-max and a
# select (~25 + 2 x 5 cycles each), and the ~60 integer instructions of
# its trip, which a warp alone on its scheduler issues one every second
# cycle (16 int32 lanes): 70-120.  A walk step is a shared-memory load
# (~30) and about ten dependent operations (~5 each); runs of M arrows are
# taken 32 rows at once, so the steps overcount the walk.  One round
# figure stands for both: an estimate, which nothing holds the kernel to.
K3_CHAIN_CYCLES = 100
# K4's chain: cycles of one dependent gather that misses the L1 (an index
# entry, or the genome words it names): about the device memory's latency.
# The longest live lane's links (k4_chain): the slot search's steps over
# cum_act, the setup's loads, two a round of the search (an index entry,
# then all its genome words), and the window's (its index entries, then
# its genome words, a link a batch of positions).  The earlier design's
# model (one trip a round, the lane body alone), 2 a trip and 2 a round
# of 32 window positions, stays beside it (it left out the compare's
# dependent word rounds).  A model, not a bound, and not measured
K4_GATHER_CYCLES = 800
# K4's earlier design alone on the card (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md's kernel table), by case: the lane body, without the lane ids
# and the scatter back that the kernel now also does
K4_LANE_BODY_US = {"seed_extend_trex1": 5.09, "seed_extend": 22.45,
              "seed_extend_1gb_512": 22.81}
K4_SEARCH = 128  # cum_act positions a step of the slot search (the kernel's)
OPS_PER_CLASS_WORD = 14  # funnel shift, 8 class ops, xor, mask, test, ...
EXT_POOL_STATIC = 512  # the core's pool where no engine sizes it, B = 2048
FULL_POOL_READS = 1024  # repeat-genome reads of the full-pool case: a chunk

SOURCES = {
    "popcount_compare": "abismal_tpu_torch/csrc/popcount_compare.cu",
    "banded_score_packed": "abismal_tpu_torch/csrc/banded_align.cu",
    "banded_trace_packed": "abismal_tpu_torch/csrc/banded_align.cu",
    "seed_extend": "abismal_tpu_torch/csrc/seed_extend.cu",
    "segment_rank": "abismal_tpu_torch/csrc/segment_rank.cu",
    "candidate_list": "abismal_tpu_torch/csrc/candidate_list.cu",
}
# the PyTorch call timed beside a kernel as its yardstick (never called by
# the port): the scan and the search that K5 and K6 took the place of
LIBRARY_CALL = {"segment_rank": "torch.cummax",
                "candidate_list": "torch.searchsorted"}
OPS_PER_RANK = 4  # ballot, popc, add, and the count's ballot and add
OPS_PER_SEARCH_STEP = 3  # shared load, compare, select


def wrappers(names=tuple(REPLACES)):
    """The kernel wrappers of the entry points named (every main-path one
    by default), in that order."""
    import importlib

    mods = {"popcount_compare": "popcount_compare",
            "banded_score_packed": "banded_align",
            "banded_trace_packed": "banded_align",
            "seed_extend": "seed_extend", "segment_rank": "segment_rank",
            "candidate_list": "candidate_list"}
    return tuple(getattr(importlib.import_module(
        f"abismal_tpu_torch.kernels.{mods[n]}"), n) for n in names)


_T0 = time.perf_counter()


def emit(phase, **kv):
    """One phase's JSON line, with the script's wall time so far."""
    print(json.dumps({"phase": phase, **kv,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Mean device time of fn over reps launches (CUDA events), warmed."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def in_turns(plain, kernel, reps_plain, reps_kernel):
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps_plain)
    k1 = cuda_ms(kernel, reps_kernel)
    k2 = cuda_ms(kernel, reps_kernel)
    p2 = cuda_ms(plain, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def graph_ms(fn, launches=20, reps=10):
    """Device time of one fn() (ms): `launches` calls captured into a CUDA
    graph and replayed, so no host time sits between the kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    return cuda_ms(g.replay, reps) / launches


def bound(nbytes, ops):
    """The least time (ms) the card could take, and which limit gives it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return dict(bytes=int(nbytes), ops=int(ops),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def live_cells(lq, bw, qsz):
    """Cells of the banded tables that hold a value: per row rr of job j,
    max(0, min(bw, qsz + QOFF - rr) - max(QOFF - rr, 0))."""
    import torch

    from abismal_tpu_torch.kernels.banded_align import QOFF

    rr = torch.arange(lq + QOFF, device=bw.device)[None, :]
    left = (QOFF - rr).clamp(min=0)
    right = torch.minimum(bw.reshape(-1, 1).long(),
                          qsz.reshape(-1, 1).long() + QOFF - rr)
    return int((right - left).clamp(min=0).sum().item())


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def max_abs_err(a, b):
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# --- phase 3 -------------------------------------------------------------------

def k1_inputs(rng, dev, B=2048, cand=64, nw_words=16, n_gw=1 << 20):
    import numpy as np
    import torch

    G = B * cand
    genome32 = rng.integers(0, 1 << 32, n_gw, dtype=np.uint64).astype(
        np.uint32)
    pos = rng.integers(0, 8 * n_gw + 512, G).astype(np.int64)
    pos[::5] &= ~7  # nibble shift 0
    pos[::97] = (1 << 32) - rng.integers(1, 4096, pos[::97].shape[0])
    pk = rng.integers(0, 1 << 32, (B, nw_words), dtype=np.uint64).astype(
        np.uint32)
    b_of = np.sort(rng.integers(0, B, G)).astype(np.int64)
    nw_of = 2 * rng.integers(1, nw_words // 2 + 1, G).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(genome32.view(np.int32)), t(pos), t(pk.view(np.int32)),
            t(b_of), t(nw_of))


def align_jobs(rng, n, lmax=128, n_pad=0, overflow=0,
               bands=(1, 5, 61, 3, 9, 21, 41), length=None):
    """Banded-alignment jobs over a random one-hot genome with IUPAC
    nibbles: (q (n, lmax) u8, win (n, lmax + QOFF) u8, bw, qsz, pos,
    genome (G,) u8 nibbles); job i takes band bands[i mod len(bands)] and
    a length drawn from 36 to lmax, or the one given."""
    import numpy as np

    from abismal_tpu_torch.kernels.banded_align import QOFF, win_start

    G = 400_000
    genome = (1 << rng.integers(0, 4, G)).astype(np.uint8)
    iup = rng.integers(0, G, G // 500)
    genome[iup] = rng.integers(1, 16, iup.shape[0])
    ww = lmax + QOFF
    q = np.zeros((n, lmax), np.uint8)
    win = np.zeros((n, ww), np.uint8)
    bw = np.ones(n, np.int32)
    qsz = np.zeros(n, np.int32)
    pos = np.zeros(n, np.int64)
    bws = np.array(bands)
    for i in range(n - n_pad):
        L = length or int(rng.integers(36, lmax + 1))
        p = int(rng.integers(200, G - 400))
        r = genome[p : p + L].copy()
        if i < overflow:  # an indel every 6 bases: > TB_NOPS cigar runs
            rl, k = [], 0
            while len(rl) < L:
                rl.extend(genome[p + k : p + k + 5])
                k += 5
                if len(rl) % 2:
                    rl.append(1 << int(rng.integers(0, 4)))
                else:
                    k += 1
            r = np.array(rl[:L], np.uint8)
            b = 61
        else:
            for _ in range(int(rng.integers(0, 8))):
                r[int(rng.integers(0, L))] = 1 << int(rng.integers(0, 4))
            rl = list(r)
            if rng.random() < 0.5:
                rl.insert(int(rng.integers(5, L - 5)),
                          1 << int(rng.integers(0, 4)))
            if rng.random() < 0.5:
                del rl[int(rng.integers(5, len(rl) - 5))]
            r = np.array(rl[:L], np.uint8)
            b = int(bws[i % bws.shape[0]])
        g0 = win_start(p, b)
        q[i, : r.shape[0]] = r
        win[i] = genome[g0 : g0 + ww]
        bw[i], qsz[i], pos[i] = b, r.shape[0], p
    return q, win, bw, qsz, pos, genome


def packed_jobs(dev, genome, q, bw, qsz, pos):
    """banded_score_packed's arguments for jobs given as query rows q over
    a genome of nibbles: the genome packed eight nibbles a word (64 zero
    guard words), the query rows two nibbles a byte, one unit row each."""
    import numpy as np
    import torch

    g = np.zeros(-(-genome.shape[0] // 8) * 8 + 64 * 8, np.uint32)
    g[: genome.shape[0]] = genome
    genome32 = (g.reshape(-1, 8) << (4 * np.arange(8, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32).view(np.int32)
    pnib = q[:, 0::2] | (q[:, 1::2] << np.uint8(4))
    unit = np.arange(q.shape[0], dtype=np.int64)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        genome32, pnib, unit, pos.astype(np.int64), bw.astype(np.int64),
        qsz.astype(np.int64))] + [q.shape[1]]


def k1_bound(genome32, pos, pk, b_of, nw_of):
    """K1's bytes and operations for these inputs: the distinct genome
    words the windows touch (inside the genome), the index and result
    arrays once, the read words of the units named, 4 ops per word."""
    import torch

    n_gw, nw_words = genome32.shape[0], pk.shape[1]
    w = ((pos & 0xFFFFFFFF) >> 3)[:, None] + torch.arange(
        nw_words + 1, device=pos.device)[None, :]
    # the last word of a window matters only under a nibble shift
    need = nw_of.long() + ((pos & 7) != 0).long()
    used = torch.arange(nw_words + 1, device=pos.device)[None, :] \
        < need[:, None]
    touched = torch.zeros(n_gw + 1, dtype=torch.bool, device=pos.device)
    touched[torch.where(used & (w < n_gw), w, n_gw)] = True
    n_words = int(touched[:n_gw].sum().item())
    n_units = int(torch.unique(b_of).numel())
    G = pos.shape[0]
    nbytes = 4 * n_words + nbytes_of(pos, b_of, nw_of) + 4 * G \
        + 4 * nw_words * n_units
    return bound(nbytes, OPS_PER_WORD_COMPARE * int(nw_of.sum().item()))


def random_genome32(dev, n_gw, seed):
    """(n_gw,) int32: a packed genome of one-hot nibbles, eight a word,
    made on the device in slices."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty(n_gw, dtype=torch.int32, device=dev)
    shifts = 4 * torch.arange(8, device=dev)
    step = 1 << 22
    for a in range(0, n_gw, step):
        n = min(step, n_gw - a)
        nib = 1 << torch.randint(0, 4, (n, 8), generator=gen, device=dev)
        w = (nib << shifts).sum(dim=1)
        out[a : a + n] = torch.where(w >= 1 << 31, w - (1 << 32), w).to(
            torch.int32)
    return out


def packed_trace_inputs(dev, R, n_gw, seed, lmax=128):
    """banded_trace_packed's arguments as build_stage12 makes them: R
    winners of READ_LENGTH bases copied from a packed genome of n_gw words
    with substitutions and indels, their packed query rows scattered over
    2 R unit rows, bands of READ_BANDS, one lane in ten untraced (bw 1,
    qsz 0, pos 0).  The first jobs sit where a window leaves the genome:
    before nibble 0 (its start wraps modulo 2^32 and reads 0) and across
    or past the last word."""
    import numpy as np
    import torch

    from abismal_tpu_torch.kernels.banded_align import window_nibbles

    rng = np.random.default_rng(seed)
    genome32 = random_genome32(dev, n_gw, seed)
    L, n_nib = READ_LENGTH, 8 * n_gw
    pos = rng.integers(200, n_nib - 400, R).astype(np.int64)
    pos[:8] = rng.integers(0, 45, 8)
    pos[8:16] = n_nib - rng.integers(20, 160, 8)
    pos[16:20] = n_nib + rng.integers(0, 4000, 4)
    ref = window_nibbles(genome32, torch.from_numpy(pos).to(dev),
                         L + 1).cpu().numpy()
    bw = np.array(READ_BANDS)[np.arange(R) % len(READ_BANDS)]
    U = (1 << rng.integers(0, 4, (2 * R, lmax + 32))).astype(np.uint8)
    wunit = rng.permutation(2 * R)[:R].astype(np.int64)
    for i in range(R):
        r = list(ref[i, :L])
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, L))] = 1 << int(rng.integers(0, 4))
        if rng.random() < 0.3:
            r.insert(int(rng.integers(5, L - 5)), 1 << int(rng.integers(0, 4)))
        if rng.random() < 0.3:
            del r[int(rng.integers(5, len(r) - 5))]
            r.append(ref[i, L])
        U[wunit[i]] = 0
        U[wunit[i], :L] = r[:L]
    pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
    do_tb = rng.random(R) < 0.9
    do_tb[:20] = True
    qsz = np.where(do_tb, L, 0).astype(np.int64)
    bw = np.where(do_tb, bw, 1).astype(np.int64)
    pos = np.where(do_tb, pos, 0)
    return [genome32] + [torch.from_numpy(a).to(dev) for a in (
        pnib, wunit, bw, qsz, pos, do_tb)] + [lmax]


def sm_clock_hz():
    """The card's highest SM clock, as nvidia-smi gives it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"], capture_output=True,
        text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def trace_chain(lq, bw, qsz, do_tb, ops, meta):
    """(rows, steps) of the job with the longest serial chain in a K3
    case: the table rows its band reaches plus the steps of its walk (the
    runs of its ops; its length where the op buffer overflowed)."""
    import torch

    from abismal_tpu_torch.kernels.banded_align import QOFF

    bw, qsz = bw.reshape(-1).long(), qsz.reshape(-1).long()
    live = (bw > 0) & (qsz > 0)
    rows = torch.where(live, qsz.clamp(max=lq) + QOFF
                       - (QOFF - bw + 1).clamp(min=0), 0)
    runs = (ops.long() >> 4).sum(dim=1)
    steps = torch.where(meta[:, 0] >= 0, runs,
                        torch.where(do_tb.reshape(-1).bool() & live, qsz, 0))
    j = int((rows + steps).argmax())
    return int(rows[j]), int(steps[j])


def kernel_cases(dev):
    """The kernels phase's cases, inputs made with numpy from fixed seeds:
    dicts of name, plain, kernel, args (tensors on dev), reps_plain, bound
    and extra facts for the report."""
    import numpy as np
    import torch

    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import popcount_compare as pc

    def on_card(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def score_case(name, args, reps_plain, **extra):
        """K2 on packed operands: bytes per job its four int64 and its
        score, and for a live job its packed query row and genome
        window."""
        genome32, pnib, unit, pos, bw, qsz, lmax = args
        J = unit.shape[0]
        live = (bw > 0) & (qsz > 0)
        nbytes = J * (4 * 8 + 4) + int(live.sum()) * (
            pnib.shape[1] + (lmax + ba.QOFF + 1) // 2)
        return dict(
            name=name, plain=ba.banded_score_packed_plain,
            kernel=ba.banded_score_packed, args=args, reps_plain=reps_plain,
            bound=bound(nbytes, OPS_PER_CELL_SCORE
                        * live_cells(lmax, bw, qsz)),
            extra=dict(shape=f"J={J}",
                       mean_band=float(bw[live].double().mean()), **extra))

    rng = np.random.default_rng(7)
    cases = []
    args = k1_inputs(rng, dev)
    cases.append(dict(
        name="popcount_compare", plain=pc.popcount_compare_plain,
        kernel=pc.popcount_compare, args=list(args), reps_plain=5,
        bound=k1_bound(*args), extra=dict(shape=f"G={args[1].shape[0]}")))

    # K2: the align_jcap jobs the device-align route gives one chunk, with
    # the bands of real reads, over a 256 MB genome (windows leave it too)
    t = packed_trace_inputs(dev, 8192, PACKED_GENOME_WORDS, 67)
    genome32, pnib, unit, bw, qsz, pos, _do_tb, lmax = t
    cases.append(score_case("banded_score_packed",
                            [genome32, pnib, unit, pos, bw, qsz, lmax], 3,
                            genome_bytes=4 * PACKED_GENOME_WORDS))

    q, _, bw, qsz, pos, genome = align_jobs(rng, 8192, n_pad=512)
    cases.append(score_case("banded_score_mixed",
                            packed_jobs(dev, genome, q, bw, qsz, pos), 3))

    # the paired-end program's shape: 8 jobs x 2048 units, negative bands
    # (IUPAC diffs are not remapped there) and fill rows (bw 1, qsz 0);
    # a seed of its own leaves the K3 inputs below as they were
    rng_pe = np.random.default_rng(17)
    q, _, bw, qsz, pos, genome = align_jobs(rng_pe, 16384, n_pad=1024)
    bw[3::7] = -(2 * rng_pe.integers(0, 30, bw[3::7].shape[0]) + 1)
    bw[5::11], qsz[5::11] = 1, 0
    cases.append(score_case("banded_score_pe",
                            packed_jobs(dev, genome, q, bw, qsz, pos), 2,
                            negative_bands=int((bw < 0).sum())))

    # the bands real reads give at the default -m 0.1 (seed of its own)
    q, _, bw, qsz, pos, genome = align_jobs(np.random.default_rng(27), 8192,
                                            n_pad=512, bands=NARROW_BANDS)
    cases.append(score_case("banded_score_narrow",
                            packed_jobs(dev, genome, q, bw, qsz, pos), 3))

    def trace_case(name, q, win, bw, qsz, pos, do_tb):
        t = on_card(q, win, bw, qsz, pos, do_tb)
        J2 = q.shape[0]
        return dict(
            name=name, plain=ba.banded_trace_plain, kernel=ba.banded_trace,
            args=t, reps_plain=2, lq=q.shape[1],
            bound=bound(nbytes_of(*t) + 4 * J2 * (ba.TB_NOPS + 4),
                        OPS_PER_CELL_TRACE
                        * live_cells(q.shape[1], t[2], t[3])),
            extra=dict(shape=f"J2={J2}", mean_band=float(bw[qsz > 0].mean())))

    q, win, bw, qsz, pos, _ = align_jobs(rng, 1024, n_pad=128, overflow=4)
    do_tb = rng.random(1024) < 0.9
    do_tb[:4] = True
    bw[~do_tb], qsz[~do_tb] = 1, 0
    cases.append(trace_case("banded_trace", q, win, bw, qsz, pos, do_tb))

    # the winners real reads give: 100 bases, bands of READ_BANDS
    rng_r = np.random.default_rng(37)
    q, win, bw, qsz, pos, _ = align_jobs(rng_r, 1024, bands=READ_BANDS,
                                         length=READ_LENGTH)
    do_tb = rng_r.random(1024) < 0.9
    bw[~do_tb], qsz[~do_tb] = 1, 0
    cases.append(trace_case("banded_trace_reads", q, win, bw, qsz, pos,
                            do_tb))

    # K3 on the caller's packed operands, one and two chunks of winners
    for name, R, seed in (("banded_trace_packed", 1024, 47),
                          ("banded_trace_packed_2048", 2048, 57)):
        t = packed_trace_inputs(dev, R, PACKED_GENOME_WORDS, seed)
        genome32, pnib, wunit, wbw, wqsz, wpos, do_tb, lmax = t
        traced = int((wqsz > 0).sum())
        # bytes: per job its four int64 and its flag, its output row, and
        # for a traced job its packed query row and genome window
        nbytes = R * (4 * 8 + 1 + 4 * (ba.TB_NOPS + 4)) + traced * (
            pnib.shape[1] + (lmax + ba.QOFF + 1) // 2)
        cases.append(dict(
            name=name, plain=ba.banded_trace_packed_plain,
            kernel=ba.banded_trace_packed, args=t, reps_plain=2, lq=lmax,
            bound=bound(nbytes, OPS_PER_CELL_TRACE
                        * live_cells(lmax, wbw, wqsz)),
            extra=dict(shape=f"R={R}", mean_band=float(
                wbw[wqsz > 0].double().mean()),
                       genome_bytes=4 * PACKED_GENOME_WORDS)))
    return cases


def k1_rotating_ms(dev, kernel, n_sets=16):
    """K1's device time per launch (ms) over n_sets input sets of the
    kernels phase's shape taken in turn (~7 MB each, together beyond the
    card's 50 MB of L2), so that every launch reads from device memory as
    the main path's gathers from a large genome do.  The plain graph time
    replays one set, which stays in L2."""
    import numpy as np

    sets = [k1_inputs(np.random.default_rng(100 + i), dev)
            for i in range(n_sets)]
    turn = iter(range(1 << 30))
    return graph_ms(lambda: kernel(*sets[next(turn) % n_sets]),
                    launches=2 * n_sets)


def outputs_equal(got, want):
    """Largest absolute difference over a kernel's outputs."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    return max(max_abs_err(g, w) for g, w in pairs)


def run_case(case, res):
    """Holds one kernel case against its plain version exactly, times both
    in turns and the kernel as a CUDA graph of its launches, and reads
    that time against the case's bound, into res[name]; returns the plain
    version's result."""
    import torch

    name, plain, kernel, args = (case[k] for k in ("name", "plain",
                                                   "kernel", "args"))
    want = plain(*args)
    got = kernel(*args)
    torch.cuda.synchronize()
    err = outputs_equal(got, want)
    check(err <= TOL, f"{name} differs from its plain version")
    host_ms, pms = in_turns(lambda: plain(*args), lambda: kernel(*args),
                            case["reps_plain"], 50)
    ms = graph_ms(lambda: kernel(*args))
    share = case["bound"]["bound_ms"] / ms
    check(share <= 1.05, f"{name}: share of bound {share:.2f} > 1.05, "
          "the bound is miscounted")
    res[name] = dict(max_abs_err=err, ms=ms, host_loop_ms=host_ms,
                     plain_ms=pms, share=share, **case["bound"],
                     **case["extra"])
    return want


def phase_kernels(dev):
    """Holds every kernel against its plain version exactly, times both,
    and reads the kernel's device time against its bound."""
    from abismal_tpu_torch.kernels import banded_align as ba

    clock = sm_clock_hz()
    res = {"tolerance": TOL, "peak_bytes_per_s": PEAK_BYTES_PER_S,
           "peak_int32_ops_per_s": PEAK_INT32_OPS_PER_S,
           "sm_clock_hz": clock, "k3_chain_cycles": K3_CHAIN_CYCLES}
    for case in kernel_cases(dev):
        name, kernel, args = case["name"], case["kernel"], case["args"]
        want = run_case(case, res)
        if name == "popcount_compare":
            res[name]["ms_rotating"] = k1_rotating_ms(dev, kernel)
        if name == "banded_score_pe":
            check(bool((want[args[4] < 0] == 0).all()),
                  "negative bands must score 0")
        if name.startswith("banded_trace"):
            # under one wave of warps no layout reaches the bound, which
            # counts operations at full occupancy.  chain_ms is a model,
            # not a measurement and not a bound: the longest job's rows
            # and walk steps at K3_CHAIN_CYCLES a link
            packed = kernel is ba.banded_trace_packed
            bw, qsz, do_tb = (args[3], args[4], args[6]) if packed \
                else (args[2], args[3], args[5])
            rows, steps = trace_chain(case["lq"], bw, qsz, do_tb, *want)
            res[name].update(
                chain_rows=rows, chain_steps=steps,
                chain_ms=(rows + steps) * K3_CHAIN_CYCLES / clock * 1e3,
                traced=int((want[1][:, 0] >= 0).sum()))
        if name == "banded_trace":
            n_over = int((want[1][:4, 0] == -1).sum())
            check(n_over > 0, "K3 inputs lack a TB_NOPS overflow job")
            res[name]["overflow_jobs"] = n_over
        if name == "banded_trace_packed":
            check(int((args[4] > 0).sum()) - res[name]["traced"] >= 8,
                  "K3 packed inputs lack windows that leave the genome")
    return res


# --- phase 7b (kernels_ext) ----------------------------------------------------

@contextlib.contextmanager
def recording(names):
    """Stands in for the programs' kernel entry points `names` (attributes
    of map/pipeline.py) until the block ends, recording the arguments of
    every call: yields {name: [args, ...]}; the wrappers run as ever."""
    from abismal_tpu_torch.map import pipeline

    seen = {n: [] for n in names}
    inner = {n: getattr(pipeline, n) for n in names}

    def stand_in(name):
        def call(*args):
            seen[name].append(list(args))
            return inner[name](*args)
        return call

    for n in names:
        setattr(pipeline, n, stand_in(n))
    try:
        yield seen
    finally:
        for n in names:
            setattr(pipeline, n, inner[n])


def ext_pool(dev, index, fq, threads, sizes=(None,)):
    """The arguments the candidate core hands K4 (seed_extend) on the first
    chunk (2048 units) of fq's reads, recorded from a fresh eager engine
    with the wrapper stood in for, one dispatch a pool size: None, the
    main path's (the engine sizes its pool from the oversized buckets of
    a sample of the index), or a number of lanes (ABISMAL_TPU_EXT_POOL
    during that dispatch).  A list of arguments per size, in order."""
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.tools import _workload as W

    eng = TorchNativeEngine(index, device=dev, n_threads=threads,
                            graphs=False)
    reads = W.load_reads(fq, eng.unit_batch // 2)
    env = os.environ.get("ABISMAL_TPU_EXT_POOL")
    try:
        with recording(("seed_extend",)) as seen:
            for size in sizes:
                os.environ.pop("ABISMAL_TPU_EXT_POOL", None)
                if size is not None:
                    os.environ["ABISMAL_TPU_EXT_POOL"] = str(size)
                batch_tensors(eng.dispatch_se(reads, False, False))
                check(len(seen["seed_extend"]) == 1 + sizes.index(size),
                      "the core did not call seed_extend once a chunk")
    finally:
        os.environ.pop("ABISMAL_TPU_EXT_POOL", None)
        if env is not None:
            os.environ["ABISMAL_TPU_EXT_POOL"] = env
        eng.close()
    return seen["seed_extend"]


def scan_args(dev, index, threads, fq1, fq2=None):
    """The arguments the programs hand K5 (segment_rank) and K6
    (candidate_list) on the first chunk (2048 units) of fq1's reads, or of
    the pairs of fq1 and fq2, recorded from a fresh eager engine with the
    wrappers stood in for: (K5's, K6's)."""
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.tools import _workload as W

    eng = TorchNativeEngine(index, device=dev, n_threads=threads,
                            graphs=False)
    try:
        with recording(("segment_rank", "candidate_list")) as seen:
            if fq2 is None:
                handle = eng.dispatch_se(
                    W.load_reads(fq1, eng.unit_batch // 2), False, False)
            else:
                n = eng.unit_batch // 4
                handle = eng.dispatch_pe(W.load_reads(fq1, n),
                                         W.load_reads(fq2, n), False, False)
            batch_tensors(handle)
        check(len(seen["segment_rank"]) == len(seen["candidate_list"]) == 1,
              "the programs did not call K5 and K6 once a chunk")
    finally:
        eng.close()
    return seen["segment_rank"][0], seen["candidate_list"][0]


def k5_case(name, args):
    """A K5 case on recorded arguments (gate, seg_start, seg_end[, ex]):
    bytes, each mask's byte and the int64 rank a candidate, the spans and
    counts; OPS_PER_RANK integer ops a candidate.  Its yardstick: one
    torch.cummax of an int64 vector of the candidates."""
    import torch

    from abismal_tpu_torch.kernels import segment_rank as sr

    gate, seg_start = args[0], args[1]
    n, n_seg = gate.shape[0], seg_start.shape[0]
    masks = len(args) - 2
    nbytes = n * (masks + 8) + 8 * n_seg * (2 + masks)
    vec = torch.arange(n, device=gate.device)
    return dict(
        name=name, plain=sr.segment_rank_plain, kernel=sr.segment_rank,
        args=args, reps_plain=5, bound=bound(nbytes, OPS_PER_RANK * n),
        library=lambda: torch.cummax(vec, dim=0),
        extra=dict(shape=f"n={n}, segments={n_seg}",
                   gated=int(gate.sum()),
                   tail=n - int(args[2][-1]),
                   longest_segment=int((args[2] - seg_start).max())))


def k6_case(name, args):
    """A K6 case on recorded arguments (cnt_cells, lo_cells, unit_start,
    unit_total, index_all, o_spec, gflat): bytes, the cell counts and the
    units' two words once, a bucket offset and an index entry a list
    candidate, and 33 bytes a list position written; ops, the scan of
    every cell and a binary search over a unit's cells a candidate.  Its
    yardstick: one torch.searchsorted of the list positions into the
    cells' starts."""
    import torch

    from abismal_tpu_torch.kernels import candidate_list as cl

    cnt, _lo, _us, unit_total, _idx, _o_spec, gflat = args
    B, n_cells = cnt.shape
    listed = min(int(unit_total.sum()), gflat)
    nbytes = 8 * cnt.numel() + 16 * B + 16 * listed + 33 * gflat
    steps = max(1, (n_cells - 1).bit_length())
    flat = cnt.reshape(-1)
    starts = torch.cumsum(flat, dim=0) - flat
    f = torch.arange(gflat, device=cnt.device)
    return dict(
        name=name, plain=cl.candidate_list_plain, kernel=cl.candidate_list,
        args=args, reps_plain=5,
        bound=bound(nbytes, OPS_PER_RANK * cnt.numel()
                    + OPS_PER_SEARCH_STEP * steps * listed),
        library=lambda: torch.searchsorted(starts, f, right=True),
        extra=dict(shape=f"B={B}, n_cells={n_cells}, gflat={gflat}",
                   candidates=int(unit_total.sum()), listed=listed))


def k4_traffic(args):
    """What K4 needs on args, counted from this run's data: (bytes, the
    integer operations of its compares, the longest lane's trips, probes,
    window positions, live lanes).  The plain version runs once with its
    compare (lex) recorded; the search is replayed from the recorded
    comparisons, so that only the probes of bounds still open count (the
    kernel's look-ahead probes more, which no bound counts).  Bytes: the
    cells' flags, counts and bucket bounds read and their six extended
    arrays and ext_fb written, each once; each live lane's own inputs, 8
    per index entry a probe or a valid window position reads, and the
    genome words each compare reads up to its first differing class word
    (two for the first)."""
    import torch

    from abismal_tpu_torch.kernels import seed_extend as se

    calls, inner = [], se.lex

    def rec(gcls, qcls, D, wj8):
        lcp, cmp = inner(gcls, qcls, D, wj8)
        calls.append((lcp, cmp, D))
        return lcp, cmp

    se.lex = rec
    try:
        se.seed_extend_plain(*args)
    finally:
        se.lex = inner
    (_g, _i, _p, _l, _ga, _b, s2, e2, s3, e3, flat_act, cum_act, pool, lmax,
     _mc, ways, kary_iters, ext_w, _ns) = args
    check(len(calls) == kary_iters + 1, "K4's plain version changed shape")
    lane_id = se.pool_lanes(flat_act, cum_act, pool)
    P = lane_id.shape[0]
    n_lanes = s2.numel()
    pvv = lane_id < 2 * n_lanes
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
    trips = torch.zeros_like(lane_id)
    aL, bL, aU, bU = lo0, hi0, lo0, hi0
    for lcp, cmp, D in calls[:kary_iters]:
        cL, cU = (aL < bL) & pvv, (aU < bU) & pvv
        trips += cL | cU
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
    n_live = int(pvv.sum())
    # a live lane's length, conversion, list base and bucket, its query's
    # nibbles (8 a class word, two a byte); the cells: a flag and a count
    # each, four bucket bounds and six extended values a (unit, offset),
    # ext_fb a unit
    per_lane = 8 + 1 + 8 + 16 + 4 * se.class_words(lmax)[1]
    cell_bytes = 2 * n_lanes * 9 + n_lanes * (32 + 48) + s2.shape[0]
    nbytes = (cell_bytes + n_live * per_lane + 8 * (probes + n_win)
              + 4 * gwords)
    return (nbytes, OPS_PER_CLASS_WORD * gwords, int(trips.max()), probes,
            n_win, n_live)


def k4_chain(args, trips):
    """The longest live lane's chain of dependent loads in the kernel's
    design, as links: (total, by part).  The slot search's steps over
    cum_act (replayed as the kernel takes them, for the last live slot),
    the setup (the cell's bucket, length and query, at once), two a round
    of the search (trips / the look-ahead depth, rounded up), and two a
    batch of the window's positions (their list entries, then their
    genome words).  It counts loads alone: the integer work between them,
    which the kernel's stamps showed to be most of a round, is left out."""
    from abismal_tpu_torch.kernels import seed_extend as se

    cum = args[11].cpu().tolist()
    pool, lmax, ways, ext_w = args[12], args[13], args[15], args[17]
    want, lo, hi, steps = min(cum[-1], pool), -1, len(cum) - 1, 0
    if not want:  # no live lane: an empty slot leaves after one load
        return 1, dict(slot_search=1)
    while hi - lo > 1:
        steps += 1
        span = hi - lo
        if span - 1 <= K4_SEARCH:
            break
        q = [lo + (i + 1) * span // (K4_SEARCH + 1) for i in range(K4_SEARCH)]
        f = next((i for i, x in enumerate(q) if x < hi and cum[x] >= want),
                 K4_SEARCH)
        hi, lo = (q[f] if f < K4_SEARCH else hi), (q[f - 1] if f else lo)
    nw = se.class_words(lmax)[1] + 1
    pb = 3 if nw <= 15 else (2 if nw <= 31 else 1)
    parts = dict(slot_search=steps, setup=1,
                 search=2 * -(-trips // se.lookahead_depth(ways)),
                 window=2 * -(-(-(-2 * ext_w // 32)) // pb))
    return sum(parts.values()), parts


def ext_cases(pools, clock):
    """The kernels_ext phase's K4 cases, one per recorded pool."""
    from abismal_tpu_torch.kernels import seed_extend as se

    cases = []
    for name, args in pools.items():
        nbytes, ops, trips, probes, n_win, live = k4_traffic(args)
        B, ways, ext_w = args[6].shape[0], args[15], args[17]
        links, parts = k4_chain(args, trips)
        old = 2 * trips + 2 * -(-2 * ext_w // 32)
        cases.append(dict(
            name=name, plain=se.seed_extend_plain, kernel=se.seed_extend,
            args=args, reps_plain=3, bound=bound(nbytes, ops),
            extra=dict(
                shape=f"P={args[12]}, B={B}", lanes=live,
                active_cells=int(args[11][-1]), ways=ways,
                kary_iters=args[16], lookahead=se.lookahead_depth(ways),
                longest_trips=trips, probes=probes, window_positions=n_win,
                chain_links=links, chain_parts=parts,
                chain_ms=links * K4_GATHER_CYCLES / clock * 1e3,
                chain_links_old=old,
                chain_ms_old=old * K4_GATHER_CYCLES / clock * 1e3,
                lane_body_us=K4_LANE_BODY_US.get(name))))
    return cases


def full_pool_args(dev, threads):
    """K4's arguments on a pool of EXT_POOL_STATIC slots, every one live:
    the first chunk of FULL_POOL_READS 100-base substrings of the repeat
    genome of abismal_tpu_torch/tools/debug_ext.py (tandem repeats: buckets
    far above max_candidates on most cells), recorded as ext_pool does
    with that pool size."""
    import numpy as np

    from abismal_tpu_torch.host import create_index
    from abismal_tpu_torch.tools.debug_ext import ext_genome

    fa = os.path.join(WORK, "ext_genome.fa")
    ext_genome(fa)
    with open(fa) as f:
        seq = "".join(ln.strip() for ln in f if not ln.startswith(">"))
    starts = np.random.default_rng(7).integers(0, len(seq) - 100,
                                               FULL_POOL_READS)
    fq = os.path.join(WORK, "ext_genome_reads.fq")
    with open(fq, "w") as f:
        for i, s0 in enumerate(starts):
            f.write(f"@r{i}\n{seq[s0 : s0 + 100].upper()}\n+\n"
                    + "I" * 100 + "\n")
    index = create_index(fa, n_threads=threads)
    (args,) = ext_pool(dev, index, fq, threads, (EXT_POOL_STATIC,))
    check(args[12] == EXT_POOL_STATIC
          and int(args[11][-1]) > EXT_POOL_STATIC,
          "the full-pool case's pool is not full")
    return args


def phase_kernels_ext(dev, threads, trex, sets):
    """Phase 7b: K4 against its plain version on the card on the pools
    that the first chunk of the 10k golden reads and of the 1 Gb SE set
    hand it (see ext_pool), on the 1 Gb chunk's pool at the core's
    static size (512 lanes: max(512, units / 4)), and on a pool of that
    size with every slot live (full_pool_args); K5 and K6 on what the
    programs hand them on the first chunk of the 10k golden reads, of the
    10k golden pairs and of the 1 Gb SE set (see scan_args); each timed
    and read against its bound as in the kernels phase, and K5 and K6
    beside the PyTorch call that their kernels took the place of
    (LIBRARY_CALL), timed alone on the same sizes as a graph of 20."""
    clock = sm_clock_hz()
    (trex1,) = ext_pool(dev, trex, golden_fastqs("reads")[0], threads)
    g1, g1_512 = ext_pool(dev, sets["index"], sets["se"][0], threads,
                          (None, EXT_POOL_STATIC))
    pools = {"seed_extend_trex1": trex1, "seed_extend": g1,
             "seed_extend_1gb_512": g1_512,
             "seed_extend_full_pool": full_pool_args(dev, threads)}
    res = {"tolerance": TOL, "sm_clock_hz": clock,
           "k4_gather_cycles": K4_GATHER_CYCLES,
           "library_call": LIBRARY_CALL}
    for case in ext_cases(pools, clock):
        run_case(case, res)
    cases = []
    for (n5, n6), (index, fq1, fq2) in (
            (("segment_rank", "candidate_list_trex1"),
             (trex, golden_fastqs("reads")[0], None)),
            (("segment_rank_pe", "candidate_list_pe"),
             (trex, *golden_fastqs("reads_pe"))),
            (("segment_rank_1gb", "candidate_list"),
             (sets["index"], sets["se"][0], None))):
        a5, a6 = scan_args(dev, index, threads, fq1, fq2)
        cases += [k5_case(n5, a5), k6_case(n6, a6)]
    for case in cases:
        run_case(case, res)
        res[case["name"]]["library_ms"] = graph_ms(case["library"])
    return res


# --- phase 4/5 helpers -------------------------------------------------------

def gunzip_to(name, dst_dir):
    out = os.path.join(dst_dir, name)
    if not os.path.exists(out):
        with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rb") as f:
            data = f.read()
        with open(out + ".tmp", "wb") as g:
            g.write(data)
        os.replace(out + ".tmp", out)
    return out


def golden_identical(prefix, sam, mstats):
    """(SAM identical, mstats identical) to tests/golden/<prefix>.*."""
    same = []
    for path, ext in ((sam, ".sam.gz"), (mstats, ".mstats.gz")):
        with gzip.open(os.path.join(GOLDEN, prefix + ext), "rb") as f:
            same.append(open(path, "rb").read() == f.read())
    return same


def sam_body(sam):
    """A SAM's lines but the @PG line, which records the run's argv."""
    return [ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG")]


def md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def trex1_index(threads):
    from abismal_tpu_torch.host import create_index, read_index, write_index

    cached = os.path.join(WORK, "tRex1.idx")
    want = open(os.path.join(GOLDEN, "tRex1.idx.md5")).read().strip()
    if os.path.exists(cached) and md5(cached) == want:
        return read_index(cached), "cached"
    idx = create_index(os.path.join(ROOT, "tests", "data", "tRex1.fa"),
                       n_threads=threads)
    write_index(idx, cached)
    check(md5(cached) == want, "tRex1 index not byte-identical")
    return idx, "built"


def chunk_device_ms(eng, first, last="traceback_ms"):
    """Per-chunk device times (ms) between the program's phase marks; the
    last interval is the SE traceback (winner selection and records
    included; trace_only_ms is what follows them, K3 and its few
    operands) or the PE mating sweep (mate_ms).  A graphed engine marks
    a chunk's replay (or a key's warm run) alone: total_ms only."""
    import numpy as np

    from abismal_tpu_torch.graphs import Graphs

    if isinstance(eng.graphs, Graphs):
        spans = [dict(m)["start"].elapsed_time(dict(m)["end"])
                 for m in eng.chunk_marks[first:]]
        return ({"total_ms": float(np.mean(spans)), "chunks": len(spans),
                 "graphed": True} if spans else {})
    rows = []
    for marks in eng.chunk_marks[first:]:
        ev = dict(marks)
        rows.append([ev["start"].elapsed_time(ev["core"]),
                     ev["core"].elapsed_time(ev["decide"]),
                     ev["decide"].elapsed_time(ev["score"]),
                     ev["score"].elapsed_time(ev["end"]),
                     ev["start"].elapsed_time(ev["end"]),
                     ev["select"].elapsed_time(ev["end"])
                     if "select" in ev else 0.0])
    if not rows:
        return {}
    m = np.mean(np.array(rows), axis=0)
    out = {"core_ms": m[0], "decide_ms": m[1], "score_ms": m[2], last: m[3],
           "total_ms": m[4], "chunks": len(rows)}
    if "select" in dict(eng.chunk_marks[-1]):
        out["trace_only_ms"] = m[5]
    return out


def map_with(engine_factory, index, fq, sam, mstats, cl, threads, fq2=None,
             **kw):
    from abismal_tpu_torch.host import run_map

    t0 = time.perf_counter()
    run_map(index, fq, fq2, sam, mstats, cl, engine_factory=engine_factory,
            threads=threads, **kw)
    return time.perf_counter() - t0


def n_reads_of(fq):
    with open(fq, "rb") as f:
        return sum(1 for _ in f) // 4


def port_map(factory, index, fq, sam, mstats, cl, threads, fq2=None, **kw):
    """Maps fq (and, paired, fq2) with the port engine; returns a stats
    dict (rates are reads/s, or pairs/s when paired; the fallback
    fraction counts device units)."""
    eng = factory(index, kw.get("allow_ambig", False), 0.1, 32, 3000)
    eng.profile = True
    u0, f0, c0 = eng.n_units, eng.n_fallback, len(eng.chunk_marks)
    eng.tracer.reset()
    eng.tracer.on = True
    try:
        secs = map_with(factory, index, fq, sam, mstats, cl, threads, fq2,
                        **kw)
    finally:
        eng.tracer.on = False
    n = n_reads_of(fq)
    du = eng.n_units - u0
    unit = "pairs" if fq2 else "reads"
    st = {unit: n, "seconds": secs, f"{unit}_per_s": n / secs,
          "fallback_frac": (eng.n_fallback - f0) / max(1, du),
          "host_s": {p: t for p, (_, t, _s)
                     in eng.tracer.summary()["spans"].items()}}
    st.update(chunk_device_ms(eng, c0, "mate_ms" if fq2 else "traceback_ms"))
    return st


def eager_engine(dev, index, **kw):
    """A run_map factory of one TorchNativeEngine with graphs=False, the
    eager programs, held by the factory alone (not memoized)."""
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.tools._workload import engine_factory

    return engine_factory(TorchNativeEngine(index, device=dev, graphs=False,
                                            **kw))


class BandRecorder:
    """Stands in for the pipeline's K2 entry point `name`
    (banded_score_packed) while a run is mapped and counts the bands of
    its live jobs (qsz > 0, the last two arguments but for lmax); bands
    below 0 count at -1.  The kernel's wrapper runs as ever."""

    def __init__(self, pipeline, name):
        self.pipeline, self.name = pipeline, name
        self.inner = getattr(pipeline, name)
        self.hist = None  # on the device, added to without a sync

    def __call__(self, *args):
        import torch

        bw, qsz = [a for a in args if torch.is_tensor(a)][-2:]
        if self.hist is None:
            self.hist = torch.zeros(66, dtype=torch.int64, device=bw.device)
        self.hist.scatter_add_(0, bw.reshape(-1).long().clamp(-1, 64) + 1,
                               (qsz.reshape(-1) > 0).long())
        return self.inner(*args)

    def __enter__(self):
        setattr(self.pipeline, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.pipeline, self.name, self.inner)

    def summary(self):
        import numpy as np

        check(self.hist is not None, "K2 was not called")
        h = self.hist.cpu().numpy()
        bands = np.repeat(np.arange(-1, 65), h)
        check(bands.size > 0, "no live K2 job was recorded")
        return dict(jobs=int(bands.size),
                    hist={int(b): int(n) for b, n in zip(range(-1, 65), h)
                          if n},
                    quartiles=[int(x) for x in np.percentile(
                        bands, [0, 25, 50, 75, 100])],
                    share_at_most_16=float((bands <= 16).mean()),
                    share_at_most_32=float((bands <= 32).mean()))


def phase_goldens(dev, threads):
    import torch

    from abismal_tpu_torch.host import make_native_engine_factory
    from abismal_tpu_torch.map import pipeline
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    t0 = time.perf_counter()
    index, how = trex1_index(threads)
    t_index = time.perf_counter() - t0
    factory = make_torch_native_engine_factory(dev, n_threads=threads)
    eng = factory(index, False, 0.1, 32, 3000)
    eng.profile = True
    out = {"index": how, "index_s": t_index}
    kernels = wrappers()
    for k in kernels:
        k.launches = 0
    for prefix in ("small", "reads"):
        fq = gunzip_to(f"{prefix}_1.fq", WORK)
        sam = os.path.join(WORK, f"{prefix}.sam")
        mst = os.path.join(WORK, f"{prefix}.mstats")
        cl = (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
              f"-i tests/tRex1.idx tests/{prefix}_1.fq")
        st = port_map(factory, index, fq, sam, mst, cl, threads)
        sam_ok, mst_ok = golden_identical(prefix, sam, mst)
        st.update(sam_identical=sam_ok, mstats_identical=mst_ok)
        out[prefix] = st
        check(sam_ok and mst_ok, f"{prefix}: output differs from the golden")
    launches = {k.__name__: k.launches for k in kernels}
    out["launches"] = launches
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    # the bands K2 gets on `reads`, from a run of its own on the eager
    # programs (a graph replays what it captured, without the recorder):
    # the recorder adds a scatter per chunk, which the timed runs above do
    # not carry
    fq = os.path.join(WORK, "reads_1.fq")
    with BandRecorder(pipeline, "banded_score_packed") as rec:
        map_with(eager_engine(dev, index, n_threads=threads), index, fq,
                 os.path.join(WORK, "bands.sam"), None, "bands", threads)
    out["k2_bands_reads"] = rec.summary()
    # the native engine on the same host, same reads, for scale
    secs = map_with(make_native_engine_factory(n_threads=threads), index, fq,
                    os.path.join(WORK, "native.sam"), None, "native", threads)
    out["native_reads_per_s"] = n_reads_of(fq) / secs
    out["table_bytes"] = eng.dev.nbytes()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out, launches, index


PE_GOLDENS = (("small_pe", False), ("small_pbat_pe", True),
              ("small_rpbat_pe", True), ("reads_pe", False),
              ("reads_pbat_pe", True), ("reads_rpbat_pe", True))


def phase_goldens_pe(dev, threads, index):
    """The paired-end goldens through the port (the rpbat goldens were
    mapped with -P, tests/golden/MANIFEST.md), then -a with random PBAT
    against the native engine."""
    from abismal_tpu_torch.host import make_native_engine_factory
    from abismal_tpu_torch.map import pipeline
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    factory = make_torch_native_engine_factory(dev, n_threads=threads)
    native = make_native_engine_factory(n_threads=threads)
    out = {}
    kernels = wrappers(("popcount_compare", "banded_score_packed",
                        "seed_extend", "segment_rank", "candidate_list"))
    for k in kernels:
        k.launches = 0
    for prefix, pbat in PE_GOLDENS:
        fq1 = gunzip_to(f"{prefix}_1.fq", WORK)
        fq2 = gunzip_to(f"{prefix}_2.fq", WORK)
        sam = os.path.join(WORK, f"{prefix}.sam")
        mst = os.path.join(WORK, f"{prefix}.mstats")
        flag = "-P " if pbat else ""
        cl = (f"map {flag}-s tests/{prefix}.mstats -o tests/{prefix}.sam "
              f"-i tests/tRex1.idx tests/{prefix}_1.fq tests/{prefix}_2.fq")
        st = port_map(factory, index, fq1, sam, mst, cl, threads, fq2,
                      pbat=pbat)
        sam_ok, mst_ok = golden_identical(prefix, sam, mst)
        st.update(sam_identical=sam_ok, mstats_identical=mst_ok)
        check(sam_ok and mst_ok, f"{prefix}: output differs from the golden")
        if prefix.startswith("reads"):
            secs = map_with(native, index, fq1,
                            os.path.join(WORK, "native_pe.sam"), None,
                            "native", threads, fq2, pbat=pbat)
            st["native_pairs_per_s"] = n_reads_of(fq1) / secs
        out[prefix] = st
    launches = {k.__name__: k.launches for k in kernels}
    out["launches"] = launches
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the paired-end path")
    # the bands of `reads_pe`, recorded outside the timed runs (eager)
    fq1, fq2 = (os.path.join(WORK, f"reads_pe_{e}.fq") for e in (1, 2))
    with BandRecorder(pipeline, "banded_score_packed") as rec:
        map_with(eager_engine(dev, index, n_threads=threads), index, fq1,
                 os.path.join(WORK, "bands_pe.sam"), None, "bands", threads,
                 fq2)
    out["k2_bands_reads_pe"] = rec.summary()

    # -a: ambiguous pairs are reported, and the device sweep decides them
    fq1, fq2 = (os.path.join(WORK, f"small_rpbat_pe_{e}.fq") for e in (1, 2))
    kw = dict(allow_ambig=True, random_pbat=True)
    res = []
    for i, fac in enumerate((factory, native)):
        sam = os.path.join(WORK, f"ambig{i}.sam")
        mst = os.path.join(WORK, f"ambig{i}.mstats")
        map_with(fac, index, fq1, sam, mst, "map -a -R", threads, fq2, **kw)
        res.append((open(sam, "rb").read(), open(mst, "rb").read()))
    mated = factory(index, True, 0.1, 32, 3000).n_device_mated
    out["ambig_rpbat"] = dict(identical_to_native=res[0] == res[1],
                              n_device_mated=mated)
    check(res[0] == res[1], "-a random PBAT: port differs from native")
    check(mated > 0, "-a: no pair was mated on the device")
    return out, launches


def phase_events(dev, threads, index):
    """The event-stream route (device_stage2=False) on the goldens, without
    and with device_align: SAM and mstats byte for byte; K1 launches in
    both, banded_score_packed in the align runs alone, K4 and K6 in both
    (build_stage1 has no slot ranks: no K5)."""
    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import popcount_compare as pc
    from abismal_tpu_torch.kernels.candidate_list import candidate_list
    from abismal_tpu_torch.kernels.seed_extend import seed_extend
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    out = {}
    launches = {"popcount_compare": 0, "banded_score_packed": 0,
                "seed_extend": 0, "candidate_list": 0}
    for align in (False, True):
        factory = make_torch_native_engine_factory(
            dev, n_threads=threads, device_stage2=False, device_align=align)
        eng = factory(index, False, 0.1, 32, 3000)
        for k in (pc.popcount_compare, ba.banded_score_packed, seed_extend,
                  candidate_list):
            k.launches = 0
        for prefix, pbat in (("small", False), ("reads", False))+PE_GOLDENS:
            fq1, fq2 = golden_fastqs(prefix)
            sam = os.path.join(WORK, f"events_{prefix}.sam")
            mst = os.path.join(WORK, f"events_{prefix}.mstats")
            flag = "-P " if pbat else ""
            a0 = eng.n_device_aligned
            st = port_map(factory, index, fq1, sam, mst,
                          golden_cl(prefix, flag), threads, fq2, pbat=pbat)
            sam_ok, mst_ok = golden_identical(prefix, sam, mst)
            st.update(sam_identical=sam_ok, mstats_identical=mst_ok,
                      n_device_aligned=eng.n_device_aligned - a0)
            check(sam_ok and mst_ok, f"events {prefix} (device_align "
                  f"{align}): output differs from the golden")
            out[f"{prefix}{'_align' if align else ''}"] = st
        for k in (pc.popcount_compare, seed_extend, candidate_list):
            check(k.launches > 0,
                  f"{k.__name__} was not launched on the event route")
        moved = ba.banded_score_packed.launches
        check(moved > 0 if align else moved == 0,
              f"banded_score_packed launched {moved} times with "
              f"device_align {align}")
        launches["popcount_compare"] += pc.popcount_compare.launches
        launches["banded_score_packed"] += moved
        launches["seed_extend"] += seed_extend.launches
        launches["candidate_list"] += candidate_list.launches
    out["launches"] = launches
    # the CLI on the card, as a user runs the route: ABISMAL_TPU_STAGE2=0
    # and --device-align, on small; the golden SAM but for the @PG line
    sam = os.path.join(WORK, "events_cli.sam")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "abismal_tpu_torch", "map", "--device-align",
         "-o", sam, "-i", os.path.join(WORK, "tRex1.idx"),
         gunzip_to("small_1.fq", WORK)], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, ABISMAL_TPU_STAGE2="0"))
    check(res.returncode == 0, f"map --device-align: {res.stderr[-2000:]}")
    with gzip.open(os.path.join(GOLDEN, "small.sam.gz"), "rb") as f:
        same = sam_body(open(sam, "rb").read()) == sam_body(f.read())
    check(same, "map --device-align (ABISMAL_TPU_STAGE2=0): the SAM "
          "differs from the golden")
    out["cli_device_align_small"] = dict(
        seconds=time.perf_counter() - t0, sam_identical_but_pg=same)
    return out, launches


def phase_scale(dev, threads):
    import torch

    from abismal_tpu_torch.device import card_info
    from abismal_tpu_torch.host import (
        SimConfig, create_index, make_native_engine_factory, simulate_reads,
    )
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory
    from abismal_tpu_torch.tools._workload import gen_genome

    size = SCALE_MB * 1_000_000
    fa = os.path.join(WORK, f"scale_{size}.fa")
    t0 = time.perf_counter()
    if not os.path.exists(fa):
        gen_genome(fa, size)
    t1 = time.perf_counter()
    index = create_index(fa, n_threads=threads)
    t2 = time.perf_counter()
    pre = os.path.join(WORK, f"scale_{size}_r")
    simulate_reads(fa, SimConfig(output_prefix=pre, n_reads=20000,
                                 mutation_rate=0.01, bs_conv=0.98, seed=1,
                                 single_end=True))
    fq = pre + "_1.fq"
    t3 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    factory = make_torch_native_engine_factory(dev, n_threads=threads)
    eng = factory(index, False, 0.1, 32, 3000)
    eng.profile = True
    sam_t = os.path.join(WORK, "scale_port.sam")
    sam_n = os.path.join(WORK, "scale_native.sam")
    st = port_map(factory, index, fq, sam_t, None, "scale", threads)
    st_warm = port_map(factory, index, fq, sam_t, None, "scale", threads)
    secs_n = map_with(make_native_engine_factory(n_threads=threads), index,
                      fq, sam_n, None, "scale", threads)
    same = open(sam_t, "rb").read() == open(sam_n, "rb").read()
    check(same, "scale: port SAM differs from the native engine's")
    # the event-stream route with device_align on the same reads
    fac_ev = make_torch_native_engine_factory(
        dev, n_threads=threads, device_stage2=False, device_align=True)
    eng_ev = fac_ev(index, False, 0.1, 32, 3000)
    sam_e = os.path.join(WORK, "scale_events.sam")
    events = {}
    for run in ("first", "warm"):
        a0 = eng_ev.n_device_aligned
        events[run] = port_map(fac_ev, index, fq, sam_e, None, "scale",
                               threads)
        events[run]["n_device_aligned"] = eng_ev.n_device_aligned - a0
        check(open(sam_e, "rb").read() == open(sam_n, "rb").read(),
              f"scale events ({run}): SAM differs from the native engine's")
        check(events[run]["n_device_aligned"] > 0,
              "scale events: no job was scored on the device")
    events.update(sam_identical=True, native_reads_per_s=20000 / secs_n,
                  card=card_info())

    # the same genome and index, 20k pairs at the goldens' parameters
    t4 = time.perf_counter()
    pre_pe = os.path.join(WORK, f"scale_{size}_pe")
    simulate_reads(fa, SimConfig(output_prefix=pre_pe, n_reads=20000,
                                 mutation_rate=0.01, bs_conv=0.98, seed=1,
                                 single_end=False))
    fq1, fq2 = pre_pe + "_1.fq", pre_pe + "_2.fq"
    t5 = time.perf_counter()
    pe = dict(sim_s=t5 - t4)
    pe["first"] = port_map(factory, index, fq1, sam_t, None, "scale_pe",
                           threads, fq2)
    pe["warm"] = port_map(factory, index, fq1, sam_t, None, "scale_pe",
                          threads, fq2)
    sam_n_pe = os.path.join(WORK, "scale_native_pe.sam")
    secs_pe = map_with(make_native_engine_factory(n_threads=threads), index,
                       fq1, sam_n_pe, None, "scale_pe", threads, fq2)
    pe["native_pairs_per_s"] = 20000 / secs_pe
    pe["sam_identical"] = (open(sam_t, "rb").read()
                           == open(sam_n_pe, "rb").read())
    check(pe["sam_identical"], "scale PE: port SAM differs from native's")
    res = dict(genome_mb=SCALE_MB, gen_s=t1 - t0, index_s=t2 - t1,
               sim_s=t3 - t2, first=st, warm=st_warm,
               native_reads_per_s=20000 / secs_n, sam_identical=same, pe=pe,
               events_align=events,
               cand_budget=eng.cand_budget,
               ext_pool=eng._informed_ext_pool(),
               table_bytes=eng.dev.nbytes(),
               max_memory_allocated=torch.cuda.max_memory_allocated())
    # what the scaleout phase maps again: the sets, the native SAMs and
    # this call's port-only and native-only rates
    sets = dict(index=index, se=(fq, None, sam_n, "scale"),
                pe=(fq1, fq2, sam_n_pe, "scale_pe"),
                rates={"se": (st_warm["reads_per_s"], 20000 / secs_n),
                       "pe": (pe["warm"]["pairs_per_s"],
                              pe["native_pairs_per_s"])})
    return res, sets


# --- phase 8 (profile) ------------------------------------------------------

PROFILE_REPS = 10  # executions a cut is timed over, after a warm one
PROFILE_CHUNK_READS = 1024  # a chunk: 2048 units of single-end reads


def fallback_flags(rows, chunk):
    """Per read of chunk: the uncut program's REC_FALLBACK status."""
    from abismal_tpu_torch.map.host_units import REC_FALLBACK

    R = chunk.n_units // chunk.per
    return (rows[:R, 0] & 7) == REC_FALLBACK


def fbstats_causes(fbs, chunk):
    """Per read of chunk: the fallback that the "fbstats" columns decide,
    the causes unit_fb, heap_fb, job_fb, bw_over and ex_over_fb (columns
    0, 2, 3, 4, 5), or reads of 0 < length < DEVICE_MIN_LEN.  The other
    three columns (heap_would_fill, before the sure-ambig refinement that
    gives heap_fb, and the exact-match state has_ex and ex_ambig) are
    context, not causes."""
    from abismal_tpu_torch.map.host_units import DEVICE_MIN_LEN

    R = chunk.n_units // chunk.per
    rlen = chunk.args[1].reshape(-1, chunk.per).max(axis=1)[:R]
    return (fbs[:R][:, [0, 2, 3, 4, 5]].any(axis=1)
            | ((rlen > 0) & (rlen < DEVICE_MIN_LEN)))


def phase_profile(dev, threads, card, trex, sets):
    """The profiling and diagnostic cuts on the card through the port's
    tools: the single-end and paired-end cut bisections (profile_stage12,
    profile_stage12pe) on the first 2048-unit chunk of the 10k golden reads
    and pairs; "fbstats" on every chunk of the 10k reads, its causes equal
    to the uncut program's fallback flags; a cut program run with phase
    marks on; "unitstats" and the single-end bisection on the 1 Gb SE set
    with the scale phase's tables; trace_ops' top 10 CUDA kernels of a
    tRex1 chunk.  K1-K6 must launch in the phase."""
    import numpy as np

    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory
    from abismal_tpu_torch.tools import _workload as W
    from abismal_tpu_torch.tools import profile_stage12, profile_stage12pe
    from abismal_tpu_torch.tools import trace_ops
    from abismal_tpu_torch.tools.scale_device import unit_stats

    def quiet(*_args):
        pass

    kernels = wrappers()
    for k in kernels:
        k.launches = 0
    factory = make_torch_native_engine_factory(dev, n_threads=threads)
    eng = factory(trex, False, 0.1, 32, 3000)  # the goldens' engine
    out = dict(card=card, reps=PROFILE_REPS, unit_batch=eng.unit_batch)
    reads = W.load_reads(golden_fastqs("reads")[0], 10**6)
    se = W.se_chunk(eng, reads[:PROFILE_CHUNK_READS])
    out["se_cuts"] = profile_stage12.bisect(
        eng, se, profile_stage12.CUTS, PROFILE_REPS, out=quiet)
    fq1, fq2 = golden_fastqs("reads_pe")
    n_pairs = eng.unit_batch // 4
    pe = W.pe_chunk(eng, W.load_reads(fq1, n_pairs),
                    W.load_reads(fq2, n_pairs))
    out["pe_cuts"] = profile_stage12pe.bisect(
        eng, pe, profile_stage12pe.CUTS, PROFILE_REPS, paired=True,
        out=quiet)

    # a cut with the phase marks on: the marks past it are absent
    for chunk, cut, paired, want in ((se, "decide", False, ["start", "core"]),
                                     (pe, "pescore", True, ["start", "core",
                                                            "decide"])):
        marks = []
        W.stage12_prog(eng, chunk, cut, paired)(
            *eng.dev.tables(), *chunk.on(eng), marks=marks)
        check([m for m, _ in marks] == want, f"{cut}: marks {marks}")

    # fbstats chunk by chunk against the uncut program's fallback flags
    n_fb = n_reads = 0
    for r0 in range(0, len(reads), PROFILE_CHUNK_READS):
        chunk = W.se_chunk(eng, reads[r0 : r0 + PROFILE_CHUNK_READS])
        args, tables = chunk.on(eng), eng.dev.tables()
        fbs = W.stage12_prog(eng, chunk, "fbstats")(*tables, *args)
        rows = W.stage12_prog(eng, chunk)(*tables, *args)
        flags = fallback_flags(rows.cpu().numpy(), chunk)
        check(np.array_equal(fbstats_causes(fbs.cpu().numpy(), chunk), flags),
              f"fbstats: chunk at read {r0} disagrees with the fallback "
              "flags of the uncut program")
        n_fb += int(flags.sum())
        n_reads += flags.shape[0]
    out["fbstats_10k"] = dict(chunks=-(-len(reads) // PROFILE_CHUNK_READS),
                              reads=n_reads, fallback_reads=n_fb,
                              causes_equal_flags=True)

    # unitstats at 1 Gb, on the tables the scale phase left on the card
    eng_g = factory(sets["index"], False, 0.1, 32, 3000)
    g = W.se_chunk(eng_g, W.load_reads(sets["se"][0], PROFILE_CHUNK_READS))
    out["unitstats_1gb"] = dict(
        auto_budget=unit_stats(eng_g, g),
        engine_budget=dict(unit_stats(eng_g, g, g.budget),
                           cand_budget=g.budget))
    out["se_cuts_1gb"] = profile_stage12.bisect(
        eng_g, g, profile_stage12.CUTS, PROFILE_REPS, out=quiet)
    # the seed extension's depth: its 4-way search takes ceil(ext_iters /
    # 2) + 1 rounds
    out["ext_iters"] = dict(trex1=eng.dev.ext_iters, g1=eng_g.dev.ext_iters)
    tr = trace_ops.run(eng, se, reps=5, top_n=10, out=quiet)
    out["trace_ops"] = dict(steady_ms=tr["steady_ms"],
                            kernel_us_per_exec=tr["total_us_per_exec"],
                            top10=tr["top"])
    out["launches"] = launches_moved(kernels, "profile")
    return out, out["launches"]


# --- phase 9 -------------------------------------------------------------------

SHARD_GOLDENS = ("small", "reads", "small_pe", "reads_pe")
REPLAY_GOLDENS = ("small", "small_pe")


def phase_shards_replay(dev, threads, card, trex, sets, rates):
    """The key-range-sharded index and the replay engines on the card:
    --index-shards over two slots of dev (and over every card, given two)
    on the goldens and on the 1 Gb SE set against the native engine's
    SAM; TorchMappingEngine (torch-replay) on the small goldens, in this
    process and through run_map_hybrid's three forked workers.  K1's
    counter must move in every run, K4's and K6's in the phase (these
    routes run build_stage1: no K5); every rate stands beside this call's
    native rate on the same reads."""
    import torch

    from abismal_tpu_torch.host import make_native_engine_factory
    from abismal_tpu_torch.kernels import popcount_compare as pc
    from abismal_tpu_torch.kernels.candidate_list import candidate_list
    from abismal_tpu_torch.kernels.seed_extend import seed_extend
    from abismal_tpu_torch.map.pipeline import (
        make_torch_engine_factory, make_torch_native_engine_factory,
    )

    k1 = pc.popcount_compare
    native = make_native_engine_factory(n_threads=threads)
    out = {"card": card}
    n_k1 = 0

    def native_rate(prefix):
        """This call's native rate on a golden set (reads/s or pairs/s)."""
        if prefix not in rates:
            fq1, fq2 = golden_fastqs(prefix)
            secs = map_with(native, trex, fq1, os.path.join(
                WORK, "native_sr.sam"), None, "native", threads, fq2)
            rates[prefix] = (None, n_reads_of(fq1) / secs)
        return rates[prefix][1]

    def counted(st, k0):
        nonlocal n_k1
        st["k1_launches"] = k1.launches - k0
        check(st["k1_launches"] > 0, "popcount_compare was not launched")
        n_k1 += st["k1_launches"]
        return st

    facs = {"slots2": make_torch_native_engine_factory(
        dev, n_threads=threads, index_shards=[dev, dev])}
    if torch.cuda.device_count() >= 2:
        facs["all"] = make_torch_native_engine_factory(
            dev, n_threads=threads, index_shards="all")
    k1.launches = seed_extend.launches = candidate_list.launches = 0
    for name, fac in facs.items():
        for prefix in SHARD_GOLDENS:
            fq1, fq2 = golden_fastqs(prefix)
            sam = os.path.join(WORK, f"shards_{prefix}.sam")
            mst = os.path.join(WORK, f"shards_{prefix}.mstats")
            k0 = k1.launches
            st = port_map(fac, trex, fq1, sam, mst, golden_cl(prefix),
                          threads, fq2)
            sam_ok, mst_ok = golden_identical(prefix, sam, mst)
            st.update(sam_identical=sam_ok, mstats_identical=mst_ok,
                      native_per_s=native_rate(prefix))
            check(sam_ok and mst_ok, f"index shards {name} {prefix}: output "
                  "differs from the golden")
            out[f"shards_{name}_{prefix}"] = counted(st, k0)
    # the 1 Gb SE set of the scale phase, two shards on one card
    fq, _, sam_native, cl = sets["se"]
    big = sets["index"]
    t0 = time.perf_counter()
    eng = facs["slots2"](big, False, 0.1, 32, 3000)
    st = {"engine_s": time.perf_counter() - t0,
          "table_bytes": eng.tp.nbytes(), "P2": eng.tp.P2, "P3": eng.tp.P3}
    sam = os.path.join(WORK, "shards_scale_se.sam")
    for run in ("first", "warm"):
        k0 = k1.launches
        st[run] = counted(port_map(facs["slots2"], big, fq, sam, None, cl,
                                   threads), k0)
        check(open(sam, "rb").read() == open(sam_native, "rb").read(),
              f"index shards 1 Gb SE ({run}): SAM differs from the native "
              "engine's")
    st.update(sam_identical=True, native_per_s=rates["se"][1],
              fused_per_s=rates["se"][0])
    out["shards_slots2_scale_se"] = st

    # torch-replay: stage 1 on the card, the replay in Python, in this
    # process (-t 1) and in three forked workers (-t 3, run_map_hybrid)
    replay = make_torch_engine_factory(dev)
    for prefix in REPLAY_GOLDENS:
        fq1, fq2 = golden_fastqs(prefix)
        for t in (1, 3):
            sam = os.path.join(WORK, f"replay_{prefix}_t{t}.sam")
            mst = os.path.join(WORK, f"replay_{prefix}_t{t}.mstats")
            k0 = k1.launches
            eng = replay(trex, False, 0.1, 32, 3000)
            u0, f0 = eng.n_units, eng.n_fallback
            secs = map_with(replay, trex, fq1, sam, mst, golden_cl(prefix),
                            t, fq2)
            sam_ok, mst_ok = golden_identical(prefix, sam, mst)
            check(sam_ok and mst_ok, f"torch-replay -t {t} {prefix}: output "
                  "differs from the golden")
            unit = "pairs" if fq2 else "reads"
            n = n_reads_of(fq1)
            out[f"replay_{prefix}_t{t}"] = counted({
                unit: n, "seconds": secs, f"{unit}_per_s": n / secs,
                "native_per_s": native_rate(prefix),
                "fallback_frac": (eng.n_fallback - f0)
                / max(1, eng.n_units - u0),
                "sam_identical": sam_ok, "mstats_identical": mst_ok}, k0)
    out["launches"] = {"popcount_compare": n_k1,
                       "seed_extend": seed_extend.launches,
                       "candidate_list": candidate_list.launches}
    for k in (seed_extend, candidate_list):
        check(k.launches > 0, f"{k.__name__} was not launched")
    return out, out["launches"]


# --- phase 10 ------------------------------------------------------------------

MESH_GOLDENS = ("small", "reads", "small_pe", "reads_pe")
SPLIT_GOLDENS = ("reads", "reads_pe")  # the server split
MULTIHOST_GOLDENS = ("small", "reads_pe")  # run_map_multihost
SHARD_CLI_GOLDEN = "small"


def golden_fastqs(prefix):
    fq1 = gunzip_to(f"{prefix}_1.fq", WORK)
    fq2 = gunzip_to(f"{prefix}_2.fq", WORK) if prefix.endswith("_pe") else None
    return fq1, fq2


def golden_cl(prefix, flag=""):
    """The argv the golden was mapped with, MANIFEST.md (flag: "-P " for
    the PBAT ones)."""
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq"
            if prefix.endswith("_pe") else f"tests/{prefix}_1.fq")
    return (f"map {flag}-s tests/{prefix}.mstats -o tests/{prefix}.sam "
            f"-i tests/tRex1.idx {tail}")


def launches_moved(kernels, what):
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched during the {what} runs")
    return launches


def hybrid_map(eng, index, fq1, fq2, sam, cl, share, threads, mstats=None,
               native_server=None):
    """One run_map_hybrid_split with the port engine eng as the device
    side; returns its stats dict.  device_side_s runs from the start to
    the engine's last finish; native_side_s (in-process split only) to
    the end of the native thread."""
    import threading

    from abismal_tpu_torch.host import run_map_hybrid_split, write_stats

    eng.n_threads = threads
    u0, f0 = eng.n_units, eng.n_fallback
    ends = {}

    def timed(name, fn):
        def call(*a, **k):
            r = fn(*a, **k)
            ends["device"] = time.perf_counter()
            return r
        setattr(eng, name, call)

    def watch_native():
        while not done.is_set():
            for t in threading.enumerate():
                if t.name == "native-shard" and t.is_alive():
                    t.join()
                    ends["native"] = time.perf_counter()
                    return
            time.sleep(0.001)

    for name in ("finish_se", "finish_pe"):
        timed(name, getattr(eng, name))
    done = threading.Event()
    watcher = threading.Thread(target=watch_native)
    info = {}
    t0 = time.perf_counter()
    watcher.start()
    try:
        stats = run_map_hybrid_split(
            index, fq1, fq2, sam, cl, device_share=share, threads=threads,
            tpu_engine=eng, native_server=native_server, stats_out=info)
    finally:
        secs = time.perf_counter() - t0
        done.set()
        watcher.join()
        del eng.finish_se, eng.finish_pe
    write_stats(stats, mstats, False, fq2 is not None, False)
    check(info["n_device"] > 0, "hybrid: no read went to the device")
    unit = "pairs" if fq2 else "reads"
    n = n_reads_of(fq1)
    return {unit: n, "seconds": secs, f"{unit}_per_s": n / secs,
            "device_share": share, "n_native": info["n_native"],
            "n_device": info["n_device"],
            "fallback_frac": (eng.n_fallback - f0) / max(1, eng.n_units - u0),
            **{f"{k}_side_s": v - t0 for k, v in ends.items()}}


def phase_scaleout(dev, threads, card, trex, sets, rates):
    """Phase 10: the mesh, the hybrid split and multi-host sharding.  trex
    is the tRex1 index of the goldens phases (its port engine is warm),
    rates this call's (port-only, native-only) rates by set."""
    import torch

    from abismal_tpu_torch.host import NativeShardServer, write_stats
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory
    from abismal_tpu_torch.parallel.multihost import run_map_multihost

    kernels = wrappers()
    rates = {**rates, **sets["rates"]}
    big = sets["index"]
    n_cards = torch.cuda.device_count()
    out = {"card": card, "real_multi_card": n_cards >= 2}
    launches = {}

    def rated(st, key):
        st["port_only_per_s"], st["native_only_per_s"] = rates[key]
        return st

    # --- mesh: two slots on one card; given two cards, every card too
    for k in kernels:
        k.launches = 0
    # every slot maps the one-card chunk of 2048 units
    facs = {"slots2": make_torch_native_engine_factory(
        dev, unit_batch=4096, n_threads=threads, mesh_devices=[dev, dev])}
    if n_cards >= 2:
        facs["all"] = make_torch_native_engine_factory(
            dev, unit_batch=2048 * n_cards, n_threads=threads,
            mesh_devices="all")
    mesh = {}
    for prefix in MESH_GOLDENS:
        fq1, fq2 = golden_fastqs(prefix)
        sam = os.path.join(WORK, f"mesh_{prefix}.sam")
        mst = os.path.join(WORK, f"mesh_{prefix}.mstats")
        eng = facs["slots2"](trex, False, 0.1, 32, 3000)
        d0 = int(eng.device_decisions.sum())
        st = port_map(facs["slots2"], trex, fq1, sam, mst, golden_cl(prefix),
                      threads, fq2)
        sam_ok, mst_ok = golden_identical(prefix, sam, mst)
        st.update(sam_identical=sam_ok, mstats_identical=mst_ok)
        check(sam_ok and mst_ok, f"mesh {prefix}: output differs from the "
              "golden")
        if fq2 is None:
            st["decisions"] = int(eng.device_decisions.sum()) - d0
            check(st["decisions"] == n_reads_of(fq1),
                  f"mesh {prefix}: decision counts do not cover the reads")
        mesh[prefix] = rated(st, prefix) if prefix in rates else st
    for name, fac in facs.items():
        eng = fac(big, False, 0.1, 32, 3000)
        for kind in ("se", "pe"):
            fq1, fq2, sam_native, cl = sets[kind]
            sam = os.path.join(WORK, f"mesh_scale_{kind}.sam")
            st = {}
            for run in ("first", "warm"):
                d0 = int(eng.device_decisions.sum())
                st[run] = port_map(fac, big, fq1, sam, None, cl, threads, fq2)
                same = open(sam, "rb").read() == open(sam_native, "rb").read()
                check(same, f"mesh {name} 1 Gb {kind} ({run}): SAM differs "
                      "from the native engine's")
                if kind == "se":
                    st[run]["decisions"] = int(eng.device_decisions.sum()) - d0
                    check(st[run]["decisions"] == n_reads_of(fq1),
                          f"mesh {name} 1 Gb: decision counts do not cover "
                          "the reads")
            st["sam_identical"] = True
            mesh[f"scale_{kind}_{name}"] = rated(st, kind)
    out["mesh"] = mesh
    launches["mesh"] = launches_moved(kernels, "mesh")

    # --- hybrid: in-process on the 1 Gb sets, NativeShardServer on tRex1
    for k in kernels:
        k.launches = 0
    port = make_torch_native_engine_factory(dev, n_threads=threads)
    hybrid = {}
    eng = port(big, False, 0.1, 32, 3000)  # the scale phase's engine
    for kind in ("se", "pe"):
        fq1, fq2, sam_native, cl = sets[kind]
        dev_rate, host_rate = rates[kind]
        sam = os.path.join(WORK, f"hybrid_scale_{kind}.sam")
        st = hybrid_map(eng, big, fq1, fq2, sam, cl,
                        dev_rate / (dev_rate + host_rate), threads)
        st["sam_identical"] = (open(sam, "rb").read()
                               == open(sam_native, "rb").read())
        check(st["sam_identical"], f"hybrid 1 Gb {kind}: SAM differs from "
              "the native engine's")
        hybrid[f"scale_{kind}"] = rated(st, kind)
    eng = port(trex, False, 0.1, 32, 3000)  # the goldens phase's engine
    server = NativeShardServer(os.path.join(WORK, "tRex1.idx"),
                               threads=threads)
    try:
        for prefix in SPLIT_GOLDENS:
            fq1, fq2 = golden_fastqs(prefix)
            sam = os.path.join(WORK, f"hybrid_{prefix}.sam")
            mst = os.path.join(WORK, f"hybrid_{prefix}.mstats")
            dev_rate, host_rate = rates[prefix]
            st = hybrid_map(eng, trex, fq1, fq2, sam, golden_cl(prefix),
                            dev_rate / (dev_rate + host_rate), threads,
                            mstats=mst, native_server=server)
            sam_ok, mst_ok = golden_identical(prefix, sam, mst)
            st.update(sam_identical=sam_ok, mstats_identical=mst_ok)
            check(sam_ok and mst_ok, f"hybrid server {prefix}: output "
                  "differs from the golden")
            hybrid[f"server_{prefix}"] = rated(st, prefix)
    finally:
        server.close()
    out["hybrid"] = hybrid
    launches["hybrid"] = launches_moved(kernels, "hybrid")

    # --- multihost: 2 shard processes (shard i on cuda:i mod the cards)
    shard_dev = None if dev.type == "cuda" else str(dev)
    idx = os.path.join(WORK, "tRex1.idx")
    per_host = max(1, threads // 2)
    mh = {}
    for prefix in MULTIHOST_GOLDENS:
        fq1, fq2 = golden_fastqs(prefix)
        sam = os.path.join(WORK, f"multihost_{prefix}.sam")
        mst = os.path.join(WORK, f"multihost_{prefix}.mstats")
        t0 = time.perf_counter()
        stats = run_map_multihost(idx, fq1, fq2, sam, golden_cl(prefix), 2,
                                  threads_per_host=per_host, device=shard_dev)
        secs = time.perf_counter() - t0
        write_stats(stats, mst, False, fq2 is not None, False)
        sam_ok, mst_ok = golden_identical(prefix, sam, mst)
        check(sam_ok and mst_ok, f"multihost {prefix}: output differs from "
              "the golden")
        unit = "pairs" if fq2 else "reads"
        n = n_reads_of(fq1)
        st = {unit: n, "seconds": secs, f"{unit}_per_s": n / secs,
              "sam_identical": sam_ok, "mstats_identical": mst_ok}
        mh[prefix] = rated(st, prefix) if prefix in rates else st
    # `map --shard I:2`, one process per shard, both at once
    fq1, _ = golden_fastqs(SHARD_CLI_GOLDEN)
    parts = [os.path.join(WORK, f"shard{i}.sam") for i in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "abismal_tpu_torch", "map", "--shard",
         f"{i}:2", "--device", str(dev), "-t", str(per_host), "-o", part,
         "-i", idx, fq1], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE) for i, part in enumerate(parts)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        check(p.returncode == 0, f"map --shard: {err.decode()[-2000:]}")
    secs = time.perf_counter() - t0
    gathered = b"".join(open(part, "rb").read() for part in parts)
    with gzip.open(os.path.join(GOLDEN, SHARD_CLI_GOLDEN + ".sam.gz"),
                   "rb") as f:
        golden = f.read()

    same = sam_body(gathered) == sam_body(golden)
    check(same, "map --shard: the gathered shards differ from the golden")
    mh["shard_cli_" + SHARD_CLI_GOLDEN] = dict(
        seconds=secs, sam_identical_but_pg=same)
    out["multihost"] = mh
    return out, {name: sum(ls[name] for ls in launches.values())
                 for name in launches["mesh"]}


# --- phase 11 (graphs) -------------------------------------------------------

GRAPH_READS = 4096  # reads (or pairs) of a route's batch: two chunks or more
GRAPH_TURNS = ("eager", "graphed", "graphed", "eager")
GRAPH_RATE_GOLDENS = ("reads", "reads_pe")  # the tRex1 10k SE and PE sets
# the CUDA runtime's calls that put work on a stream
TOP_OPS = 10  # a batch's card ops by device time that launch_counts lists
CARD_OP_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # trace categories
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def batch_tensors(handle):
    """Every tensor of a dispatched batch's handle, in order, on the host,
    once its collection (the event route's future) is done."""
    import torch

    out = []

    def walk(x):
        if torch.is_tensor(x):
            out.append(x.cpu())
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif hasattr(x, "result"):
            x.result()

    walk(handle)
    return out


def dispatch_batch(kind, eng, reads, pairs):
    """One batch through a route's dispatch; (handle, its chunks)."""
    if kind == "pe":
        h = eng.dispatch_pe(*pairs, False, False)
        return h, len(h[5])
    if kind == "units":  # the replay engine's stage 1
        h = eng._dispatch_units(eng._se_units(reads, False, False))
        return h, len(h[1])
    h = eng.dispatch_se(reads, False, False)
    return h, len(h[6] if kind == "events" else h[4])


def batch_span(kind, eng, reads, pairs):
    """(ms a chunk from the batch's dispatch to the end of its device
    work, CUDA events; host seconds of the dispatch a chunk; the batch's
    outputs)."""
    import torch

    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    t0 = time.perf_counter()
    handle, n = dispatch_batch(kind, eng, reads, pairs)
    host = time.perf_counter() - t0
    e1.record()
    outs = batch_tensors(handle)
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n, host / n, outs, n


def launch_counts(kind, eng, reads, pairs, kernels):
    """A batch's launches a chunk, by torch.profiler: the runtime calls
    that put work on a stream (LAUNCH_CALLS) on the host, the graph
    launches among them, and the kernels and copies the card ran; and
    the batch's runs of each kernel wrapper's __global__ kernel (named
    wrapper + "_kernel") that the card ran, which must equal the wrapper's
    launch counter's growth over the batch.  Also the card's device µs a
    chunk and its TOP_OPS ops by device time ([name, runs, µs a chunk,
    share]): for a graphed engine, a replay's breakdown.  The batch is a
    quarter of the route's (one or two chunks): the profiler's own cost
    grows with the events it records."""
    reads = reads[: len(reads) // 4]
    pairs = tuple(p[: len(p) // 4] for p in pairs)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from abismal_tpu_torch.tools.trace_ops import top_events

    before = {k.__name__: k.launches for k in kernels}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        handle, n = dispatch_batch(kind, eng, reads, pairs)
        batch_tensors(handle)
        torch.cuda.synchronize()
    counted = {k.__name__: k.launches - before[k.__name__] for k in kernels}
    ran = dict.fromkeys(counted, 0)
    host = graph = device = 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            device += e.count
            for name in ran:
                if re.search(rf"\b{name}_kernel\b", e.key):
                    ran[name] += e.count
        elif e.key in LAUNCH_CALLS:
            host += e.count
            graph += e.count if e.key == "cudaGraphLaunch" else 0
    check(ran == counted, f"{kind}: the card ran the kernels {ran} times, "
          f"the launch counters grew {counted}")
    # the card's ops by device time, from the trace's events (as trace_ops
    # reads them)
    path = os.path.join(WORK, "launch_counts_trace.json")
    prof.export_chrome_trace(path)
    top, total_us = top_events(path, CARD_OP_CATS, TOP_OPS)
    return dict(host_launches=host / n, graph_launches=graph / n,
                device_ops=device / n, chunks=n, kernels_ran=ran,
                device_us=total_us / n,
                top_ops=[[name[:100], runs / n, us / n, us / total_us]
                         for name, runs, us in top])


def graph_routes(dev):
    """(name, TorchNativeEngine arguments or None for the replay engine,
    the dispatch kind) of every graphed route."""
    slots = [dev, dev]
    return (
        ("fused_se", {}, "se"),
        ("fused_pe", {}, "pe"),
        ("events_align", dict(device_stage2=False, device_align=True),
         "events"),
        ("index_shards", dict(index_shards=slots), "events"),
        ("mesh_se", dict(unit_batch=4096, mesh_devices=slots), "se"),
        ("mesh_pe", dict(unit_batch=4096, mesh_devices=slots), "pe"),
        ("mesh_events", dict(unit_batch=4096, mesh_devices=slots,
                             device_stage2=False), "events"),
        ("replay", None, "units"),
    )


def rates_in_turns(index, fq1, fq2, cl, same, engines, native, threads,
                   n_reads):
    """Whole-path rates (reads/s or pairs/s) of the eager and the graphed
    engine in GRAPH_TURNS, the native engine once; same(sam) checks each
    SAM.  Also each mode's dispatch seconds (the tracer's map/dispatch
    span, on for these maps) and the peak of device memory a map
    allocates above what was resident before it."""
    import torch

    from abismal_tpu_torch.tools._workload import engine_factory

    out = {m: dict(per_s=[], dispatch_s=[], peak_above_resident=[])
           for m in ("eager", "graphed")}
    sam = os.path.join(WORK, "graphs_rate.sam")
    for mode in GRAPH_TURNS:
        eng = engines[mode]
        eng.tracer.reset()
        eng.tracer.on = True
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        secs = map_with(engine_factory(eng), index, fq1, sam, None, cl,
                        threads, fq2)
        eng.tracer.on = False
        out[mode]["per_s"].append(n_reads / secs)
        out[mode]["dispatch_s"].append(
            eng.tracer.summary()["spans"]["map/dispatch"][1])
        out[mode]["peak_above_resident"].append(
            torch.cuda.max_memory_allocated() - resident)
        check(same(sam), f"graphs rates {mode}: the SAM differs")
    secs = map_with(native, index, fq1, os.path.join(WORK, "graphs_n.sam"),
                    None, cl, threads, fq2)
    out["native_per_s"] = n_reads / secs
    return out


def phase_graphs(dev, threads, card, trex, sets):
    """Phase 11: every route's device programs as CUDA graphs against the
    eager programs on the card: each route's outputs on a batch of
    GRAPH_READS reads or pairs (two or more chunks) bit-equal, the chunk
    span and the dispatch's host time in GRAPH_TURNS, launches a chunk
    (torch.profiler), capture seconds and pool bytes of every key;
    whole-path rates eager and graphed in turns with the native engine
    on tRex1 10k SE, 10k PE and the 1 Gb SE set (with the peak device
    memory of a map).  Each route's K1-K6 runs on the card, counted by
    name in the profiler, equal the launch counters' growth, graphed and
    eager alike, beside the top card ops of a chunk by device time.  Then
    K4, and K5 with K6, against their plain versions inside the graphed
    engines (kernels_in_turns)."""
    import torch

    from abismal_tpu_torch import graphs as G
    from abismal_tpu_torch.host import make_native_engine_factory
    from abismal_tpu_torch.map.pipeline import (
        TorchMappingEngine, TorchNativeEngine, make_torch_engine_factory,
        make_torch_native_engine_factory,
    )
    from abismal_tpu_torch.tools import _workload as W

    kernels = wrappers()
    for k in kernels:
        k.launches = 0
    reads = W.load_reads(golden_fastqs("reads")[0], GRAPH_READS)
    fq1, fq2 = golden_fastqs("reads_pe")
    pairs = (W.load_reads(fq1, GRAPH_READS), W.load_reads(fq2, GRAPH_READS))
    out = {"card": card, "reads_a_batch": GRAPH_READS}
    eagers = {}  # one eager engine per route arguments
    for name, kw, kind in graph_routes(dev):
        t0 = time.perf_counter()
        key = repr(kw)
        if kw is None:  # the shards_replay phase's engine, and an eager one
            graphed = make_torch_engine_factory(dev)(trex, False, 0.1, 32,
                                                     3000)
            if key not in eagers:
                eagers[key] = TorchMappingEngine(trex, device=dev,
                                                 graphs=False)
        else:  # the earlier phases' engine where there is one
            graphed = make_torch_native_engine_factory(
                dev, n_threads=threads, **kw)(trex, False, 0.1, 32, 3000)
            if key not in eagers:
                eagers[key] = TorchNativeEngine(
                    trex, device=dev, n_threads=threads, graphs=False, **kw)
        eager = eagers[key]
        check(isinstance(graphed.graphs, G.Graphs)
              and isinstance(eager.graphs, G.Eager),
              f"graphs {name}: the engines' modes")
        n_keys = len(graphed.graphs.stats())
        for eng in (eager, graphed):  # warm: builds, a new key's capture
            batch_span(kind, eng, reads, pairs)
        st = {m: dict(span_ms=[], host_ms=[]) for m in ("eager", "graphed")}
        outs = {}
        for mode in GRAPH_TURNS:
            eng = graphed if mode == "graphed" else eager
            span, host, outs[mode], n = batch_span(kind, eng, reads, pairs)
            st[mode]["span_ms"].append(span)
            st[mode]["host_ms"].append(host * 1e3)
        check(len(outs["eager"]) == len(outs["graphed"]) > 0
              and all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(outs["eager"], outs["graphed"])),
              f"graphs {name}: the replayed outputs differ from the eager "
              "program's")
        for mode, eng in (("eager", eager), ("graphed", graphed)):
            st[mode].update(launch_counts(kind, eng, reads, pairs, kernels))
        check(st["eager"]["kernels_ran"] == st["graphed"]["kernels_ran"]
              and any(st["graphed"]["kernels_ran"].values()),
              f"graphs {name}: the card ran the kernels "
              f"{st['graphed']['kernels_ran']} times graphed, "
              f"{st['eager']['kernels_ran']} eager")
        st.update(chunks=n, outputs_bit_equal=True,
                  keys=graphed.graphs.stats(),
                  keys_captured_here=len(graphed.graphs.stats()) - n_keys,
                  seconds=time.perf_counter() - t0)
        out[name] = st

    # whole-path rates, eager and graphed in turns, the native engine once
    native = make_native_engine_factory(n_threads=threads)
    fused = make_torch_native_engine_factory(dev, n_threads=threads)
    rates = {}
    for prefix in GRAPH_RATE_GOLDENS:
        q1, q2 = golden_fastqs(prefix)
        with gzip.open(os.path.join(GOLDEN, prefix + ".sam.gz"), "rb") as f:
            want = f.read()
        rates[prefix] = rates_in_turns(
            trex, q1, q2, golden_cl(prefix),
            lambda sam, want=want: open(sam, "rb").read() == want,
            {"eager": eagers[repr({})],
             "graphed": fused(trex, False, 0.1, 32, 3000)}, native, threads,
            n_reads_of(q1))
    big = sets["index"]
    fq, _, sam_native, cl = sets["se"]
    want = open(sam_native, "rb").read()
    eng_big = TorchNativeEngine(big, device=dev, n_threads=threads,
                                graphs=False)
    graphed_big = fused(big, False, 0.1, 32, 3000)
    rates["scale_se"] = rates_in_turns(
        big, fq, None, cl, lambda sam: open(sam, "rb").read() == want,
        {"eager": eng_big, "graphed": graphed_big}, native, threads,
        n_reads_of(fq))
    rates["scale_se"]["pool_bytes"] = sum(
        k["pool_bytes"] for k in graphed_big.graphs.stats())
    rates["scale_se"]["table_bytes"] = eng_big.dev.nbytes()
    out["rates"] = rates

    for eng in eagers.values():
        if hasattr(eng, "close"):
            eng.close()
    for label, names in PLAIN_COMPARISONS:
        out[f"{label}_plain"] = kernels_in_turns(dev, threads, trex, sets,
                                                 kernels, label, names)
    out["launches"] = launches_moved(kernels, "graphs")
    return out, out["launches"]


EXT_GOLDENS = {"fused_se": "reads", "fused_pe": "reads_pe"}
# the in-graph comparisons of a kernel set with its plain versions: (label,
# the programs' kernel entry points swapped, in turns with the plain ones)
PLAIN_COMPARISONS = (("k4", ("seed_extend",)),
                     ("k5k6", ("segment_rank", "candidate_list")))


@contextlib.contextmanager
def plain_versions(names, on=True):
    """With on, the programs call the plain versions of the kernel entry
    points `names` (map/pipeline.py attributes) in place of their
    wrappers until the block ends (the runs of the engine that
    kernels_in_turns compares the kernels with: its graphs capture the
    plain ops); without, the wrappers, as ever."""
    import importlib

    from abismal_tpu_torch.map import pipeline

    inner = {n: getattr(pipeline, n) for n in names}
    if on:
        for n in names:
            mod = importlib.import_module(f"abismal_tpu_torch.kernels.{n}")
            setattr(pipeline, n, getattr(mod, n + "_plain"))
    try:
        yield
    finally:
        for n in names:
            setattr(pipeline, n, inner[n])


def kernels_in_turns(dev, threads, trex, sets, kernels, label, names):
    """A graphed engine with the kernels `names` against a graphed engine
    whose programs run their plain versions (plain_versions around that
    engine's runs alone), on fused SE and PE (the 10k golden reads and
    pairs) and the 1 Gb SE set: a batch of GRAPH_READS bit-equal, card
    ops a chunk, the kernels' runs and the top 10 card ops of a replay by
    device time (launch_counts; the kernels run in the kernel engine
    alone); after a warm map of each, whole maps in turns (plain, label,
    label, plain): the rate, each replay's span (one event pair around
    it) and the SAM against the golden or the native engine's; the
    native engine once."""
    import torch

    from abismal_tpu_torch.host import make_native_engine_factory
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.tools import _workload as W

    native = make_native_engine_factory(n_threads=threads)
    turns = ("plain", label, label, "plain")
    out = {}
    for name, index, kind in (("fused_se", trex, "se"),
                              ("fused_pe", trex, "pe"),
                              ("scale_se", sets["index"], "se")):
        t0 = time.perf_counter()
        if name == "scale_se":
            fq1, fq2, sam_native, cl = sets["se"]
            want = open(sam_native, "rb").read()
        else:
            prefix = EXT_GOLDENS[name]
            fq1, fq2 = golden_fastqs(prefix)
            cl = golden_cl(prefix)
            with gzip.open(os.path.join(GOLDEN, prefix + ".sam.gz"),
                           "rb") as f:
                want = f.read()
        reads = W.load_reads(fq1, GRAPH_READS)
        pairs = (reads, W.load_reads(fq2, GRAPH_READS)) if fq2 else ((), ())
        sam = os.path.join(WORK, "kernels_turns.sam")
        engines = {m: TorchNativeEngine(index, device=dev, n_threads=threads)
                   for m in ("plain", label)}
        st = {m: dict(per_s=[], replay_ms=[]) for m in engines}
        outs = {}
        for m, eng in engines.items():
            eng.profile = True
            with plain_versions(names, m == "plain"):
                outs[m] = batch_span(kind, eng, reads, pairs)[2]
                st[m].update(launch_counts(kind, eng, reads, pairs, kernels))
                map_with(W.engine_factory(eng), index, fq1, sam, None, cl,
                         threads, fq2)
        check(len(outs["plain"]) == len(outs[label]) > 0
              and all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(outs["plain"], outs[label])),
              f"{label} {name}: the kernels' outputs differ from the plain "
              "versions'")
        for k in names:
            ran = {m: st[m]["kernels_ran"][k] for m in engines}
            check(ran["plain"] == 0 < ran[label],
                  f"{label} {name}: {k} ran {ran} times by engine")
        n = n_reads_of(fq1)
        for m in turns:
            eng = engines[m]
            c0 = len(eng.chunk_marks)
            with plain_versions(names, m == "plain"):
                secs = map_with(W.engine_factory(eng), index, fq1, sam, None,
                                cl, threads, fq2)
            st[m]["per_s"].append(n / secs)
            st[m]["replay_ms"].append(chunk_device_ms(eng, c0)["total_ms"])
            check(open(sam, "rb").read() == want,
                  f"{label} {name} ({m}): the SAM differs")
        for eng in engines.values():
            eng.close()
        secs = map_with(native, index, fq1, os.path.join(WORK, "turns_n.sam"),
                        None, cl, threads, fq2)
        st.update(native_per_s=n / secs, outputs_bit_equal=True,
                  seconds=time.perf_counter() - t0)
        out[name] = st
    return out


TOOLS_REPS = 1  # the bench's repetitions of each mode


def phase_tools(dev, threads, gres):
    """Phase 12: the port's bench and tuning and scaling tools, through
    their entry points, on the card; gres is the goldens phase's result."""
    from abismal_tpu_torch.cli import main as cli_main
    from abismal_tpu_torch.tools import (
        bench, multihost_scale, sweep_unit_batch, tune_hybrid, tune_stage2,
    )

    kernels = wrappers()
    out, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        secs[name] = time.perf_counter() - t0
        return res

    line = timed("bench", lambda: bench.main(
        ["--reps", str(TOOLS_REPS), "--threads", str(threads)]))
    out["bench"] = line
    for mode in bench.N_REPS:
        check(line["modes"][mode]["best"] > 0,
              f"bench {mode}: no repetition verified")
    want = round(gres["reads"]["fallback_frac"], 5)
    check(line["modes"]["torch"]["fallback_frac"] == want,
          f"bench torch: fallback {line['modes']['torch']['fallback_frac']}"
          f", the goldens phase's {want} on the same reads")

    for k in kernels:
        k.launches = 0
    rows = timed("tune_stage2", lambda: tune_stage2.main(
        ["2048", "--threads", str(threads)]))
    check(all(r["verified"] == r["reps"] for r in rows),
          "tune_stage2: a repetition was not verified")
    out["tune_stage2"] = rows
    rows = timed("sweep_unit_batch", lambda: sweep_unit_batch.main(
        ["2048", "8192", "--threads", str(threads)]))
    check(all(r["md5"] == bench.GOLDEN_SAM_MD5 for r in rows),
          "sweep_unit_batch: a SAM differs from the golden")
    out["sweep_unit_batch"] = rows
    out["tune_hybrid"] = timed("tune_hybrid", lambda: tune_hybrid.main(
        ["2048", "--threads", str(threads)]))
    launches = {k.__name__: k.launches for k in kernels}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the tools")
    out["launches"] = launches

    for engine in ("native", "torch"):
        out[f"multihost_scale_{engine}"] = timed(
            f"multihost_scale_{engine}", lambda: multihost_scale.main(
                ["--hosts", "1", "2", "--per-host", "10000", "--reps", "1",
                 "--engine", engine]))

    fq = os.path.join(WORK, "reads_1.fq")
    sam = os.path.join(WORK, "hosts_native.sam")
    mst = os.path.join(WORK, "hosts_native.mstats")
    rc = timed("hosts_native", lambda: cli_main(
        ["map", "--hosts", "2", "--engine", "native", "-t",
         str(max(1, threads // 2)), "-s", mst, "-o", sam, "-i",
         os.path.join(WORK, "tRex1.idx"), fq]))
    check(rc == 0, f"map --hosts 2 --engine native: rc {rc}")
    same = (sam_body(open(sam, "rb").read())
            == sam_body(open(os.path.join(WORK, "reads.sam"), "rb").read()))
    _, mst_ok = golden_identical("reads", sam, mst)
    check(same and mst_ok, "map --hosts 2 --engine native: output differs "
          "from the golden")
    out["hosts_native"] = dict(sam_identical_but_pg=same,
                               mstats_identical=mst_ok)
    out["tool_seconds"] = secs
    return out, launches


def kernels_line(kres, phase_launches):
    """The kernels' summary: one entry per entry point, its launches
    summed over the main paths' phases (each phase's counts were taken
    from zero), every number measured in the kernels phase."""
    line = []
    for name in REPLACES:
        k = kres[name]
        entry = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=sum(ls.get(name, 0) for ls in phase_launches),
            max_abs_err=max(kres[c]["max_abs_err"] for c in CASES[name]),
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"],
            # K5's and K6's yardsticks, the scan and the search their
            # kernels took the place of (LIBRARY_CALL); no single PyTorch
            # call computes the other functions
            library_ms=k.get("library_ms"))
        check(entry["launches"] > 0,
              f"{name} was not launched on the main paths")
        line.append(entry)
    return line


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "abismal_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    os.makedirs(WORK, exist_ok=True)
    threads = min(8, os.cpu_count() or 1)
    dev = torch.device("cuda")
    try:
        from abismal_tpu_torch.device import card_info
        from abismal_tpu_torch.kernels import _build

        card = card_info()
        nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                              capture_output=True, text=True).stdout
        emit("probe", torch=torch.__version__, cuda=torch.version.cuda,
             nvcc=nvcc.strip().splitlines()[-1], card=card,
             device_name=torch.cuda.get_device_name(0),
             device_count=torch.cuda.device_count(),
             python=sys.version.split()[0])

        t0 = time.perf_counter()
        _build.load()
        emit("build", seconds=time.perf_counter() - t0,
             nvcc_seconds=_build.build_seconds,
             libraries=[os.path.relpath(_build.library_path(stem), ROOT)
                        for stem in _build.SIGNATURES],
             ptxas=[ln.strip() for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln])

        kres = phase_kernels(dev)
        emit("kernels", **kres)

        gres, launches, index = phase_goldens(dev, threads)
        emit("goldens", **gres)

        pres, launches_pe = phase_goldens_pe(dev, threads, index)
        emit("goldens_pe", **pres)

        eres, launches_ev = phase_events(dev, threads, index)
        emit("events", **eres)

        sres, sets = phase_scale(dev, threads)
        emit("scale", **sres)

        t0 = time.perf_counter()
        kres.update(phase_kernels_ext(dev, threads, index, sets))
        emit("kernels_ext", seconds=time.perf_counter() - t0,
             **{c: kres[c] for k in ("seed_extend", "segment_rank",
                                     "candidate_list") for c in CASES[k]},
             library_call=LIBRARY_CALL)

        t0 = time.perf_counter()
        fres, launches_prof = phase_profile(dev, threads, card, index, sets)
        emit("profile", seconds=time.perf_counter() - t0, **fres)

        rates = {"reads": (gres["reads"]["reads_per_s"],
                           gres["native_reads_per_s"]),
                 "reads_pe": (pres["reads_pe"]["pairs_per_s"],
                              pres["reads_pe"]["native_pairs_per_s"])}
        t0 = time.perf_counter()
        rres, launches_sr = phase_shards_replay(
            dev, threads, card, index, sets, {**rates, **sets["rates"]})
        emit("shards_replay", seconds=time.perf_counter() - t0, **rres)

        ores, launches_out = phase_scaleout(dev, threads, card, index, sets,
                                            rates)
        emit("scaleout", **ores)

        t0 = time.perf_counter()
        grres, launches_graphs = phase_graphs(dev, threads, card, index,
                                              sets)
        emit("graphs", seconds=time.perf_counter() - t0, **grres)

        t0 = time.perf_counter()
        tres, launches_tools = phase_tools(dev, threads, gres)
        emit("tools", seconds=time.perf_counter() - t0, **tres)
        check("jax" not in sys.modules, "the port loaded jax")
        check(not [m for m in sys.modules
                   if m == "abismal_tpu" or m.startswith("abismal_tpu.")],
              "the port loaded the JAX package abismal_tpu")
        # nor the JAX tools' entry module, nor the tests (an installed
        # `tests` package shadows them on the card machine)
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("__graft_entry__", "tests")]
        check(not loaded, f"the port loaded {loaded}")
        line = kernels_line(kres, (launches, launches_pe, launches_ev,
                                   launches_prof, launches_sr,
                                   launches_out, launches_graphs,
                                   launches_tools))
    except Exception:
        traceback.print_exc()
        return 1

    print(card, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
