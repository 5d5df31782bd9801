#!/usr/bin/env python3
"""Smoke test of abismal_tpu_torch, the PyTorch + CUDA port, on one GPU.

Phases (each prints one JSON line; any failure exits non-zero):
  1. probe    torch / CUDA / nvcc versions, the card's name and power limit;
  2. build    nvcc-builds the port's kernels (csrc/*.cu) from the checkout,
              one nvcc per source at once, and prints what ptxas says of
              their registers and spills;
  3. kernels  each kernel (K1 popcount_compare, K2 banded_score, K3
              banded_trace) against its plain PyTorch version on the card,
              at main-path shapes (K2 also at the paired-end program's
              J = 16384, with negative bands and fill rows, and at
              J = 8192 with the narrow bands of the default -m 0.1), exact
              equality; both timed with CUDA events in turns (plain,
              kernel, kernel, plain), the kernel also as a CUDA graph of
              its launches, which leaves the host out (K1 also over 16
              input sets in turn, which L2 cannot hold); for each case the
              bytes and operations counted from its inputs, the bound
              they give on this card, and the kernel's share of it;
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
              K1 and K2 counters must move during these runs; then
              small_rpbat_pe under -a with random PBAT must equal the
              native engine, with pairs mated on the device;
  6. scale    the 1 Gb synthetic genome of tools/scale_test.py:gen_genome:
              20k simulated SE reads, then 20k simulated pairs, each mapped
              by the port and by the native engine: the SAM bytes must be
              equal;
  7. scaleout the scale-out paths, on the goldens and the 1 Gb sets:
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
              multihost run_map_multihost with 2 shards on reads and
                        reads_pe gives the goldens, and the two `map
                        --shard I:2` processes on small, concatenated,
                        give the golden but for the @PG line;
              K1-K3 must launch during the mesh and the hybrid runs, and
              every run prints its rate beside this call's port-only and
              native-only rates.
It imports only the port (abismal_tpu_torch), which has its own host
side; nothing of JAX and nothing of the JAX package (checked at the end).
The line before the last is the kernels' JSON summary, the last line
{"ok": true, "device": {...}}.  Without a CUDA card, or outside a
checkout of the repository, it fails before printing any result.

Usage: python3 chip_smoke.py
"""

import gzip
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
GOLDEN = os.path.join(ROOT, "tests", "golden")
TOL = 0  # integer kernels: exact equality
SCALE_MB = 1000  # the hg38-size stand-in genome of the scale phase

REPLACES = {
    "popcount_compare": "abismal_tpu/kernels/popcount_compare.py:34",
    "banded_score": "abismal_tpu/kernels/banded_align.py:44",
    "banded_trace": "abismal_tpu/kernels/banded_align.py:99",
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

SOURCES = {
    "popcount_compare": "abismal_tpu_torch/csrc/popcount_compare.cu",
    "banded_score": "abismal_tpu_torch/csrc/banded_align.cu",
    "banded_trace": "abismal_tpu_torch/csrc/banded_align.cu",
}


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


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
               bands=(1, 5, 61, 3, 9, 21, 41)):
    """Banded-alignment jobs over a random one-hot genome with IUPAC
    nibbles: (q (n, lmax) u8, win (n, lmax + QOFF) u8, bw, qsz, pos); job
    i takes band bands[i mod len(bands)]."""
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
        L = int(rng.integers(36, lmax + 1))
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
    return q, win, bw, qsz, pos


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

    def score_case(name, q, win, bw, qsz, reps_plain, **extra):
        t = on_card(q, win, bw[:, None], qsz[:, None])
        return dict(
            name=name, plain=ba.banded_score_plain, kernel=ba.banded_score,
            args=t, reps_plain=reps_plain,
            bound=bound(nbytes_of(*t) + 4 * q.shape[0], OPS_PER_CELL_SCORE
                        * live_cells(q.shape[1], t[2], t[3])),
            extra=dict(shape=f"J={q.shape[0]}",
                       mean_band=float(bw[bw > 0].mean()), **extra))

    rng = np.random.default_rng(7)
    cases = []
    args = k1_inputs(rng, dev)
    cases.append(dict(
        name="popcount_compare", plain=pc.popcount_compare_plain,
        kernel=pc.popcount_compare, args=list(args), reps_plain=5,
        bound=k1_bound(*args), extra=dict(shape=f"G={args[1].shape[0]}")))

    q, win, bw, qsz, _ = align_jobs(rng, 8192, n_pad=512)
    cases.append(score_case("banded_score", q, win, bw, qsz, 3))

    # the paired-end program's shape: 8 jobs x 2048 units, negative bands
    # (IUPAC diffs are not remapped there) and fill rows (bw 1, qsz 0);
    # a seed of its own leaves the K3 inputs below as they were
    rng_pe = np.random.default_rng(17)
    q, win, bw, qsz, _ = align_jobs(rng_pe, 16384, n_pad=1024)
    bw[3::7] = -(2 * rng_pe.integers(0, 30, bw[3::7].shape[0]) + 1)
    bw[5::11], qsz[5::11] = 1, 0
    cases.append(score_case("banded_score_pe", q, win, bw, qsz, 2,
                            negative_bands=int((bw < 0).sum())))

    # the bands real reads give at the default -m 0.1 (seed of its own)
    q, win, bw, qsz, _ = align_jobs(np.random.default_rng(27), 8192,
                                    n_pad=512, bands=NARROW_BANDS)
    cases.append(score_case("banded_score_narrow", q, win, bw, qsz, 3))

    q, win, bw, qsz, pos = align_jobs(rng, 1024, n_pad=128, overflow=4)
    do_tb = rng.random(1024) < 0.9
    do_tb[:4] = True
    bw[~do_tb], qsz[~do_tb] = 1, 0
    t = on_card(q, win, bw, qsz, pos, do_tb)
    J2 = q.shape[0]
    cases.append(dict(
        name="banded_trace", plain=ba.banded_trace_plain,
        kernel=ba.banded_trace, args=t, reps_plain=2,
        bound=bound(nbytes_of(*t) + 4 * J2 * (ba.TB_NOPS + 4),
                    OPS_PER_CELL_TRACE
                    * live_cells(q.shape[1], t[2], t[3])),
        extra=dict(shape=f"J2={J2}")))
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


def phase_kernels(dev):
    """Holds every kernel against its plain version exactly, times both,
    and reads the kernel's device time against its bound."""
    import torch

    res = {"tolerance": TOL, "peak_bytes_per_s": PEAK_BYTES_PER_S,
           "peak_int32_ops_per_s": PEAK_INT32_OPS_PER_S}
    for case in kernel_cases(dev):
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
        if name == "popcount_compare":
            res[name]["ms_rotating"] = k1_rotating_ms(dev, kernel)
        if name == "banded_score_pe":
            check(bool((want[args[2] < 0] == 0).all()),
                  "negative bands must score 0")
        if name == "banded_trace":
            w_meta = want[1]
            n_over = int((w_meta[:4, 0] == -1).sum())
            check(n_over > 0, "K3 inputs lack a TB_NOPS overflow job")
            res[name].update(overflow_jobs=n_over,
                             traced=int((w_meta[:, 0] >= 0).sum()))
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
    last interval is the SE traceback or the PE mating sweep (mate_ms)."""
    import numpy as np

    rows = []
    for marks in eng.chunk_marks[first:]:
        ev = dict(marks)
        rows.append([ev["start"].elapsed_time(ev["core"]),
                     ev["core"].elapsed_time(ev["decide"]),
                     ev["decide"].elapsed_time(ev["score"]),
                     ev["score"].elapsed_time(ev["end"]),
                     ev["start"].elapsed_time(ev["end"])])
    if not rows:
        return {}
    m = np.mean(np.array(rows), axis=0)
    return {"core_ms": m[0], "decide_ms": m[1], "score_ms": m[2], last: m[3],
            "total_ms": m[4], "chunks": len(rows)}


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
    t0 = dict(eng.stage_time)
    secs = map_with(factory, index, fq, sam, mstats, cl, threads, fq2, **kw)
    n = n_reads_of(fq)
    du = eng.n_units - u0
    unit = "pairs" if fq2 else "reads"
    st = {unit: n, "seconds": secs, f"{unit}_per_s": n / secs,
          "fallback_frac": (eng.n_fallback - f0) / max(1, du),
          "host_s": {k: v - t0[k] for k, v in eng.stage_time.items()}}
    st.update(chunk_device_ms(eng, c0, "mate_ms" if fq2 else "traceback_ms"))
    return st


class BandRecorder:
    """Stands in for the pipeline's banded_score while a run is mapped and
    counts the bands of its live jobs (qsz > 0); bands below 0 count at
    -1.  The kernel's wrapper runs as ever."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.inner = pipeline.banded_score
        self.hist = None  # on the device, added to without a sync

    def __call__(self, q, win, bw, qsz):
        import torch

        if self.hist is None:
            self.hist = torch.zeros(66, dtype=torch.int64, device=bw.device)
        self.hist.scatter_add_(0, bw.reshape(-1).long().clamp(-1, 64) + 1,
                               (qsz.reshape(-1) > 0).long())
        return self.inner(q, win, bw, qsz)

    def __enter__(self):
        self.pipeline.banded_score = self
        return self

    def __exit__(self, *exc):
        self.pipeline.banded_score = self.inner

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
    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import popcount_compare as pc
    from abismal_tpu_torch.map import pipeline
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    t0 = time.perf_counter()
    index, how = trex1_index(threads)
    t_index = time.perf_counter() - t0
    factory = make_torch_native_engine_factory(dev, n_threads=threads)
    eng = factory(index, False, 0.1, 32, 3000)
    eng.profile = True
    out = {"index": how, "index_s": t_index}
    kernels = (pc.popcount_compare, ba.banded_score, ba.banded_trace)
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
    # the bands K2 gets on `reads`, from a run of its own: the recorder
    # adds a scatter per chunk, which the timed runs above do not carry
    fq = os.path.join(WORK, "reads_1.fq")
    with BandRecorder(pipeline) as rec:
        map_with(factory, index, fq, os.path.join(WORK, "bands.sam"), None,
                 "bands", threads)
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
    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import popcount_compare as pc
    from abismal_tpu_torch.map import pipeline
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    factory = make_torch_native_engine_factory(dev, n_threads=threads)
    native = make_native_engine_factory(n_threads=threads)
    out = {}
    kernels = (pc.popcount_compare, ba.banded_score)
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
    # the bands of `reads_pe`, recorded outside the timed runs
    fq1, fq2 = (os.path.join(WORK, f"reads_pe_{e}.fq") for e in (1, 2))
    with BandRecorder(pipeline) as rec:
        map_with(factory, index, fq1, os.path.join(WORK, "bands_pe.sam"),
                 None, "bands", threads, fq2)
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


def gen_genome(path, total):
    """tools/scale_test.py:gen_genome, loaded from its file so that tools/
    does not go on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "scale_test", os.path.join(ROOT, "tools", "scale_test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.gen_genome(path, total)


def phase_scale(dev, threads):
    import torch

    from abismal_tpu_torch.host import (
        SimConfig, create_index, make_native_engine_factory, simulate_reads,
    )
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory

    size = SCALE_MB * 1_000_000
    fa = os.path.join(WORK, f"scale_{size}.fa")
    t0 = time.perf_counter()
    if not os.path.exists(fa):
        gen_genome(fa + ".tmp", size)
        os.replace(fa + ".tmp", fa)
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


# --- phase 7 -------------------------------------------------------------------

MESH_GOLDENS = ("small", "reads", "small_pe", "reads_pe")
SPLIT_GOLDENS = ("reads", "reads_pe")  # the server split and multihost
SHARD_CLI_GOLDEN = "small"


def golden_fastqs(prefix):
    fq1 = gunzip_to(f"{prefix}_1.fq", WORK)
    fq2 = gunzip_to(f"{prefix}_2.fq", WORK) if prefix.endswith("_pe") else None
    return fq1, fq2


def golden_cl(prefix):
    """The argv the (non-PBAT) golden was mapped with, MANIFEST.md."""
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq"
            if prefix.endswith("_pe") else f"tests/{prefix}_1.fq")
    return (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
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
    """Phase 7: the mesh, the hybrid split and multi-host sharding.  trex
    is the tRex1 index of the goldens phases (its port engine is warm),
    rates this call's (port-only, native-only) rates by set."""
    import torch

    from abismal_tpu_torch.host import NativeShardServer, write_stats
    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import popcount_compare as pc
    from abismal_tpu_torch.map.pipeline import make_torch_native_engine_factory
    from abismal_tpu_torch.parallel.multihost import run_map_multihost

    kernels = (pc.popcount_compare, ba.banded_score, ba.banded_trace)
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
    for prefix in SPLIT_GOLDENS:
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
        mh[prefix] = rated({unit: n, "seconds": secs, f"{unit}_per_s": n / secs,
                            "sam_identical": sam_ok,
                            "mstats_identical": mst_ok}, prefix)
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

    def body(sam):
        return [ln for ln in sam.split(b"\n") if not ln.startswith(b"@PG")]

    same = body(gathered) == body(golden)
    check(same, "map --shard: the gathered shards differ from the golden")
    mh["shard_cli_" + SHARD_CLI_GOLDEN] = dict(
        seconds=secs, sam_identical_but_pg=same)
    out["multihost"] = mh
    return out, {name: sum(ls[name] for ls in launches.values())
                 for name in launches["mesh"]}


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

        sres, sets = phase_scale(dev, threads)
        emit("scale", **sres)

        rates = {"reads": (gres["reads"]["reads_per_s"],
                           gres["native_reads_per_s"]),
                 "reads_pe": (pres["reads_pe"]["pairs_per_s"],
                              pres["reads_pe"]["native_pairs_per_s"])}
        ores, launches_out = phase_scaleout(dev, threads, card, index, sets,
                                            rates)
        emit("scaleout", **ores)
        check("jax" not in sys.modules, "the port loaded jax")
        check(not [m for m in sys.modules
                   if m == "abismal_tpu" or m.startswith("abismal_tpu.")],
              "the port loaded the JAX package abismal_tpu")
    except Exception:
        traceback.print_exc()
        return 1

    print(card, flush=True)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCES[name],
             replaces=REPLACES[name],
             launches=(launches[name] + launches_pe.get(name, 0)
                       + launches_out[name]),
             max_abs_err=max(kres[k]["max_abs_err"] for k in kres
                             if k.startswith(name)), ms=kres[name]["ms"],
             plain_ms=kres[name]["plain_ms"],
             bound_ms=kres[name]["bound_ms"],
             bound_by=kres[name]["bound_by"],
             # no single PyTorch call computes any of the three functions
             library_ms=None) for name in REPLACES]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
