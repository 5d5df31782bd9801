"""The device tools' shared inputs, made with the port's own code (↔ the
JAX tools' __graft_entry__._tiny_index and their inline read set-up): the
tRex1 index, or a GB-scale one named by ABISMAL_PROFILE_INDEX and
ABISMAL_PROFILE_GENOME; the tRex1 index as a file, for the tools whose
shard processes load it; reads simulated from the profiled genome; one
chunk of them laid out as TorchNativeEngine lays it out; timed maps of
them, each with its SAM's md5; device timing.
Files go under build/abismal_tpu_torch/tools/ of the checkout."""

from __future__ import annotations

import hashlib
import importlib.util
import os
import resource
import time
from dataclasses import dataclass

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE = os.path.join(ROOT, "build", "abismal_tpu_torch", "tools")
TREX1_FA = os.path.join(ROOT, "tests", "data", "tRex1.fa")


def say(*args):
    """print, flushed: the tools' lines show as they are made."""
    print(*args, flush=True)


def cache_path(*parts: str) -> str:
    path = os.path.join(CACHE, *parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def add_common_args(ap, lmax: bool = True):
    """--device (cuda unless asked otherwise) and --threads; also --lmax
    (ABISMAL_PROFILE_LMAX, 128 by default) unless lmax is false."""
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    ap.add_argument("--threads", type=int,
                    default=min(8, os.cpu_count() or 1))
    if lmax:
        ap.add_argument("--lmax", type=int, default=int(os.environ.get(
            "ABISMAL_PROFILE_LMAX", 128)))


def profile_index(threads: int = 1):
    """(index, genome FASTA): ABISMAL_PROFILE_INDEX and
    ABISMAL_PROFILE_GENOME when set (a GB-scale index), else tRex1's,
    built with create_index (a second or two)."""
    from ..index.build import create_index
    from ..index.serialize import read_index

    path = os.environ.get("ABISMAL_PROFILE_INDEX")
    if path:
        return read_index(path), os.environ["ABISMAL_PROFILE_GENOME"]
    return create_index(TREX1_FA, n_threads=threads), TREX1_FA


def trex1_index_file(threads: int = 1) -> str:
    """Path of the tRex1 index file in the cache, made on first use with
    create_index and write_index: written to a name of this process and
    moved into place, so a reader never sees half a file."""
    path = cache_path("tRex1.idx")
    if not os.path.exists(path):
        from ..index.build import create_index
        from ..index.serialize import write_index

        tmp = f"{path}.tmp{os.getpid()}"
        write_index(create_index(TREX1_FA, n_threads=threads), tmp)
        os.replace(tmp, path)
    return path


def gen_genome(path: str, total: int):
    """tools/scale_test.py:gen_genome (the 1 Gb stand-in for hg38), loaded
    from its file, so that tools/ does not go on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "scale_test", os.path.join(ROOT, "tools", "scale_test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.gen_genome(path + ".tmp", total)
    os.replace(path + ".tmp", path)


def scale_genome(size_mb: int) -> str:
    """The synthetic genome of size_mb megabases, made on first use."""
    fa = cache_path(f"scale_{size_mb}mb.fa")
    if not os.path.exists(fa):
        gen_genome(fa, size_mb * 1_000_000)
    return fa


def simulate(genome: str, n: int, paired: bool = False, seed: int = 1,
             mutation: float = 0.01, read_length: int = 100,
             max_frag: int = 250) -> list[str]:
    """FASTQ paths of n simulated reads (pairs) from genome (bs_conv 0.98),
    made on first use."""
    from ..sim.simreads import SimConfig, simulate_reads

    key = hashlib.md5(repr((os.path.abspath(genome), n, paired, seed,
                            mutation, read_length, max_frag)).encode()
                      ).hexdigest()[:12]
    prefix = cache_path("sim", key, "r")
    paths = [f"{prefix}_{e}.fq" for e in ((1, 2) if paired else (1,))]
    if not all(os.path.exists(p) for p in paths):
        simulate_reads(genome, SimConfig(
            output_prefix=prefix, n_reads=n, mutation_rate=mutation,
            bs_conv=0.98, seed=seed, single_end=not paired,
            read_length=read_length, min_frag_len=read_length,
            max_frag_len=max(read_length, max_frag)))
    return paths


def load_reads(path: str, n: int):
    from ..io.fastq import ReadLoader

    return ReadLoader(path, batch_size=n).load_batch()[:n]


def engine(index, device, unit_batch: int = 2048, lmax: int = 128,
           threads: int = 1):
    from ..map.pipeline import TorchNativeEngine

    return TorchNativeEngine(index, lmax=lmax, unit_batch=unit_batch,
                             n_threads=threads, device=device)


# upstream's SAM of the 10k golden reads (tests/golden/reads.sam.gz),
# which the simulator's seed-1 reads equal, and the argv its @PG line holds
GOLDEN_SAM_MD5 = "8126d46074213ad3674181f4ea4f8bd1"
GOLDEN_CL = ("map -s tests/reads.mstats -o tests/reads.sam -i "
             "tests/tRex1.idx tests/reads_1.fq")


def md5(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


def truth_md5(index, fq1, fq2, sam, threads: int, golden: bool) -> str:
    """The md5 that a verified SAM of fq1 (and fq2), mapped with command
    line GOLDEN_CL, has: upstream's golden (golden: the 10k seed-1 reads on
    tRex1), else the native engine's output on the same reads, which it
    writes to sam."""
    from ..map.engine import run_map
    from ..map.host_units import make_native_engine_factory

    if golden:
        return GOLDEN_SAM_MD5
    run_map(index, fq1, fq2, sam, None, GOLDEN_CL,
            engine_factory=make_native_engine_factory(n_threads=threads),
            threads=threads)
    return md5(sam)


def cpu_s() -> float:
    """This process's CPU seconds so far, user and system (getrusage)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def timed_maps(index, fq1, fq2, sam, factory, threads: int, reps: int,
               before=None):
    """A warm map of fq1 (and fq2) into sam by factory's engine, command
    line GOLDEN_CL, then reps timed ones, before() called ahead of each:
    (the warm map's seconds, one (wall seconds, process CPU seconds, the
    SAM's md5) a timed map)."""
    from ..map.engine import run_map

    def once():
        run_map(index, fq1, fq2, sam, None, GOLDEN_CL,
                engine_factory=factory, threads=threads)

    t0 = time.perf_counter()
    once()  # warm: engine tables, the kernels' build, first copies
    warm = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        if before is not None:
            before()
        c0, t0 = cpu_s(), time.perf_counter()
        once()
        wall, cpu = time.perf_counter() - t0, cpu_s() - c0
        runs.append((wall, cpu, md5(sam)))
    return warm, runs


def engine_factory(eng):
    """A run_map engine factory that hands out eng for every run, so its
    counters and timers add up over the runs, and that holds no memo: eng
    goes when the caller drops it."""

    def factory(*_args):
        return eng

    factory.is_native = True
    return factory


@dataclass
class Chunk:
    """One chunk of B units as the engine dispatches it: args, the host
    arrays of the program after the tables; per units a read; n_units
    of them hold reads; budget and ext_pool, the engine's informed
    candidate budget and extension pool."""

    args: tuple
    per: int
    n_units: int
    budget: int
    ext_pool: int | None

    def on(self, eng):
        return tuple(eng._put(a) for a in self.args)


def _fit(pnib, lens, B):
    pnib, lens = pnib[:B], lens[:B]
    pad = B - pnib.shape[0]
    if pad:
        pnib = np.pad(pnib, ((0, pad), (0, 0)))
        lens = np.pad(lens, (0, pad))
    return pnib, lens


def se_chunk(eng, reads, a_rich: bool = False,
             random_pbat: bool = False) -> Chunk:
    """The first chunk of reads for build_stage12, as dispatch_se makes it:
    (pnib, lens, is_ga, scode, max_diffs_r)."""
    from ..map.host_units import _se_scode_pattern, get_conv_is_ga

    pnib, lens, per, _ = eng._se_units_mat(reads, a_rich, random_pbat)
    scode = _se_scode_pattern(a_rich, random_pbat)
    is_ga_pat = np.array([get_conv_is_ga(int(c)) for c in scode], bool)
    budget = eng._budget_for((pnib, lens), is_ga_pat, per)
    B = max(per, eng.unit_batch - eng.unit_batch % per)
    n_units = min(B, pnib.shape[0])
    pnib, lens = _fit(pnib, lens, B)
    rpc = B // per
    lens_r = lens.reshape(rpc, per).max(axis=1)
    md = (eng.valid_frac * lens_r.astype(np.float64)).astype(np.int32)
    return Chunk((pnib, lens, np.tile(is_ga_pat, rpc), scode, md), per,
                 n_units, budget, eng._informed_ext_pool())


def pe_chunk(eng, reads1, reads2, random_pbat: bool = False) -> Chunk:
    """The first chunk of pairs for build_stage12pe, as dispatch_pe makes
    it: (pnib, lens, is_ga, max_diffs_u, pe_dist)."""
    from ..map.host_units import _pe_is_ga_pattern

    pnib, lens, per, _ = eng._pe_units_mat(reads1, reads2, False,
                                           random_pbat)
    is_ga_pat = _pe_is_ga_pattern(False, random_pbat)
    budget = eng._budget_for((pnib, lens), is_ga_pat, per)
    B = max(per, eng.unit_batch - eng.unit_batch % per)
    n_units = min(B, pnib.shape[0])
    pnib, lens = _fit(pnib, lens, B)
    md = (eng.valid_frac * lens.astype(np.float64)).astype(np.int32)
    pe_dist = np.array([eng.native.pe_min_dist, eng.native.pe_max_dist],
                       np.int32)
    return Chunk((pnib, lens, np.tile(is_ga_pat, B // per), md, pe_dist),
                 per, n_units, budget, eng._informed_ext_pool())


def stage12_prog(eng, chunk: Chunk, cut=None, paired: bool = False):
    """The engine's fused program for chunk (its budget and pool), cut at
    cut (None: the whole program, as the engine runs it)."""
    from ..map.pipeline import build_stage12, build_stage12pe

    dev = eng.dev
    common = dict(cand_per_unit=chunk.budget, ext_iters=dev.ext_iters,
                  ext_pool=chunk.ext_pool, cut=cut)
    if paired:
        build = build_stage12pe
        common["per"] = chunk.per
        pos = ()
    else:
        build = build_stage12
        common["device_tb"] = eng.device_tb
        pos = (chunk.per,)
    prog, _ = build(eng.lmax, dev.max_candidates, dev.n_index2,
                    dev.n_index3, *pos, **common)
    return prog


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, reps: int, device) -> float:
    """Mean time of one fn() (ms) over reps calls back to back, after one
    warm call: CUDA events on a card (the device's span of the enqueued
    work, the host's launch gaps included where the device waits on
    them), the host clock on the CPU."""
    import torch

    fn()
    sync(device)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / reps
