"""The port's device programs as CUDA graphs (abismal_tpu_torch/graphs.py),
on the CPU.

Capturability: every program the engines capture (build_stage12,
build_stage12pe, build_stage1 with tp off and on) runs on a chunk of
golden reads under a dispatch mode that refuses what a capture refuses
or a replay cannot repeat: a host sync (aten._local_scalar_dense: any
.item(), int() or bool() of a tensor), an output shaped by the data
(nonzero, masked_select, unique*, repeat_interleave by a tensor,
indexing with a bool mask) and a tensor made from Python data
(aten.lift_fresh).  K1-K3 are left out of the mode: on the card each is
one launch of its CUDA wrapper, and their plain CPU versions are not held
to it.  The plain versions of K4 (the seed extension), K5 (the slot
ranks) and K6 (the candidate list) stay in it: the card smoke captures
them in the engines it compares those kernels with.

The wrapper's bookkeeping: torch.cuda.CUDAGraph cannot run here, so a
stand-in takes the place of graphs.capture; its replay runs the program
again on the static buffers and writes its outputs into the captured
ones, leaving the kernel counters as they were (a replay runs no
Python).  With it, run_map through the engine's graphed routes (fused
SE, fused PE, the event route with device_align), several chunks in
flight before each finish, gives the goldens and the eager engine's
kernel counts; no pending output aliases a static buffer.  Nothing of
the main path uses the stand-in.  The plain kernel versions count here
as their CUDA wrappers count on the card, so that the counts move."""

import gzip
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _disable_current_modes,
)

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, golden_file, port_index, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

UNIT_BATCH = 128  # 64 reads or 32 pairs a chunk: 4-8 chunks a batch


class CaptureGuard(TorchDispatchMode):
    """Records every op that a CUDA graph capture refuses or that makes a
    captured program's shapes or values depend on the data."""

    SHAPED_BY_DATA = ("nonzero", "masked_select")

    def __init__(self):
        super().__init__()
        self.refused = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        bad = (name in ("_local_scalar_dense", "lift_fresh")
               or name in self.SHAPED_BY_DATA
               or name.lstrip("_").startswith("unique")
               or (func is torch.ops.aten.repeat_interleave.Tensor
                   and kwargs.get("output_size") is None))
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            bad = bad or any(torch.is_tensor(t) and t.dtype == torch.bool
                             for t in args[1])
        if bad:
            self.refused.append(str(func))
        return func(*args, **kwargs)


def _outside_the_mode(fn):
    def call(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return call


@pytest.fixture
def kernels_outside_the_mode(monkeypatch):
    from abismal_tpu_torch.map import pipeline

    for name in ("popcount_compare", "banded_score_packed",
                 "banded_trace_packed"):
        monkeypatch.setattr(pipeline, name,
                            _outside_the_mode(getattr(pipeline, name)))


@pytest.fixture(scope="module")
def engine(port_index):
    """An eager CPU engine of this module's own (the memoized ones hold a
    GB of tables each)."""
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    eng = TorchNativeEngine(port_index, unit_batch=UNIT_BATCH, n_threads=2,
                            device="cpu")
    yield eng
    eng.close()


def _reads(prefix, n):
    from abismal_tpu_torch.tools._workload import load_reads

    return load_reads(golden_file(prefix), n)


def _guarded(prog, *args, **kwargs):
    guard = CaptureGuard()
    with guard:
        out = prog(*args, **kwargs)
    return out, guard.refused


def test_stage12_is_capturable(engine, kernels_outside_the_mode):
    from abismal_tpu_torch.tools import _workload as W

    chunk = W.se_chunk(engine, _reads("small_1.fq", UNIT_BATCH // 2))
    prog = engine._stage12_prog(chunk.per, chunk.budget)
    rows, refused = _guarded(prog, *engine.dev.tables(), *chunk.on(engine))
    assert refused == []
    assert rows.shape[0] == UNIT_BATCH // chunk.per


def test_stage12pe_is_capturable(engine, kernels_outside_the_mode):
    from abismal_tpu_torch.tools import _workload as W

    n = UNIT_BATCH // 4
    chunk = W.pe_chunk(engine, _reads("small_pe_1.fq", n),
                       _reads("small_pe_2.fq", n))
    prog = engine._stage12pe_prog(chunk.per, chunk.budget)
    rows, refused = _guarded(prog, *engine.dev.tables(), *chunk.on(engine))
    assert refused == []
    assert rows.shape[0] == UNIT_BATCH


def _stage1_args(engine):
    """The event route's first chunk of small_1.fq's units, as
    _dispatch_events makes it: (pnib, lens, is_ga, thr), and the engine's
    candidate budget."""
    from abismal_tpu_torch.tools import _workload as W

    pnib, lens, is_ga, _, _ = W.se_chunk(
        engine, _reads("small_1.fq", UNIT_BATCH // 2)).args
    thr = ((2 * lens.astype(np.int64)) // 5).astype(np.int32)
    return (pnib, lens, is_ga, thr), engine.cand_budget


@pytest.mark.parametrize("tp", [False, True], ids=["index", "shard"])
def test_stage1_is_capturable(engine, port_index, kernels_outside_the_mode,
                              tp):
    from abismal_tpu_torch.device import put
    from abismal_tpu_torch.map.pipeline import DeviceIndexTP, build_stage1

    args, budget = _stage1_args(engine)
    if not tp:
        prog = engine._stage1_prog(budget)
        bound, kw = engine.dev.tables(), {}
    else:  # shard 1 of 2: its own lists and key bounds
        shards = DeviceIndexTP(port_index, [torch.device("cpu")] * 2)
        prog, _ = build_stage1(engine.lmax, shards.max_candidates,
                               shards.P2, shards.P3,
                               ext_iters=shards.ext_iters, tp=True)
        *bound, shard = shards.slots[1]
        kw = dict(shard=shard)
    (ev, cf), refused = _guarded(prog, *bound,
                                 *(put(a, "cpu") for a in args), **kw)
    assert refused == []
    assert ev.shape[0] == 2 and cf.shape[0] == UNIT_BATCH


def test_guard_refuses_what_a_capture_refuses():
    """The guard sees each kind it is there for (torch on the CPU shows
    them all under a dispatch mode)."""
    x = torch.arange(8)
    cases = {
        "_local_scalar_dense": lambda: bool(x.any()),
        "lift_fresh": lambda: torch.tensor([[0], [1]]),
        "nonzero": lambda: x.nonzero(),
        "masked_select": lambda: x.masked_select(x > 2),
        "unique": lambda: torch.unique(x),
        "repeat_interleave": lambda: x.repeat_interleave(x),
        "bool index": lambda: x[x > 3],
        "bool index_put_": lambda: x.clone().index_put_((x > 3,), x[:1]),
    }
    for what, fn in cases.items():
        _, refused = _guarded(fn)
        assert refused, what
    _, refused = _guarded(
        lambda: torch.full((3,), 5).repeat_interleave(2)[:3]
        + x[torch.arange(3)])
    assert refused == []


# --- the wrapper's bookkeeping, with a stand-in for the CUDA graph ---------

def test_engines_run_graphs_on_a_card_alone():
    """use_graphs: Graphs for a CUDA device unless graphs is False, the
    eager programs otherwise (the CPU is the caller asking for it)."""
    from abismal_tpu_torch.graphs import Eager, Graphs, use_graphs

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert isinstance(use_graphs(True, cuda), Graphs)
    assert isinstance(use_graphs(False, cuda), Eager)
    assert isinstance(use_graphs(True, cpu), Eager)
    assert isinstance(use_graphs(False, cpu), Eager)


class StandInGraph:
    """Replays by running the program again on the static buffers and
    writing its outputs into the captured ones; the kernel counters stay
    as they were (a replay runs no Python)."""

    def __init__(self, fn, out):
        self.fn = fn
        self.out = (out,) if torch.is_tensor(out) else tuple(out)

    def replay(self):
        from abismal_tpu_torch.graphs import COUNTED

        counts = [k.launches for k in COUNTED]
        new = self.fn()
        for k, c in zip(COUNTED, counts):
            k.launches = c
        for o, n in zip(self.out, (new,) if torch.is_tensor(new) else new):
            o.copy_(n)


def _stand_in_capture(fn, pool, stream):
    out = fn()
    return StandInGraph(fn, out), out


@pytest.fixture
def stand_in(monkeypatch):
    """graphs.capture replaced by the stand-in, and each kernel's plain
    version counting a launch of its wrapper, as the CUDA launch does."""
    from abismal_tpu_torch import graphs
    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import candidate_list as cl
    from abismal_tpu_torch.kernels import popcount_compare as pc
    from abismal_tpu_torch.kernels import seed_extend as se
    from abismal_tpu_torch.kernels import segment_rank as sr
    from abismal_tpu_torch.map import pipeline

    monkeypatch.setattr(graphs, "capture", _stand_in_capture)
    for mod, plain, wrapper in (
            (pc, "popcount_compare_plain", pc.popcount_compare),
            (ba, "banded_score_packed_plain", ba.banded_score_packed),
            (ba, "banded_trace_packed_plain", ba.banded_trace_packed),
            (se, "seed_extend_plain", se.seed_extend),
            (sr, "segment_rank_plain", sr.segment_rank),
            (cl, "candidate_list_plain", cl.candidate_list)):
        def counting(*args, _inner=getattr(mod, plain), _w=wrapper):
            _w.launches += 1
            return _inner(*args)
        monkeypatch.setattr(mod, plain, counting)
    monkeypatch.setattr(pipeline, "_engine_memo", {})
    return graphs.COUNTED


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def _map(tmp_path, index, eng, prefix, pbat=False):
    """run_map of a golden set with eng; (SAM, mstats, launches by
    kernel during it)."""
    from abismal_tpu_torch.graphs import COUNTED
    from abismal_tpu_torch.map.engine import run_map
    from abismal_tpu_torch.tools._workload import engine_factory

    paired = prefix.endswith("_pe")
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map {'-P ' if pbat else ''}-s tests/{prefix}.mstats -o "
          f"tests/{prefix}.sam -i tests/tRex1.idx {tail}")
    before = [k.launches for k in COUNTED]
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    run_map(index, golden_file(prefix + "_1.fq"),
            golden_file(prefix + "_2.fq") if paired else None, str(sam),
            str(mst), cl, pbat=pbat, engine_factory=engine_factory(eng),
            threads=2)
    moved = {k.__name__: k.launches - c for k, c in zip(COUNTED, before)}
    return sam.read_text(), mst.read_text(), moved


@pytest.mark.parametrize("prefix,stage2,align,kernels", [
    ("small", True, False, 6),  # fused SE: K1-K6
    ("small_pe", True, False, 5),  # fused PE: K1, K2, K4, K5, K6
    ("small", False, True, 4),  # the event route with device_align: K1,
    # K2, K4, K6
], ids=["fused-se", "fused-pe", "events-align"])
def test_graphed_routes_give_the_goldens(tmp_path, port_index, stand_in,
                                         prefix, stage2, align, kernels):
    """Graphed and eager, one engine (given a Graphs, then an Eager): the
    goldens, equal kernel counts, and every chunk after a key's first a
    replay."""
    from abismal_tpu_torch.graphs import Eager, Graphs
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    eng = TorchNativeEngine(port_index, unit_batch=UNIT_BATCH, n_threads=2,
                            device="cpu", device_stage2=stage2,
                            device_align=align, align_jcap=256)
    assert isinstance(eng.graphs, Eager)  # the CPU: the eager programs
    eng.graphs = Graphs()
    try:
        graphed = _map(tmp_path, port_index, eng, prefix)
        stats = eng.graphs.stats()
        eng.graphs = Eager()
        eager = _map(tmp_path, port_index, eng, prefix)
    finally:
        eng.close()
    assert graphed[:2] == (_golden(prefix + ".sam"),
                           _golden(prefix + ".mstats"))
    assert eager[:2] == graphed[:2]
    assert graphed[2] == eager[2]
    assert sum(n > 0 for n in graphed[2].values()) == kernels
    assert len(stats) == 1 and stats[0]["replays"] >= 3
    assert stats[0]["captured_launches"]["popcount_compare"] == 1
    assert stats[0]["captured_launches"]["seed_extend"] == 1
    assert stats[0]["captured_launches"]["candidate_list"] == 1


def test_pending_rows_are_not_static_buffers(port_index, stand_in):
    """dispatch_se's pending rows of four chunks equal the eager
    program's and share no storage with a graph's static inputs or
    outputs; the counters grow by the captured launches at each
    replay."""
    from abismal_tpu_torch.graphs import Eager, Graphs
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    eng = TorchNativeEngine(port_index, unit_batch=UNIT_BATCH, n_threads=2,
                            device="cpu")
    eng.graphs = Graphs()
    reads = _reads("small_1.fq", 2 * UNIT_BATCH)
    k1 = stand_in[0]
    n0 = k1.launches
    handle = eng.dispatch_se(reads, False, False)
    pending = handle[4]
    assert len(pending) == 4
    (gp,) = eng.graphs._graphs.values()
    assert gp.replays == 3 and k1.launches - n0 == 4
    static = {t.untyped_storage().data_ptr()
              for t in gp.inputs + gp.outputs}
    graphs, eng.graphs = eng.graphs, Eager()
    eager = eng.dispatch_se(reads, False, False)[4]
    assert k1.launches - n0 == 8
    for (s, n, rows, _), (s2, n2, want, _) in zip(pending, eager):
        assert (s, n) == (s2, n2)
        assert rows.untyped_storage().data_ptr() not in static
        assert torch.equal(rows, want)
    assert graphs.stats()[0]["captured_launches"] == {
        "popcount_compare": 1, "banded_score_packed": 1,
        "banded_trace_packed": 1, "seed_extend": 1, "segment_rank": 1,
        "candidate_list": 1}
    eng.close()
