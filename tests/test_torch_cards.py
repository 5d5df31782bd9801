"""The port's mesh on the card: two slots on one card, and every card of
a machine with two or more.  The fused programs and the event-stream
route (shard_stage12(pe), shard_stage1 on one slot each), and the
key-range-sharded index (shard_stage1_tp), map the small goldens byte
for byte.  Every case needs a card (the "all" cases two)
and skips without.  Nothing here imports the JAX package or another
module of tests/ (a machine with cards may have an installed package
named `tests` that shadows this directory), so the cases run where
neither is importable."""

import gc
import gzip
import os
import shutil

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")

pytestmark = [pytest.mark.cuda, pytest.mark.skipif(
    not torch.cuda.is_available(), reason="needs a CUDA card")]


@pytest.fixture(scope="module")
def trex1(tmp_path_factory):
    """(the tRex1 index built with the port, a directory for the
    decompressed goldens); the engines built on it are dropped after the
    module."""
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.map import pipeline

    yield (create_index(os.path.join(HERE, "data", "tRex1.fa")),
           tmp_path_factory.mktemp("goldens"))
    pipeline._engine_memo.clear()
    gc.collect()


def _gunzip(name, out_dir):
    out = out_dir / name
    if not out.exists():
        with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rb") as f, \
                open(out, "wb") as g:
            shutil.copyfileobj(f, g)
    return str(out)


@pytest.fixture(params=["slots", "all"])
def card_mesh(request):
    """(mesh_devices, slots): two slots on cuda:0, or every card."""
    if request.param == "slots":
        return ["cuda:0", "cuda:0"], 2
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return "all", torch.cuda.device_count()


def _map_golden(tmp_path, trex1, prefix, fac, pbat=False):
    from abismal_tpu_torch.map.engine import run_map

    index, goldens = trex1
    paired = prefix.endswith("_pe")
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    flag = "-P " if pbat else ""
    cl = (f"map {flag}-s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    run_map(index, _gunzip(prefix + "_1.fq", goldens),
            _gunzip(prefix + "_2.fq", goldens) if paired else None, str(sam),
            str(mst), cl, engine_factory=fac, threads=2, pbat=pbat)
    for path, ext in ((sam, ".sam.gz"), (mst, ".mstats.gz")):
        with gzip.open(os.path.join(GOLDEN, prefix + ext), "rt") as f:
            assert path.read_text() == f.read()
    return fac(index, False, 0.1, 32, 3000)


@pytest.mark.parametrize("stage2", [True, False], ids=["fused", "events"])
@pytest.mark.parametrize("prefix", ["small", "small_pe"])
def test_card_mesh_gives_the_goldens(tmp_path, trex1, card_mesh, prefix,
                                     stage2):
    """run_map over the mesh, 128 units a slot."""
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    spec, slots = card_mesh
    fac = make_torch_native_engine_factory(
        "cuda", unit_batch=128 * slots, n_threads=2, mesh_devices=spec,
        device_stage2=stage2)
    assert _map_golden(tmp_path, trex1, prefix, fac).n_shards == slots


@pytest.mark.parametrize("prefix", ["small", "small_pe"])
def test_card_index_shards_give_the_goldens(tmp_path, trex1, card_mesh,
                                            prefix):
    """run_map with the index split over the mesh's slots, every slot
    mapping every chunk of 128 units; the genome and counters once per
    card."""
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    spec, slots = card_mesh
    fac = make_torch_native_engine_factory(
        "cuda", unit_batch=128, n_threads=2, index_shards=spec)
    eng = _map_golden(tmp_path, trex1, prefix, fac)
    assert eng.tp.n_shards == slots
    counters = {id(slot[1]) for slot in eng.tp.slots}
    assert len(counters) == (1 if spec != "all" else slots)


# --- the device programs as CUDA graphs (abismal_tpu_torch/graphs.py) ------

def _load_reads(trex1, prefix, n):
    from abismal_tpu_torch.io.fastq import ReadLoader

    return ReadLoader(_gunzip(prefix, trex1[1]), batch_size=n).load_batch()[:n]


def _batch_tensors(handle):
    """Every tensor of a dispatched batch's handle, in order, once its
    collection (the event route's future) is done."""
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


GRAPH_ROUTES = {
    "fused_se": (dict(), "se"),
    "fused_pe": (dict(), "pe"),
    "events_align": (dict(device_stage2=False, device_align=True), "se"),
    "index_shards": (dict(index_shards=["cuda:0", "cuda:0"]), "se"),
    "mesh_se": (dict(mesh_devices=["cuda:0", "cuda:0"]), "se"),
    "mesh_pe": (dict(mesh_devices=["cuda:0", "cuda:0"]), "pe"),
    "mesh_events": (dict(mesh_devices=["cuda:0", "cuda:0"],
                         device_stage2=False), "se"),
    "replay": (None, "units"),
}


@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_card_graphed_rows_equal_eager(trex1, route):
    """Each route's device outputs on three chunks of 256 units: replayed
    from its captured graph, bit-equal to the eager program's; the first
    chunk runs the warm program, the others replay."""
    from abismal_tpu_torch.map.pipeline import (
        TorchMappingEngine, TorchNativeEngine,
    )

    index = trex1[0]
    kw, kind = GRAPH_ROUTES[route]
    outs, engines = [], []
    for graphs in (False, True):
        if kw is None:
            eng = TorchMappingEngine(index, unit_batch=256, device="cuda",
                                     graphs=graphs)
        else:
            eng = TorchNativeEngine(index, unit_batch=256, n_threads=2,
                                    device="cuda", graphs=graphs, **kw)
        engines.append(eng)
        if kind == "pe":
            n = 3 * 256 // 4
            handle = eng.dispatch_pe(_load_reads(trex1, "small_pe_1.fq", n),
                                     _load_reads(trex1, "small_pe_2.fq", n),
                                     False, False)
        else:
            reads = _load_reads(trex1, "small_1.fq", 3 * 256 // 2)
            handle = (eng._dispatch_units(eng._se_units(reads, False, False))
                      if kind == "units" else
                      eng.dispatch_se(reads, False, False))
        outs.append(_batch_tensors(handle))
        torch.cuda.synchronize()
    eager, graphed = outs
    assert len(eager) == len(graphed) > 0
    for a, b in zip(eager, graphed):
        assert a.dtype == b.dtype and torch.equal(a, b)
    stats = engines[1].graphs.stats()
    assert stats and sum(s["replays"] for s in stats) >= 2
    for eng in engines:
        if hasattr(eng, "close"):
            eng.close()


@pytest.mark.parametrize("stage2", [True, False], ids=["fused", "events"])
@pytest.mark.parametrize("prefix", ["small", "small_pe"])
def test_card_graphs_give_the_goldens(tmp_path, trex1, prefix, stage2):
    """run_map on one card with the programs as CUDA graphs (the default
    there), 256 units a chunk: the goldens byte for byte, and the kernel
    counters grow at every replay."""
    from abismal_tpu_torch.kernels.popcount_compare import popcount_compare
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    fac = make_torch_native_engine_factory(
        "cuda", unit_batch=256, n_threads=2, device_stage2=stage2)
    eng = fac(trex1[0], False, 0.1, 32, 3000)
    n0 = len(eng.graphs.stats())
    r0 = sum(s["replays"] for s in eng.graphs.stats())
    k0 = popcount_compare.launches
    _map_golden(tmp_path, trex1, prefix, fac)
    stats = eng.graphs.stats()
    replays = sum(s["replays"] for s in stats) - r0
    assert replays >= 2
    # one warm run of each key captured here, then one K1 a replay
    assert popcount_compare.launches - k0 == replays + len(stats) - n0


@pytest.mark.parametrize("prefix,pbat", [
    ("reads_pe", False), ("reads_pbat_pe", True), ("reads_rpbat_pe", True)])
def test_card_pe_goldens_at_lmax_160(tmp_path, trex1, prefix, pbat):
    """The 10k-pair goldens (the rpbat ones mapped with -P, as in
    tests/golden/MANIFEST.md) through the graphed fused PE program at
    lmax 160, 2048 units a chunk: byte for byte, with K1 launched."""
    from abismal_tpu_torch.kernels.popcount_compare import popcount_compare
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    fac = make_torch_native_engine_factory("cuda", lmax=160, n_threads=2)
    k0 = popcount_compare.launches
    eng = _map_golden(tmp_path, trex1, prefix, fac, pbat=pbat)
    assert eng.lmax == 160 and eng.n_oversized == 0
    assert popcount_compare.launches > k0


def _rpbat_reads(seq, n, rng, length=150):
    """n random-PBAT reads of `length` bases from seq (str): either
    strand, 1% substitutions, then each read T-rich (C->T at 98%) or
    A-rich (G->A) with equal chance."""
    import numpy as np

    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for i in range(n):
        p = int(rng.integers(0, len(seq) - length))
        s = seq[p : p + length]
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        s = list(s)
        for k in np.flatnonzero(rng.random(length) < 0.01):
            s[k] = "ACGT"[("ACGT".index(s[k]) + 1) % 4]
        frm, to = ("C", "T") if rng.random() < 0.5 else ("G", "A")
        conv = rng.random(length) < 0.98
        s = "".join(to if c == frm and k else c for c, k in zip(s, conv))
        out.append((f"r{i}", s.encode()))
    return out


def test_card_rpbat_se_150bp_at_lmax_160(tmp_path):
    """Random-PBAT single-end 150 bp reads of a random 2 Mb genome through
    the graphed fused SE program at lmax 160 (4 units a read, K3 on
    160-nibble rows): the native engine's SAM and stats byte for byte,
    CV:A and CV:T winners both written, no read over lmax."""
    import io

    import numpy as np

    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.kernels.banded_align import banded_trace_packed
    from abismal_tpu_torch.map import pipeline
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.stats import SEStats

    rng = np.random.default_rng(29)
    seq = "".join(rng.choice(list("ACGT"), size=2_000_000))
    fa = tmp_path / "g.fa"
    fa.write_text(">chr1\n" + "\n".join(seq[i : i + 80] for i in
                                         range(0, len(seq), 80)) + "\n")
    index = create_index(str(fa))
    rd = _rpbat_reads(seq, 3000, rng)
    eng = pipeline.TorchNativeEngine(index, lmax=160, n_threads=2,
                                     device="cuda")
    k0 = banded_trace_packed.launches
    outs = []
    for e in (eng, NativeMappingEngine(index, n_threads=2)):
        out, st = io.StringIO(), SEStats()
        for b in range(0, len(rd), 1000):
            e.map_se_reads(rd[b : b + 1000], False, True, st, out)
        outs.append((out.getvalue(), st.tostring("stats")))
    eng.close()
    assert outs[0] == outs[1]
    sam = outs[0][0]
    assert sam.count("\tCV:A:A") > 1000 and sam.count("\tCV:A:T") > 1000
    assert eng.n_units == 4 * len(rd) and eng.n_oversized == 0
    assert sum(s["replays"] for s in eng.graphs.stats()) > 0
    assert banded_trace_packed.launches > k0
    del eng
    gc.collect()
