"""The port's replay engines (replay_events, TorchMappingEngine,
EventReplayEngine, make_torch_engine_factory) on the CPU, with the plain
kernel versions: the replay against the JAX package's on the same
candidate sets and events, and whole `map` runs, in one process and
through run_map_hybrid's forked workers, against the goldens (↔ tests/
test_pipeline.py).  Every comparison is exact."""

import gzip
import os

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, golden_file, port_index, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def _cl(prefix, paired):
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    return (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
            f"-i tests/tRex1.idx {tail}")


def _seeded_events(rng, o_spec):
    """One unit's events: ranks ascending across both phases, diffs with
    exact hits and repeats, positions that repeat (duplicates)."""
    n = int(rng.integers(0, 300))
    boundary = o_spec * 2 * 128
    rank = np.sort(rng.integers(0, 2 * boundary, n)).astype(np.int32)
    diffs = rng.integers(0, 14, n).astype(np.int32)
    diffs[rng.random(n) < 0.05] = 0
    pos = rng.integers(1, 3000, n).astype(np.uint32)
    return pos, diffs, rank, n


@pytest.mark.parametrize("kind", ["SECandidates", "PECandidates"])
def test_replay_events_matches_jax(kind):
    """The port's replay_events and the JAX package's, on the same
    seeded events into fresh candidate sets of both packages (specific
    and sensitive events, sure-ambig aborts, full heaps), leave the sets
    in the same state."""
    from abismal_tpu.map import candidates as ref_c
    from abismal_tpu.map.pipeline import replay_events as ref_replay
    from abismal_tpu_torch.map import candidates as own_c
    from abismal_tpu_torch.map.host_units import o_spec_for
    from abismal_tpu_torch.map.pipeline import replay_events

    o_spec = o_spec_for(128)
    rng = np.random.default_rng(4)
    sizes = []
    for _ in range(60):
        readlen = int(rng.integers(50, 129))
        sc = int(rng.choice([0, 0x10, 0x1000, 0x1010]))
        ev = _seeded_events(rng, o_spec)
        a, b = getattr(own_c, kind)(), getattr(ref_c, kind)()
        a.reset(readlen)
        b.reset(readlen)
        replay_events(a, sc, *ev, o_spec)
        ref_replay(b, sc, *ev, o_spec)
        assert vars(a) == vars(b)
        sizes.append(a.sz)
    assert max(sizes) > 1


def _map(tmp_path, index, prefix, threads, factory):
    from abismal_tpu_torch.map.engine import run_map

    paired = prefix.endswith("_pe")
    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    run_map(index, fq1, fq2, str(sam), str(mst), _cl(prefix, paired),
            engine_factory=factory, threads=threads)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")


@pytest.mark.parametrize("prefix", ["small", "small_pe"])
def test_torch_replay_engine_gives_the_goldens(tmp_path, port_index, prefix,
                                               monkeypatch):
    """TorchMappingEngine(device="cpu") through run_map: build_stage1's
    events replayed by the exact engine give the goldens (↔ tests/
    test_pipeline.py::test_tpu_engine_parity); the units it sent to the
    host are counted."""
    from abismal_tpu_torch.map import pipeline

    monkeypatch.setattr(pipeline, "_engine_memo", {})
    factory = pipeline.make_torch_engine_factory("cpu", unit_batch=128)
    _map(tmp_path, port_index, prefix, 1, factory)
    eng = factory(port_index, False, 0.1, 32, 3000)
    assert isinstance(eng, pipeline.TorchMappingEngine)
    assert eng.device == torch.device("cpu")
    assert 0 <= eng.n_fallback < eng.n_units


def test_hybrid_runner_gives_the_golden(tmp_path, port_index, monkeypatch):
    """-t 3 with the replay factory: stage 1 in this process, the replay
    in three forked EventReplayEngine workers, output in batch order:
    the golden (↔ tests/test_pipeline.py::test_hybrid_runner_parity)."""
    from abismal_tpu_torch.map import pipeline

    monkeypatch.setattr(pipeline, "_engine_memo", {})
    factory = pipeline.make_torch_engine_factory("cpu", unit_batch=128)
    _map(tmp_path, port_index, "small", 3, factory)
    assert factory(port_index, False, 0.1, 32, 3000).n_units > 0
