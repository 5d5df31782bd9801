"""The port's exact host engine (map/align.py, map/candidates.py,
map/seeds.py, MappingEngine in map/engine.py) and its process runners
(map/runner.py) on the CPU: the copies against the JAX package's on
seeded inputs, and whole `map` runs against the goldens (↔ tests/
test_map.py).  Every comparison is exact: integers, heap states, SAM and
mstats bytes."""

import gzip
import os

import numpy as np
import pytest

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, golden_file, port_index, ref_index, release_engines,
)

CASES = [
    ("small", False, False),
    ("small_pe", True, False),
    ("small_pbat_pe", True, True),
    ("small_rpbat_pe", True, True),  # upstream maps RPBAT reads with -P
]


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def _cl(prefix, paired, pbat=False):
    flag = "-P " if pbat else ""
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    return (f"map {flag}-s tests/{prefix}.mstats -o tests/{prefix}.sam "
            f"-i tests/tRex1.idx {tail}")


def test_band_width_and_edit_distance_match_jax():
    """band_width over negative, small and capped diffs, and edit_distance
    over seeded scores and cigars of M, I and D runs."""
    from abismal_tpu.map import align as ref
    from abismal_tpu_torch.constants import (
        CIGAR_DEL, CIGAR_INS, CIGAR_MATCH, CIGAR_SHIFT,
    )
    from abismal_tpu_torch.map import align as own

    for diffs in range(-8, 40):
        for max_diffs in (0, 1, 5, 10, 25, 40):
            assert (own.band_width(diffs, max_diffs)
                    == ref.band_width(diffs, max_diffs))
    rng = np.random.default_rng(7)
    ops = (CIGAR_MATCH, CIGAR_INS, CIGAR_DEL)
    for _ in range(500):
        cigar = [(int(rng.integers(1, 40)) << CIGAR_SHIFT)
                 | ops[int(rng.integers(0, 3))]
                 for _ in range(int(rng.integers(1, 6)))]
        scr = int(rng.integers(0, 300)) * int(rng.integers(0, 2))
        length = int(rng.integers(1, 200))
        assert (own.edit_distance(scr, length, cigar)
                == ref.edit_distance(scr, length, cigar))
    assert own.best_pair_score(90, 110) == ref.best_pair_score(90, 110)


def _heap_state(res):
    state = {k: v for k, v in vars(res).items() if k != "v"}
    return state, [list(e) for e in res.v[: res.sz]]


@pytest.mark.parametrize("kind", ["SECandidates", "PECandidates"])
def test_candidate_heaps_match_jax(kind):
    """The libstdc++ heap copies: seeded update sequences (both phases,
    ties, exact hits, a full heap that grows or evicts) leave both
    packages' candidate sets in the same state after every update, and
    their sorted, deduplicated outputs agree."""
    from abismal_tpu.map import candidates as ref
    from abismal_tpu_torch.map import candidates as own

    rng = np.random.default_rng(11)
    for trial in range(20):
        a, b = getattr(own, kind)(), getattr(ref, kind)()
        readlen = int(rng.integers(60, 151))
        a.reset(readlen)
        b.reset(readlen)
        for step in range(int(rng.integers(10, 400))):
            if step == 0 or rng.random() < 0.02:
                a.set_sensitive() if step else a.set_specific()
                b.set_sensitive() if step else b.set_specific()
            specific = bool(rng.random() < 0.6)
            d = int(rng.integers(0, 12))
            s = int(rng.choice([0, 0x10, 0x1000, 0x1010]))
            p = int(rng.integers(1, 5000)) if trial % 2 else int(
                rng.integers(1, 40))
            a.update(specific, d, s, p)
            b.update(specific, d, s, p)
            assert _heap_state(a) == _heap_state(b), (trial, step)
        assert a.should_do_sensitive() == b.should_do_sensitive()
        if kind == "SECandidates":
            assert a.prepare_for_alignments() == b.prepare_for_alignments()
        else:
            assert a.should_align() == b.should_align()
            assert a.prepare_for_mating() == b.prepare_for_mating()
        assert _heap_state(a) == _heap_state(b)


def _genome_reads(view, n, seed, length=100):
    """n reads cut from the genome (view.nib), a few bases changed and
    most Cs converted to T, as bytes."""
    rng = np.random.default_rng(seed)
    nib_to_char = np.frombuffer(b"ZACMGRSVTWYHKDBN", dtype=np.uint8)
    reads = []
    for _ in range(n):
        p = int(rng.integers(40000, view.nib.shape[0] - 40000))
        seq = bytearray(nib_to_char[view.nib[p : p + length]].tobytes()
                        .replace(b"Z", b"A"))
        for j in rng.integers(0, length, 3):
            seq[j] = b"ACGT"[int(rng.integers(0, 4))]
        for j in range(length):
            if seq[j] == ord("C") and rng.random() < 0.9:
                seq[j] = ord("T")
        reads.append(bytes(seq))
    return reads


def test_seeds_match_jax(port_index, ref_index):
    """prep_read and pack_read on seeded reads (ACGTN and every length to
    150), and process_seeds over genome reads in each conversion and
    strand code: the SE and PE candidate sets end in the same state."""
    from abismal_tpu.map import candidates as ref_c
    from abismal_tpu.map import seeds as ref
    from abismal_tpu_torch.map import candidates as own_c
    from abismal_tpu_torch.map import seeds as own
    from abismal_tpu_torch.map.host_units import strand_code

    rng = np.random.default_rng(5)
    for n in range(0, 151):
        read = bytes(rng.choice(list(b"ACGTN"), n))
        for a_rich in (False, True):
            pr = own.prep_read(read, a_rich)
            np.testing.assert_array_equal(pr, ref.prep_read(read, a_rich))
            np.testing.assert_array_equal(own.pack_read(pr),
                                          ref.pack_read(pr))
    view_o, view_r = own.SeedIndexView(port_index), ref.SeedIndexView(
        ref_index)
    np.testing.assert_array_equal(view_o.nib, view_r.nib)
    n_hits = 0
    for i, read in enumerate(_genome_reads(view_o, 48, seed=2)):
        a_rich, strand = bool(i & 1), "-" if i & 2 else "+"
        sc = strand_code(strand, a_rich)
        pr = own.prep_read(read, a_rich)
        for cls in ("SECandidates", "PECandidates"):
            a, b = getattr(own_c, cls)(), getattr(ref_c, cls)()
            a.reset(len(read))
            b.reset(len(read))
            own.process_seeds(view_o, pr, own.pack_read(pr), sc, a)
            ref.process_seeds(view_r, pr, ref.pack_read(pr), sc, b)
            assert _heap_state(a) == _heap_state(b), (i, cls)
            n_hits += a.sz
    assert n_hits > 48


def test_banded_aligner_matches_jax(port_index, ref_index):
    """Scores and tracebacks of the port's BandedAligner (the port's
    native library) equal the JAX package's at seeded genome windows."""
    from abismal_tpu.map.align import BandedAligner as RefAligner
    from abismal_tpu.map.seeds import SeedIndexView as RefView
    from abismal_tpu_torch.map.align import BandedAligner
    from abismal_tpu_torch.map.seeds import SeedIndexView, prep_read

    view = SeedIndexView(port_index)
    own, ref = BandedAligner(view.nib), RefAligner(RefView(ref_index).nib)
    own.reset(128)
    ref.reset(128)
    rng = np.random.default_rng(3)
    reads = _genome_reads(view, 40, seed=9)
    for read in reads:
        q = prep_read(read, False)
        pos = int(rng.integers(40000, view.nib.shape[0] - 40000))
        for diffs, tb in ((0, True), (3, False), (7, True), (12, True)):
            assert (own.align(diffs, 10, q, pos, tb)
                    == ref.align(diffs, 10, q, pos, tb))
            if tb:
                assert (own.build_cigar_len_and_pos(diffs, 10, pos)
                        == ref.build_cigar_len_and_pos(diffs, 10, pos))


@pytest.mark.parametrize("prefix,paired,pbat", CASES)
def test_exact_engine_gives_the_goldens(tmp_path, port_index, prefix,
                                        paired, pbat):
    """run_map without a factory runs MappingEngine: the four small
    goldens byte for byte (↔ tests/test_map.py::test_map_parity_small)."""
    from abismal_tpu_torch.map.engine import run_map

    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    sam, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    run_map(port_index, fq1, fq2, str(sam), str(mst),
            _cl(prefix, paired, pbat), pbat=pbat)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")


@pytest.mark.parametrize("prefix,paired,a_rich", [
    ("small", False, False),
    # -A is ignored for pairs (abismal.cpp:2477-2480); the golden's @PG
    # line (no -A) is kept, only the engine flag is exercised
    ("small_pe", True, True),
])
def test_parallel_runner_gives_the_goldens(tmp_path, port_index, prefix,
                                           paired, a_rich):
    """run_map with threads=3 runs run_map_parallel: three forked
    MappingEngine workers, output in batch order, the goldens (↔
    tests/test_map.py::test_parallel_runner_parity and
    ::test_parallel_runner_pe_ignores_a_rich)."""
    from abismal_tpu_torch.map.engine import run_map

    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    sam, mst = tmp_path / "t.sam", tmp_path / "t.mstats"
    run_map(port_index, fq1, fq2, str(sam), str(mst), _cl(prefix, paired),
            a_rich=a_rich, threads=3)
    assert sam.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")


def test_run_map_hands_the_factory_to_run_map_hybrid(port_index,
                                                      monkeypatch):
    """With threads > 1 a replay factory goes to run_map_hybrid, and the
    configured one (--lmax, unit_batch), not a default (↔ tests/
    test_map.py::test_hybrid_runner_receives_engine_factory)."""
    from abismal_tpu_torch.map import runner
    from abismal_tpu_torch.map.engine import run_map
    from abismal_tpu_torch.map.pipeline import make_torch_engine_factory
    from abismal_tpu_torch.map.stats import SEStats

    seen = {}

    def fake_hybrid(index, f1, f2, out, cl, n, engine_factory=None, **kw):
        seen.update(factory=engine_factory, n=n)
        return SEStats()

    monkeypatch.setattr(runner, "run_map_hybrid", fake_hybrid)
    factory = make_torch_engine_factory("cpu", lmax=256, unit_batch=64)
    assert factory.is_replay
    run_map(port_index, golden_file("small_1.fq"), None, os.devnull, None,
            "map", engine_factory=factory, threads=2)
    assert seen == {"factory": factory, "n": 2}
