"""Random-PBAT single-end mapping (`map -R`) of 150 bp reads at --lmax 160
on the CPU: the port's fused route against the plain reference of
abismal_bench/reference/plain_rpbat.py (exhaustive search) and against
the native engine, and the tracer's conversion counters (a_rich_units,
cv_a_winners, cv_t_winners) and -v's conversions line."""

import io

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import release_engines  # noqa: F401

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

N_READS = 300
MISSED_LIMIT = 0.02  # upstream's seeds may miss what the search finds


@pytest.fixture(scope="module")
def rpbat(tmp_path_factory):
    """(port index, plain genome, reads [(name, seq)]): two random
    chromosomes of 20 kb and 300 random-PBAT 150 bp reads of them, drawn
    by the benchmark's simulator (1% mutations, 98% conversion)."""
    from abismal_bench.gen import fasta, reads
    from abismal_bench.reference import plain_rpbat
    from abismal_tpu_torch.index.build import create_index

    d = tmp_path_factory.mktemp("rpbat")
    rng = np.random.default_rng(23)
    fa = d / "g.fa"
    with open(fa, "w") as f:
        for c in (1, 2):
            s = "".join(rng.choice(list("ACGT"), size=20_000))
            f.write(f">chr{c}\n" + "\n".join(s[i : i + 70] for i in
                                             range(0, len(s), 70)) + "\n")
    genome = fasta.Genome(str(fa), str(d / "layout.npz"))
    pool = reads.simulate(genome, N_READS, 2**31 + 5, 150, 150, 400, 0.01,
                          [1, 1, 1], 0.98, False, traffic_seed=16,
                          protocol="random_pbat")
    chroms = [(n, genome.window(c, 0, int(genome.lengths[c])))
              for c, n in enumerate(genome.names)]
    rd = [(f"{n}.1", s) for n, s in zip(pool.names, pool.seqs[0])]
    return (create_index(str(fa)), plain_rpbat.PlainGenome(chroms), rd)


@pytest.fixture(scope="module")
def decisions(rpbat):
    from abismal_bench.reference import plain_rpbat

    _, pg, rd = rpbat
    return plain_rpbat.decide(pg, [s for _, s in rd], mem_words=1 << 22)


def _engine(index):
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    return TorchNativeEngine(index, lmax=160, unit_batch=128, n_threads=2,
                             device="cpu", device_stage2=True)


def _map(eng, rd, random_pbat):
    from abismal_tpu_torch.map.stats import SEStats

    out, st = io.StringIO(), SEStats()
    eng.map_se_reads(rd, False, random_pbat, st, out)
    return out.getvalue(), st.tostring("stats")


def _compare(rpbat, decisions, sam):
    from abismal_bench.reference import plain_rpbat

    _, pg, rd = rpbat
    recs = plain_rpbat.sam_records(sam.encode().splitlines(keepends=True))
    return plain_rpbat.compare(pg, [n for n, _ in rd], [s for _, s in rd],
                               decisions, recs)


def test_fused_route_gives_the_plain_references_decisions(rpbat, decisions):
    """Every record is the reference's unique best (position, strand, CV
    and score), at most 2% of the reads it places uniquely are left
    unmapped, and the same reads mapped without -R fail that."""
    index, _, rd = rpbat
    eng = _engine(index)
    sam, _ = _map(eng, rd, True)
    res = _compare(rpbat, decisions, sam)
    assert res["differ"] == 0, res
    assert res["unique"] >= 0.95 * N_READS and res["unresolved"] <= 3, res
    assert res["missed"] <= MISSED_LIMIT * res["unique"], res
    assert 0.3 < sam.count("\tCV:A:A") / res["written"] < 0.7
    directional, _ = _map(eng, rd, False)
    eng.close()
    res = _compare(rpbat, decisions, directional)
    assert (res["differ"] > 0
            or res["missed"] > MISSED_LIMIT * res["unique"]), res


def test_fused_route_equals_the_native_engine(rpbat):
    """At --lmax 160 -R the fused SE program (4 units a read in one slot
    table, K3 on 160-nibble rows) writes the native engine's SAM and
    stats; no read is handed back, none for its length."""
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine

    index, _, rd = rpbat
    eng = _engine(index)
    port = _map(eng, rd, True)
    eng.close()
    assert port == _map(NativeMappingEngine(index, n_threads=2), rd, True)
    assert port[0].count("\tNM:i:") > 0.95 * N_READS
    assert eng.n_units == 4 * N_READS
    assert eng.n_fallback == 0 and eng.n_oversized == 0


@pytest.mark.parametrize("random_pbat", [False, True], ids=["dir", "rpbat"])
def test_conversion_counters(rpbat, monkeypatch, random_pbat):
    """a_rich_units: 0 for a directional map, half the units under -R;
    cv_a_winners + cv_t_winners: the records of status exact or aligned
    that the card handed to the finalize, split by their A-rich flag;
    nothing counted with the tracer off."""
    from abismal_tpu_torch.map.pipeline import F_A_RICH

    index, _, rd = rpbat
    eng = _engine(index)
    seen = []
    finalize = eng.native._finalize_se

    def spy(reads, arm, rp, records, *a, **k):
        seen.append(np.array(records))
        return finalize(reads, arm, rp, records, *a, **k)

    monkeypatch.setattr(eng.native, "_finalize_se", spy)
    _map(eng, rd, random_pbat)
    assert not any(eng.tracer.summary()["counters"].values())
    eng.tracer.on = True
    try:
        _map(eng, rd, random_pbat)
    finally:
        eng.tracer.on = False
    eng.close()
    c = eng.tracer.summary()["counters"]
    per = 4 if random_pbat else 2
    assert c["encoded_units"] == per * N_READS
    assert c["a_rich_units"] == (2 * N_READS if random_pbat else 0)
    rec = np.concatenate(seen[len(seen) // 2 :])[:, 0]
    won = ((rec & 7) == 1) | ((rec & 7) == 2)
    a_rich = ((rec >> 3) & F_A_RICH) != 0
    assert c["cv_a_winners"] + c["cv_t_winners"] == int(won.sum()) > 100
    assert c["cv_a_winners"] == int((won & a_rich).sum())
    if random_pbat:
        assert 0.3 < c["cv_a_winners"] / int(won.sum()) < 0.7
    else:
        assert c["cv_a_winners"] == 0


def test_verbose_prints_the_conversions(rpbat, tmp_path, capsys):
    from abismal_tpu_torch.map.engine import run_map
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    index, _, rd = rpbat
    fq = tmp_path / "r.fq"
    fq.write_bytes(b"".join(b"@%s\n%s\n+\n%s\n" % (n.encode(), s,
                                                    b"B" * len(s))
                            for n, s in rd))
    fac = make_torch_native_engine_factory("cpu", lmax=160, unit_batch=128,
                                           n_threads=2)
    run_map(index, str(fq), None, str(tmp_path / "o.sam"), None, "cl",
            random_pbat=True, engine_factory=fac, threads=2, verbose=True)
    err = capsys.readouterr().err
    line = next(x for x in err.splitlines() if x.startswith("[conversions:"))
    assert line.startswith(f"[conversions: {2 * N_READS} of {4 * N_READS} "
                           f"unit rows A-rich (0.500); winners CV:A ")
