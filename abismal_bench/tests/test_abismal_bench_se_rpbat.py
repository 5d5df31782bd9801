"""The random-PBAT single-end configuration at lmax 160: the cell
resolves (the full genome, shared with pe_g1000_l160, mapped with -R) and
a tiny copy of it runs correct on the CPU, with no read handed back for
its length; k3_roofline is silent without a trace and roofline/k3.py
gives chip_smoke.py's bound on its packed K3 cases; the plain reference
of reference/plain_rpbat.py and the judge of reference/check.py agree on
hand-made records."""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from abismal_bench.harness import spec
from abismal_bench.run import Run
from abismal_bench.tests import _tiny
from abismal_bench.tests.conftest import ROOT

CELL = "se_rpbat_g3100_l160.len150"
# the cell's settings that the tiny benchmark's differ from: its chunk of
# 2048 units (512 reads); the candidate budget is measured on the first
# batch's units, and a batch of 250 reads (the least) sets it lower
RPBAT160 = {"lmax": 160, "random_pbat": True, "unit_batch": 2048}


def test_cell_resolves_to_the_full_genome_under_random_pbat():
    from abismal_bench.harness.system import command_line, resolve
    from abismal_bench.reference.check import conversion_of

    cell = spec.find_cell(CELL)
    conf, wl = cell.config, cell.workload
    assert cell.entry["chips"] == 1 and not conf["paired"]
    st = resolve(conf["settings"])
    assert " -R " in command_line(st) and "--lmax 160" in command_line(st)
    assert conversion_of(st, False) == "random"
    assert wl["traffic"]["protocol"] == "random_pbat"
    # the genome is the cache key (harness/inputs.py genome_dir): the PE
    # cell's genome and index serve this cell too
    pe = spec.find_cell("pe_g1000_l160.len150").config
    assert conf["genome"] == pe["genome"]
    assert conf["genome"]["genome_size"] == 3_099_734_149
    names = [m["name"] for m in cell.per_layer]
    assert names[-1] == "k3_roofline" and "k1_roofline" in names


def test_tiny_rpbat_l160_cell_runs_correct(tiny, run_tiny):
    root, _ = tiny
    cell = _tiny.add_cell(root, "se_rpbat_l160.len150", "se_rpbat_l160",
                          False, RPBAT160, read_length=150, frag_min=150,
                          frag_max=400, pool_reads=400,
                          protocol="random_pbat")
    out = run_tiny(cell, 2**31 + 23, trace=True)
    assert out["check"]["record_faults"]["value"] == 0, out["stderr"]
    assert out["correct"], out["stderr"]
    m = out["metrics"]
    assert m["finish_ms"]["value"] > 0
    # 150-base reads fit: none goes to the host for its length
    assert m["device_fallback_frac"]["value"] < 0.05, m
    # device numbers come from the card alone
    assert not {"replay_ms", "k3_roofline", "k1_roofline"} & set(m)


def test_k3_reader_is_silent_without_a_trace():
    mod = spec.reader("k3_roofline")
    assert mod.read(Run()) is None
    assert mod.read(Run(recorded={"k3_roofline": [None, None]})) is None
    bound = {"bound_ms": 0.01}
    assert mod.read(Run(recorded={"k3_roofline": [bound]})) is None


def _chip_smoke():
    path = os.path.join(ROOT, "chip_smoke.py")
    s = importlib.util.spec_from_file_location("chip_smoke_k3", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def test_k3_bound_is_chip_smokes():
    from abismal_bench.roofline.k3 import k3_bound

    cs = _chip_smoke()
    cs.PACKED_GENOME_WORDS = 1 << 16  # a small genome on the CPU
    cases = [c for c in cs.kernel_cases("cpu")
             if c["name"].startswith("banded_trace_packed")]
    assert len(cases) == 2
    for c in cases:
        assert k3_bound(c["args"]) == c["bound"], c["name"]


def test_plain_reference_loads_nothing_of_the_program():
    code = ("import sys\n"
            "import abismal_bench.reference.plain_rpbat\n"
            "print(' '.join(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    tops = set(p.stdout.split())
    assert not tops & {"abismal_tpu_torch", "abismal_tpu", "jax"}


# --- the plain reference and the judge on hand-made records ---

def _convert(s: bytes, frm: bytes, to: bytes) -> bytes:
    return s.replace(frm, to)


@pytest.fixture(scope="module")
def hand(tmp_path_factory):
    """(fasta.Genome, plain genome, window): chrA holds 600 random bases
    then a 160-base segment twice, 400 bases apart; chrB 500 others."""
    from abismal_bench.gen import fasta
    from abismal_bench.reference import plain_rpbat

    rng = np.random.default_rng(41)

    def rand(n):
        return bytes(rng.choice(list(b"ACGT"), n).tolist())

    dup = rand(160)
    chroms = [("chrA", rand(600) + dup + rand(400) + dup + rand(100)),
              ("chrB", rand(500))]
    d = tmp_path_factory.mktemp("hand")
    fa = d / "g.fa"
    fa.write_bytes(b"".join(b">%s\n%s\n" % (n.encode(), s)
                            for n, s in chroms))
    g = fasta.Genome(str(fa), str(d / "layout.npz"))
    return g, plain_rpbat.PlainGenome(chroms), chroms[0][1]


def _cases(win):
    """(name, read as sequenced, SAM fields of its record) by hand: the
    four encodings at chrA:101, a deletion, a wrong CV, a read from the
    doubled segment."""
    from abismal_bench.reference.check import revcomp

    w = win[100:250]
    ct, ga = _convert(w, b"C", b"T"), _convert(w, b"G", b"A")
    dl = _convert(win[300:370] + win[371:451], b"C", b"T")
    rep = _convert(win[610:760], b"C", b"T")
    return [
        ("fw_t", ct, (0, "chrA", 101, "150M", ct, 0, "T")),
        ("fw_a", ga, (0, "chrA", 101, "150M", ga, 0, "A")),
        ("rc_a", revcomp(ct), (16, "chrA", 101, "150M", ct, 0, "A")),
        ("rc_t", revcomp(ga), (16, "chrA", 101, "150M", ga, 0, "T")),
        ("del", dl, (0, "chrA", 301, "70M1D80M", dl, 1, "T")),
        ("wrong_cv", ct, (0, "chrA", 101, "150M", ct, 0, "A")),
        ("doubled", rep, (0, "chrA", 611, "150M", rep, 0, "T")),
    ]


def test_plain_reference_and_judge_agree_on_hand_made_records(hand):
    from abismal_bench.reference import plain_rpbat
    from abismal_bench.reference.check import Judge, Record

    g, pg, win = hand
    cases = _cases(win)
    seqs = [s for _, s, _ in cases]
    dec = plain_rpbat.decide(pg, seqs, mem_words=1 << 20)
    judge = Judge(g, None, None, False, 0.1, "random")
    for (name, seq, rec), d in zip(cases, dec):
        line = b"%s\t%d\t%s\t%d\t255\t%s\t*\t0\t0\t%s\t*\tNM:i:%d\tCV:A:%s" % (
            name.encode(), rec[0], rec[1].encode(), rec[2], rec[3].encode(),
            rec[4], rec[5], rec[6].encode())
        ok, score, _ = judge._record_ok(Record.parse(line), 0, seq)
        res = plain_rpbat.compare(pg, [name], [seq], [d],
                                  plain_rpbat.sam_records([line]))
        if name == "doubled":
            # two places score 300: the judge, which searches no genome,
            # passes the record; the reference finds it ambiguous
            assert ok and d.status == "ambiguous" and res["differ"] == 1
            continue
        assert ok == (res["differ"] == 0), (name, res)
        if name == "wrong_cv":
            assert not ok and res["why"] == {"strand or conversion": 1}
            continue
        assert ok and d.status == "unique", (name, d)
        assert score == d.score == (296 if name == "del" else 300)
        assert (d.reverse, d.cvs) == (bool(rec[0] & 16), (rec[6],))
        assert d.pos_lo <= rec[2] - 1 <= d.pos_hi
