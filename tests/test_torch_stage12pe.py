"""The port's paired-end stage-1+2 program (build_stage12pe) against the
JAX package's on the same chunk of golden pairs: the JAX DeviceIndex's
exact tables are handed to the port (DeviceIndex.from_numpy_tables), and
the packed rows are compared whole and exactly (integer arithmetic,
tolerance 0).  JAX runs on the CPU with its Pallas scorer in interpret
mode, as its own tests run it."""

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    golden_file, port_index, release_engines,
)

jax = pytest.importorskip("jax")

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

LMAX = 128
K = 32


def _tables(index):
    from abismal_tpu.map.pipeline import DeviceIndex as JaxDeviceIndex
    from abismal_tpu_torch.map.pipeline import DeviceIndex

    jdev = JaxDeviceIndex(index)
    g32, _g2o, c2, c3, idx = (np.asarray(t) for t in jdev.tables())
    tdev = DeviceIndex.from_numpy_tables(
        g32, c2, c3, idx, jdev.n_index2, jdev.n_index3, jdev.max_candidates,
        jdev.ext_iters, "cpu")
    return jdev, tdev


@pytest.fixture(scope="module")
def tables(port_index):
    return _tables(port_index)


def _pe_units(reads1, reads2, random_pbat, pbat=False):
    """One chunk of pairs as the engine lays it out: (pnib, lens, is_ga,
    max_diffs_u, per)."""
    from abismal_tpu.map.pipeline import TpuNativeEngine
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine

    class _Shape:
        lmax = LMAX

    pnib, lens, per, _ = TorchNativeEngine._pe_units_mat(
        _Shape(), reads1, reads2, pbat, random_pbat)
    is_ga = np.tile(TpuNativeEngine._pe_is_ga_pattern(pbat, random_pbat),
                    len(reads1))
    md = (0.1 * lens.astype(np.float64)).astype(np.int32)
    return pnib, lens, is_ga, md, per


def _golden_pairs(prefix, first, n):
    from abismal_tpu_torch.io.fastq import ReadLoader

    return [ReadLoader(golden_file(f"{prefix}_{e}.fq")).load_batch()[
        first : first + n] for e in (1, 2)]


def _run_both(jdev, tdev, units, cand, pe_dist=(32, 3000)):
    from abismal_tpu.map.pipeline import build_stage12pe as jax_stage12pe
    from abismal_tpu_torch.map.pipeline import build_stage12pe

    pnib, lens, is_ga, md, per = units
    dist = np.array(pe_dist, np.int32)
    prog_j, _ = jax_stage12pe(LMAX, jdev.max_candidates, jdev.n_index2,
                              jdev.n_index3, per=per, cand_per_unit=cand,
                              interpret=True, ext_iters=jdev.ext_iters)
    want = np.asarray(prog_j(*jdev.tables(), pnib, lens, is_ga, md, dist))
    prog_t, _ = build_stage12pe(LMAX, jdev.max_candidates, jdev.n_index2,
                                jdev.n_index3, per=per, cand_per_unit=cand,
                                ext_iters=jdev.ext_iters)
    got = prog_t(*tdev.tables(), *(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in (pnib, lens, is_ga, md, dist)))
    return got.numpy(), want


def _mate(rows, per):
    """(pairs, per // 2, 10) mating records of the packed rows."""
    return rows[:, 2 * K + 1 :].reshape(-1, per // 2, 10)


@pytest.mark.parametrize("prefix,first,n_pairs,random_pbat,cand", [
    ("small_pe", 0, 32, False, 52),  # per=4: 128 units
    ("small_rpbat_pe", 100, 16, True, 44),  # per=8, random PBAT
])
def test_stage12pe_packed_rows_match_jax(tables, prefix, first, n_pairs,
                                         random_pbat, cand):
    """Packed (B, 2K + 6) rows, whole, equal the JAX program's on one
    128-unit chunk; cand is distinct from other tests' budgets, so JAX
    builds a fresh program."""
    jdev, tdev = tables
    r1, r2 = _golden_pairs(prefix, first, n_pairs)
    units = _pe_units(r1, r2, random_pbat)
    got, want = _run_both(jdev, tdev, units, cand)
    assert got.dtype == np.int32 and got.shape == want.shape == (128, 70)
    np.testing.assert_array_equal(got, want)
    cnt = want[:, 2 * K]
    assert (cnt == -1).sum() > 0 and (cnt > 0).sum() > 0
    assert (_mate(want, units[4])[:, :, 0] == 1).sum() > 0


def _write_fasta(path, name, seq):
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i : i + 70] + "\n")


def _revcomp(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def test_stage12pe_iupac_negative_bands_match_jax(tmp_path):
    """On a genome with Y (C|T) spots, T-rich pairs get negative diffs:
    K2 sees negative bands (bw = 2 d + 1 < 0, score 0) and the mating
    key sdP K^2 + ord goes negative (floor division).  The last 8 pairs
    come from designed blocks: end 1 at E (a Y: score 0), end 2 at A
    (+200, a Y).  In odd blocks A has a C copy at +1200, so the winner
    sits at rank (0, 1) with a negative diff-sum.  In even blocks E has a
    C copy E' at +400 and A has copies B (+1000, one mismatch) and C
    (+1600, exact): (E', C) wins at ranks (1, 2) and is not E''s first
    window, while (E, C) is a zero-score recompute after it, so the stale
    end-1 score comes from E, not E'.  Rows equal JAX."""
    from abismal_tpu_torch.index.build import create_index

    rng = np.random.default_rng(11)
    n = 120_000
    seq = rng.choice(list("ACGT"), size=n)
    seq[rng.integers(200, n - 200, 3000)] = "Y"
    starts = list(rng.integers(500, 60_000, 24))
    for bi, s0 in enumerate(range(64_000, 112_000, 6_000)):
        seq[s0 : s0 + 2000] = rng.choice(list("ACGT"), size=2000)
        seq[s0 + 50] = seq[s0 + 250] = "Y"
        copies = (1200,) if bi % 2 else (1000, 1600)
        for c0 in copies:
            seq[s0 + c0 : s0 + c0 + 100] = seq[s0 + 200 : s0 + 300]
            seq[s0 + c0 + 50] = "C"
        if not bi % 2:
            seq[s0 + 400 : s0 + 500] = seq[s0 : s0 + 100]
            seq[s0 + 450] = "C"
            r = "T" if seq[s0 + 220] in "CT" else seq[s0 + 220]
            seq[s0 + 1020] = "G" if r == "A" else "A"
        starts.append(s0)
    _write_fasta(tmp_path / "y.fa", "chrY", "".join(seq))
    jdev, tdev = _tables(create_index(str(tmp_path / "y.fa")))
    r1, r2 = [], []
    for i, s0 in enumerate(starts):
        flen = 300 if i >= 24 else int(rng.integers(250, 400))
        frag = "".join(seq[s0 : s0 + flen])
        frag = frag.replace("C", "T").replace("Y", "T")
        r1.append((f"y{i}", frag[:100].encode()))
        r2.append((f"y{i}", _revcomp(frag[-100:]).encode()))
    got, want = _run_both(jdev, tdev, _pe_units(r1, r2, False), 60)
    np.testing.assert_array_equal(got, want)
    cnt = want[:, 2 * K]
    kidx = np.arange(K)[None, :]
    d_live = (want[:, K : 2 * K] >> 16)[kidx < np.minimum(cnt, K - 1)[:, None]]
    assert (d_live < 0).sum() > 0
    m = _mate(want, 4)
    assert ((m[:, :, 0] == 1) & (m[:, :, 4] + m[:, :, 5] < 0)).sum() > 0


@pytest.mark.parametrize("allow_ambig", [False, True])
def test_stage12pe_fbm_guard_matches_native(tmp_path, allow_ambig):
    """The fbm guard of the mating sweep: a max-score tie between
    concordant pairs whose diff-sums differ goes to the host's sequential
    replay.  Each designed fragment's end 2 lies on a stretch of period
    10 whose flanks break the period: one period off, the T-rich end has
    10 mismatches, so a band of 21 columns, in which it aligns perfectly
    all the same, and ties the exact hit at diffs 10 against 0.  The rows
    equal JAX's and flag the tie, and the pairs map as the native engine
    maps them, with and without -a."""
    import io

    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.map.native_engine import NativeMappingEngine
    from abismal_tpu_torch.map.pipeline import TorchNativeEngine
    from abismal_tpu_torch.map.stats import PEStats

    rng = np.random.default_rng(5)
    n, p = 100_000, 10
    seq = rng.choice(list("ACGT"), size=n)
    # a base that differs from `key` once C reads as T
    other = {"T": "AG", "A": "GT", "G": "AT"}
    starts = list(range(2_000, 74_000, 3_000))
    for s0 in starts:
        e2 = s0 + 200  # end 2 covers [s0 + 200, s0 + 300)
        unit = rng.choice(list("TTAG"), p)
        seq[e2 : e2 + 100] = unit[np.arange(100) % p]
        for j in range(p):
            seq[e2 - p + j] = rng.choice(list(other[unit[j]]))
            seq[e2 + 100 + j] = rng.choice(list(other[unit[(100 + j) % p]]))
    _write_fasta(tmp_path / "t.fa", "chrT", "".join(seq))
    index = create_index(str(tmp_path / "t.fa"))
    r1, r2 = [], []
    for i, s0 in enumerate(starts):
        frag = "".join(seq[s0 : s0 + 300]).replace("C", "T")
        r1.append((f"t{i}", frag[:100].encode()))
        r2.append((f"t{i}", _revcomp(frag[-100:]).encode()))
    units = _pe_units(r1, r2, False)
    got, want = _run_both(*_tables(index), units, 60)
    np.testing.assert_array_equal(got, want)
    fbm = _mate(want, units[4])[:, :, 9]
    assert fbm[:, 0].sum() >= len(starts) // 2  # forward orientation

    outs = []
    for eng in (TorchNativeEngine(index, allow_ambig, unit_batch=128,
                                  n_threads=2, device="cpu"),
                NativeMappingEngine(index, allow_ambig, n_threads=2)):
        out, st = io.StringIO(), PEStats()
        eng.map_pe_reads(r1, r2, False, False, st, out)
        outs.append((out.getvalue(), st.tostring(allow_ambig)))
    assert outs[0] == outs[1]


# golden pairs of the cut tests: (prefix, first pair, pairs, PBAT, random
# PBAT); 128 units a chunk
CUT_PAIRS = {"small_pe": ("small_pe", 0, 32, False, False),
             "small_pbat_pe": ("small_pbat_pe", 200, 32, True, False),
             "small_rpbat_pe": ("small_rpbat_pe", 100, 16, False, True)}


def _pe_cut_cases():
    from abismal_tpu_torch.map.pipeline import PE_CUTS

    return [(cut, pairs) for cut in PE_CUTS for pairs in CUT_PAIRS]


@pytest.mark.parametrize("cut,pairs", _pe_cut_cases())
def test_stage12pe_cuts_match_jax(tables, cut, pairs):
    """Every profiling cut of build_stage12pe (the core's through it)
    returns the JAX program's i32 sums on a chunk of golden pairs,
    exactly."""
    from abismal_tpu.map.pipeline import build_stage12pe as jax_stage12pe
    from abismal_tpu_torch.map.pipeline import build_stage12pe

    jdev, tdev = tables
    prefix, first, n_pairs, pbat, random_pbat = CUT_PAIRS[pairs]
    r1, r2 = _golden_pairs(prefix, first, n_pairs)
    pnib, lens, is_ga, md, per = _pe_units(r1, r2, random_pbat, pbat)
    dist = np.array((32, 3000), np.int32)
    cand = 48  # a budget no other test of this module builds
    prog_j, _ = jax_stage12pe(LMAX, jdev.max_candidates, jdev.n_index2,
                              jdev.n_index3, per=per, cand_per_unit=cand,
                              interpret=True, ext_iters=jdev.ext_iters,
                              cut=cut)
    want = np.asarray(prog_j(*jdev.tables(), pnib, lens, is_ga, md, dist))
    prog_t, _ = build_stage12pe(LMAX, jdev.max_candidates, jdev.n_index2,
                                jdev.n_index3, per=per, cand_per_unit=cand,
                                ext_iters=jdev.ext_iters, cut=cut)
    got = prog_t(*tdev.tables(), *(torch.from_numpy(np.ascontiguousarray(a))
                                   for a in (pnib, lens, is_ga, md, dist)))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert want.shape == ((2, 128) if cut == "unitstats" else (4,))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
