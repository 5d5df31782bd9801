"""The port's kernels (abismal_tpu_torch/kernels): each plain PyTorch
version against the JAX package's Pallas kernel (interpret mode) on the
same arrays, the fused traceback against the host aligner, and -- on a
machine with a card -- each CUDA kernel against its plain version.  All
comparisons are exact (integer arithmetic, tolerance 0)."""

import gzip
import os

import numpy as np
import pytest
import torch

from abismal_tpu.constants import CIGAR_SHIFT, CIGAR_SOFT

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

LMAX = 128


def _random_jobs(rng, genome, n, bws=(5, 9, 15, 21, 31, 41, 61)):
    """Jobs (q, bw, qsz, pos) copied from the genome with substitutions
    and an insertion and/or deletion, so cigars carry M/I/D runs and both
    soft clips."""
    jobs = []
    G = genome.shape[0]
    for _ in range(n):
        qsz = int(rng.integers(60, 121))
        pos = int(rng.integers(200, G - 400))
        q = genome[pos : pos + qsz].copy()
        for _k in range(int(rng.integers(0, 8))):
            q[int(rng.integers(0, qsz))] = 1 << int(rng.integers(0, 4))
        ql = list(q)
        if rng.random() < 0.5:
            ql.insert(int(rng.integers(10, qsz - 10)),
                      1 << int(rng.integers(0, 4)))
        if rng.random() < 0.5:
            del ql[int(rng.integers(10, len(ql) - 10))]
        q = np.array(ql[:qsz], dtype=np.uint8)
        jobs.append((q, int(rng.choice(bws)), q.shape[0], pos))
    return jobs


def _job_arrays(genome, jobs, J, lmax=LMAX):
    """(q, win, bw, qsz, pos, do_tb) in the v3 layout, padded to J rows
    with untraced lanes (bw = 1, qsz = 0)."""
    from abismal_tpu.kernels.banded_align import QOFF, win_start

    ww = lmax + QOFF
    q = np.zeros((J, lmax), np.uint8)
    win = np.zeros((J, ww), np.uint8)
    bw = np.ones(J, np.int32)
    qsz = np.zeros(J, np.int32)
    pos = np.zeros(J, np.uint32)
    do_tb = np.zeros(J, bool)
    for i, (qq, b, n, p) in enumerate(jobs):
        q[i, :n] = qq
        g0 = win_start(p, b)
        win[i] = genome[g0 : g0 + ww]
        bw[i], qsz[i], pos[i], do_tb[i] = b, n, p, True
    return q, win, bw, qsz, pos, do_tb


def _genome(seed, G=6000, iupac=0):
    rng = np.random.default_rng(seed)
    genome = (1 << rng.integers(0, 4, G)).astype(np.uint8)
    if iupac:
        spots = rng.integers(0, G, iupac)
        genome[spots] = rng.integers(1, 16, iupac)
    return rng, genome


def _k1_arrays(seed, G=1024, B=32, nw_words=16, n_gw=4096):
    """K1 inputs: random u32 genome words and read words, positions that
    include nibble shift 0, the genome's end and u32-wrapped values."""
    rng = np.random.default_rng(seed)
    genome32 = rng.integers(0, 1 << 32, n_gw, dtype=np.uint64).astype(
        np.uint32)
    genome32[-64:] = 0  # pack_genome_u32's zero guard words
    pos = rng.integers(0, 8 * n_gw + 1024, G).astype(np.int64)
    pos[::4] &= ~7
    pos[::37] = (1 << 32) - rng.integers(1, 512, pos[::37].shape[0])
    pk = rng.integers(0, 1 << 32, (B, nw_words), dtype=np.uint64).astype(
        np.uint32)
    b_of = rng.integers(0, B, G).astype(np.int64)
    nw_of = (2 * rng.integers(1, nw_words // 2 + 1, G)).astype(np.int32)
    return genome32, pos, pk, b_of, nw_of


def _k1_torch(genome32, pos, pk, b_of, nw_of, device="cpu"):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(genome32.view(np.int32)), t(pos), t(pk.view(np.int32)),
            t(b_of), t(nw_of))


@pytest.mark.parametrize("seed", [1, 2])
def test_popcount_compare_plain_matches_jax(seed):
    """K1 plain vs the Pallas body: the JAX side gets the overlapped rows,
    word offset, nibble shift and pk[b_of] rows built from the same
    genome32/pos, as pipeline.py:940-944 builds them."""
    pytest.importorskip("jax")
    from abismal_tpu.kernels.popcount_compare import build_popcount_compare
    from abismal_tpu.map.pipeline import overlap_rows_u32
    from abismal_tpu_torch.kernels.popcount_compare import (
        popcount_compare_plain,
    )

    genome32, pos, pk, b_of, nw_of = _k1_arrays(seed)
    g2o = overlap_rows_u32(genome32)
    w = (pos >> 3).astype(np.int64)
    A = np.take(g2o, w >> 6, axis=0, mode="clip")
    compare = build_popcount_compare(128, pk.shape[1], interpret=True)
    want = np.asarray(compare(A, pk[b_of], (w & 63).astype(np.int32),
                              ((pos & 7) * 4).astype(np.uint32), nw_of))
    got = popcount_compare_plain(*_k1_torch(genome32, pos, pk, b_of, nw_of))
    np.testing.assert_array_equal(got.numpy(), want)


def _pe_score_arrays(seed, J, iupac=60, packed=False):
    """K2 inputs as build_stage12pe gives them: bands 1..61, negative
    bands (IUPAC diffs below zero, never remapped) and fill rows (bw = 1,
    qsz = 0) among the jobs, padding lanes at the end.  (q, win, bw, qsz),
    or with packed banded_score_packed's operands (_as_packed)."""
    rng, genome = _genome(seed, iupac=iupac)
    jobs = _random_jobs(rng, genome, J - J // 16, bws=(1, 3, 5, 21, 41, 61))
    q, win, bw, qsz, pos, _ = _job_arrays(genome, jobs, J)
    bw[3::7] = -(2 * rng.integers(0, 30, bw[3::7].shape[0]) + 1)
    bw[5::11], qsz[5::11] = 1, 0
    if packed:
        return _as_packed(genome, q, bw, qsz, pos)
    return q, win, bw[:, None], qsz[:, None]


def _as_packed(genome, q, bw, qsz, pos, seed=0):
    """banded_score_packed's operands (genome32, pnib, unit, pos, bw, qsz)
    for jobs given as query rows q over a genome of nibbles: the genome
    packed eight nibbles a word with its zero guard words, the query rows
    packed two nibbles a byte and scattered over twice as many unit rows
    of random bases."""
    from abismal_tpu_torch.map.host_units import pack_genome_u32

    J, lq = q.shape
    genome32 = pack_genome_u32(_pack_u64(genome)).view(np.int32)
    rng = np.random.default_rng(seed)
    U = (1 << rng.integers(0, 4, (2 * J, lq + lq % 2))).astype(np.uint8)
    unit = rng.permutation(2 * J)[:J].astype(np.int64)
    U[unit, :lq] = q
    pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
    return genome32, pnib, unit, pos.astype(np.int64), \
        bw.reshape(-1).astype(np.int64), qsz.reshape(-1).astype(np.int64)


def _k2_case(case, J):
    """(banded_score_packed's operands, row length) where K2's lane groups
    change: the narrow bands of -m 0.1 (8 lanes, 2 or 3 columns each),
    bands of 25-32 (4 columns), bw = 61 alone (the whole warp), negative
    bands and fill rows, J not a multiple of the jobs per warp or block,
    and rows that are not whole words (lq = 126, lq + QOFF = 186)."""
    if case == "negative-fill":
        return _pe_score_arrays(13, J, packed=True), LMAX
    rng, genome = _genome(14, iupac=50)
    bws = {"narrow": (1, 3, 5, 9, 13, 21), "mid": (17, 24, 25, 29, 32, 33),
           "bw61": (61,)}.get(case, (1, 3, 5, 21, 24, 32, 33, 41, 61))
    J = J - 5 if case == "ragged" else J
    jobs = _random_jobs(rng, genome, J - J // 16, bws=bws)
    q, _, bw, qsz, pos, _ = _job_arrays(genome, jobs, J)
    lq = LMAX - 2 if case == "byte-rows" else LMAX
    return _as_packed(genome, q, bw, qsz, pos), lq


@pytest.mark.parametrize("seed,iupac,pe", [
    pytest.param(5, 0, False, id="5-0"),
    pytest.param(6, 60, False, id="6-60"),
    pytest.param(4, 60, True, id="pe-negative-bands"),
])
def test_banded_score_plain_matches_jax(seed, iupac, pe):
    """K2 plain vs the Pallas scorer, bands 1..61 and padding lanes; the
    PE case adds negative bands and fill rows, which score 0."""
    pytest.importorskip("jax")
    from abismal_tpu.kernels.banded_align import build_banded_scorer
    from abismal_tpu_torch.kernels.banded_align import banded_score_plain

    if pe:
        q, win, bw, qsz = _pe_score_arrays(seed, 128, iupac)
    else:
        rng, genome = _genome(seed, iupac=iupac)
        jobs = _random_jobs(rng, genome, 110, bws=(1, 3, 5, 21, 41, 61))
        q, win, bw, qsz, _, _ = _job_arrays(genome, jobs, 128)
        bw, qsz = bw[:, None], qsz[:, None]
    want = np.asarray(build_banded_scorer(LMAX, interpret=True)(
        q, win, bw, qsz))
    got = banded_score_plain(*(torch.from_numpy(a) for a in (
        q, win, bw, qsz)))
    np.testing.assert_array_equal(got.numpy(), want)
    if pe:
        assert (want[bw < 0] == 0).all() and (want[bw > 1] > 0).sum() > 50


@pytest.mark.parametrize("seed", [7, 8])
def test_tb_block_matches_jax(seed):
    """K3 with the walk fused (banded_trace): (ops, meta) equal to JAX's
    build_tb_block, its tracer + while_loop walk, on every lane, traced or
    not."""
    pytest.importorskip("jax")
    from abismal_tpu.map.pipeline import build_tb_block as jax_tb_block
    from abismal_tpu_torch.kernels.banded_align import banded_trace

    rng, genome = _genome(seed, iupac=30)
    jobs = _random_jobs(rng, genome, 100)
    q, win, bw, qsz, pos, do_tb = _job_arrays(genome, jobs, 128)
    do_tb[5:100:9] = False  # bands still set: the walk must not start
    want = [np.asarray(a) for a in jax_tb_block(LMAX, interpret=True)(
        q, win, bw, qsz, pos, do_tb)]
    got = banded_trace(*(torch.from_numpy(a) for a in (
        q, win, bw, qsz, pos.astype(np.int64), do_tb)))
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])


def _assemble(ops_row, meta_row, qsz):
    n_ops, sb, st, npos = (int(x) for x in meta_row)
    assert n_ops >= 0
    cigar = []
    if st > 0:
        cigar.append((st << CIGAR_SHIFT) | CIGAR_SOFT)
    cigar.extend(int(x) for x in ops_row[:n_ops][::-1])
    if sb > 0:
        cigar.append((sb << CIGAR_SHIFT) | CIGAR_SOFT)
    return cigar, qsz - sb - st, npos & 0xFFFFFFFF


def _trace(genome, jobs, J=128):
    from abismal_tpu_torch.kernels.banded_align import banded_trace

    q, win, bw, qsz, pos, do_tb = _job_arrays(genome, jobs, J)
    ops, meta = banded_trace(*(torch.from_numpy(a) for a in (
        q, win, bw, qsz, pos.astype(np.int64), do_tb)))
    return ops.numpy(), meta.numpy()


def test_device_traceback_matches_oracle():
    """The fused traceback reproduces build_cigar_len_and_pos: cigar ops,
    aligned length and final position."""
    from abismal_tpu.map.align import BandedAligner

    rng, genome = _genome(42)
    jobs = _random_jobs(rng, genome, 96)
    ops, meta = _trace(genome, jobs)
    aln = BandedAligner(genome, use_native=False)
    aln.reset(LMAX)
    n_checked = 0
    for i, (q, bw, qsz, pos) in enumerate(jobs):
        diffs = (bw - 1) // 2  # reproduces this band width exactly
        scr = aln.align(diffs, diffs, q, pos, True)
        want = aln.build_cigar_len_and_pos(diffs, diffs, pos)
        if scr == 0:
            assert int(meta[i, 0]) == -1
            continue
        got = _assemble(ops[i], meta[i], qsz)
        assert got == (want[0], want[1], want[2] % (1 << 32)), i
        n_checked += 1
    assert n_checked > 80


def test_device_traceback_overflow_flags():
    """More cigar runs than TB_NOPS come back n_ops = -1 (the host traces
    that read), never a truncated cigar."""
    from abismal_tpu.map.align import BandedAligner
    from abismal_tpu.map.pipeline import TB_NOPS

    rng, genome = _genome(3, G=4000)
    pos, qsz, bw = 1000, 120, 61
    ql, k = [], 0
    while len(ql) < qsz:  # an indel every 6 bases
        ql.extend(genome[pos + k : pos + k + 5])
        k += 5
        if len(ql) % 2:
            ql.append(1 << int(rng.integers(0, 4)))
        else:
            k += 1
    q = np.array(ql[:qsz], np.uint8)
    ops, meta = _trace(genome, [(q, bw, qsz, pos)])
    aln = BandedAligner(genome, use_native=False)
    aln.reset(LMAX)
    diffs = (bw - 1) // 2
    aln.align(diffs, diffs, q, pos, True)
    want = aln.build_cigar_len_and_pos(diffs, diffs, pos)
    assert len([o for o in want[0] if (o & 0xF) != CIGAR_SOFT]) > TB_NOPS
    assert int(meta[0, 0]) == -1


def _packed_arrays(seed, R=96, n_gw=3000, lmax=LMAX, iupac=40, bws=None):
    """banded_trace_packed's operands as build_stage12 makes them, over a
    packed genome with IUPAC codes: (genome32, pnib, wunit, wbw, wqsz,
    wpos, do_tb).  The first jobs sit where a window leaves the genome:
    before nibble 0 (its start wraps modulo 2^32), across its last word
    and past its end; one lane in eight is untraced (bw 1, qsz 0, pos 0),
    two more are not walked but keep their bands."""
    from abismal_tpu_torch.map.host_units import pack_genome_u32

    n_nib = 8 * n_gw
    rng, genome = _genome(seed, G=n_nib, iupac=iupac)
    assert ((genome & (genome - 1)) != 0).any()  # IUPAC nibbles
    genome32 = pack_genome_u32(_pack_u64(genome))[:n_gw].view(np.int32)
    jobs = _random_jobs(rng, genome, R, bws=bws or (1, 5, 9, 21, 33, 61))
    W = (lmax + 32) // 2
    U = (1 << rng.integers(0, 4, (2 * R, 2 * W))).astype(np.uint8)
    wunit = rng.permutation(2 * R)[:R].astype(np.int64)
    wbw = np.array([j[1] for j in jobs], np.int64)
    wqsz = np.array([j[2] for j in jobs], np.int64)
    wpos = np.array([j[3] for j in jobs], np.int64)
    wpos[:4] = rng.integers(0, 30, 4)
    wpos[4:8] = n_nib - rng.integers(30, 120, 4)
    wpos[8:10] = n_nib + rng.integers(0, 999, 2)
    for i, (q, _, n, _) in enumerate(jobs):
        U[wunit[i]] = 0
        U[wunit[i], :n] = q
    do_tb = np.ones(R, bool)
    do_tb[3::8] = False
    wbw[3::8], wqsz[3::8], wpos[3::8] = 1, 0, 0
    do_tb[[12, 20]] = False
    pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
    return genome32, pnib, wunit, wbw, wqsz, wpos, do_tb


def _pack_u64(nibbles):
    """16 nibbles a u64 word, base i in bits 4 (i mod 16) (the index's
    genome words)."""
    n = -(-nibbles.shape[0] // 16) * 16
    nib = np.zeros(n, np.uint64)
    nib[: nibbles.shape[0]] = nibbles
    sh = (4 * np.arange(16, dtype=np.uint64))[None, :]
    return (nib.reshape(-1, 16) << sh).sum(axis=1).astype(np.uint64)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_banded_trace_packed_plain_matches_operands(seed):
    """banded_trace_packed_plain equals banded_trace_plain on the operands
    build_stage12 used to build for it: the gathered and unpacked query
    rows, the window gathered from the packed genome, every lane padded to
    a multiple of 128.  Seeds carry IUPAC codes, windows before nibble 0
    and past the genome's end, and untraced lanes."""
    from abismal_tpu_torch.kernels import banded_align as ba

    arrs = _packed_arrays(seed)
    genome32, pnib, wunit, wbw, wqsz, wpos, do_tb = (
        torch.from_numpy(a) for a in arrs)
    R = wunit.shape[0]
    got = ba.banded_trace_packed(genome32, pnib, wunit, wbw, wqsz, wpos,
                                 do_tb, LMAX)

    def pad(x, value):
        return torch.cat([x, torch.full((128 - R,), value, dtype=x.dtype)])

    u, b, n, p, t = (pad(wunit, 0), pad(wbw, 1), pad(wqsz, 0), pad(wpos, 0),
                     pad(do_tb, False))
    q2 = ba.unpack_nibbles(pnib[u])[:, :LMAX].to(torch.uint8)
    win2 = ba.window_nibbles(genome32, ba.win_start(p, b) & 0xFFFFFFFF,
                             LMAX + ba.QOFF)
    want = ba.banded_trace_plain(q2, win2, b, n, p, t)
    assert torch.equal(got[0], want[0][:R])
    assert torch.equal(got[1], want[1][:R])
    n_ops = got[1][:, 0]
    assert int((n_ops > 0).sum()) > R // 2  # most lanes are traced
    assert bool((n_ops[3::8] == -1).all()) and bool((n_ops[:4] == -1).all())
    assert int((win2[4:8, -1] == 0).sum()) == 4  # windows past the end


def _device_align_arrays(seed, J=128, lmax=LMAX, iupac=40):
    """build_device_align's operands over a packed genome with its zero
    guard words and IUPAC codes: (genome32 u32, pnib, unit, pos, bw, qsz),
    J jobs (a multiple of the JAX program's 128), the first six with
    windows across the genome's last word and past its end, fill rows
    (bw 1, qsz 0, pos 32767) at the end."""
    from abismal_tpu_torch.map.host_units import pack_genome_u32

    n_nib = 8 * 3000
    rng, genome = _genome(seed, G=n_nib, iupac=iupac)
    genome32 = pack_genome_u32(_pack_u64(genome))
    n = J - J // 16
    jobs = _random_jobs(rng, genome, n, bws=(1, 3, 5, 9, 21, 33, 61))
    W = (lmax + 32) // 2
    U = (1 << rng.integers(0, 4, (2 * J, 2 * W))).astype(np.uint8)
    unit = rng.permutation(2 * J)[:J].astype(np.int32)
    bw = np.ones(J, np.int32)
    qsz = np.zeros(J, np.int32)
    pos = np.full(J, 32767, np.uint32)
    for i, (q, b, m, p) in enumerate(jobs):
        U[unit[i]] = 0
        U[unit[i], :m] = q
        bw[i], qsz[i], pos[i] = b, m, p
    pos[:3] = n_nib - rng.integers(30, 120, 3)
    pos[3:6] = n_nib + rng.integers(0, 999, 3)
    pnib = U[:, 0::2] | (U[:, 1::2] << np.uint8(4))
    return genome32, pnib, unit, pos, bw, qsz


@pytest.mark.parametrize("seed", [31, 32])
def test_banded_score_packed_plain_matches_jax(seed):
    """banded_score_packed_plain equals JAX's build_device_align (its
    Pallas scorer in interpret mode) on the same packed rows and genome,
    windows past the genome's end among the jobs: there the JAX gather
    clamps to the last guard word and the port reads 0, both 0.  No window
    starts before nibble 0: JAX's u32 positions wrap around to the genome's
    start there while the port reads 0, and the 32767 N of padding at the
    genome's ends keep every real job away from it."""
    pytest.importorskip("jax")
    from abismal_tpu.kernels.banded_align import build_device_align
    from abismal_tpu_torch.kernels import banded_align as ba

    arrs = _device_align_arrays(seed)
    want = np.asarray(build_device_align(LMAX, interpret=True)(*arrs))
    genome32, pnib, unit, pos, bw, qsz = arrs
    got = ba.banded_score_packed_plain(
        torch.from_numpy(genome32.view(np.int32)), torch.from_numpy(pnib),
        torch.from_numpy(unit), torch.from_numpy(pos.astype(np.int64)),
        torch.from_numpy(bw), torch.from_numpy(qsz), LMAX)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and int((want > 0).sum()) > 96
    assert int((want[3:6] > 0).sum()) == 0  # windows past the end


def _packed_score_arrays(seed, R, n_gw, lmax=LMAX, bws=None):
    """banded_score_packed's operands (genome32, pnib, unit, pos, bw, qsz)
    from _packed_arrays: windows before nibble 0 and past the genome's
    end, fill rows, and negative bands in every seventh job."""
    genome32, pnib, unit, bw, qsz, pos, _ = _packed_arrays(
        seed, R=R, n_gw=n_gw, lmax=lmax, bws=bws)
    bw[5::7] = -(2 * np.arange(bw[5::7].shape[0]) % 60 + 1)
    return genome32, pnib, unit, pos, bw, qsz


def test_banded_score_packed_plain_matches_operands():
    """The packed plain version equals banded_score_plain on the operands
    the fused SE program built before it: gathered and unpacked query
    rows, windows gathered from the packed genome (before nibble 0 and
    past the end), negative bands and fill rows."""
    from abismal_tpu_torch.kernels import banded_align as ba

    t = [torch.from_numpy(a) for a in _packed_score_arrays(24, 96, 3000)]
    genome32, pnib, unit, pos, bw, qsz = t
    got = ba.banded_score_packed(*t, LMAX)
    q = ba.unpack_nibbles(pnib[unit])[:, :LMAX].to(torch.uint8)
    win = ba.window_nibbles(genome32, ba.win_start(pos, bw) & 0xFFFFFFFF,
                            LMAX + ba.QOFF)
    want = ba.banded_score_plain(q, win, bw, qsz)[:, 0]
    assert torch.equal(got, want)
    assert bool((got[bw < 0] == 0).all()) and int((got > 0).sum()) > 48


@pytest.mark.parametrize("name", ["popcount_compare", "banded_score_packed",
                                  "banded_trace", "banded_trace_packed",
                                  "seed_extend", "segment_rank",
                                  "candidate_list"])
def test_wrapper_raises_off_cpu_and_cuda(name):
    """A wrapper given a tensor that is neither on the CPU nor on a card
    raises; it never falls back to the plain version."""
    from abismal_tpu_torch.kernels import (
        banded_align, candidate_list, popcount_compare, seed_extend,
        segment_rank,
    )

    m = torch.zeros((128, LMAX), dtype=torch.uint8, device="meta")
    w = torch.zeros((128, LMAX + 60), dtype=torch.uint8, device="meta")
    v = torch.ones(128, dtype=torch.int32, device="meta")
    calls = {
        "popcount_compare": lambda: popcount_compare.popcount_compare(
            v, v.long(), torch.zeros((4, 16), dtype=torch.int32,
                                     device="meta"), v.long(), v),
        "banded_score_packed": lambda: banded_align.banded_score_packed(
            v, m, v.long(), v.long(), v.long(), v.long(), LMAX),
        "banded_trace": lambda: banded_align.banded_trace(
            m, w, v, v, v.long(), v.bool()),
        "banded_trace_packed": lambda: banded_align.banded_trace_packed(
            v, m, v.long(), v.long(), v.long(), v.long(), v.bool(), LMAX),
        "seed_extend": lambda: seed_extend.seed_extend(
            v, v.long(), m, v.long(), v.bool(), v.long(),
            *(v.long().reshape(2, 64),) * 4, torch.cat([v, v]).bool(),
            torch.cat([v, v]).long(), 512, LMAX, 100, 4, 9, 129, 256),
        "segment_rank": lambda: segment_rank.segment_rank(
            v.bool(), v.long()[:8], v.long()[:8], v.bool()),
        "candidate_list": lambda: candidate_list.candidate_list(
            v.long().reshape(4, 32), v.long().reshape(4, 32), v.long()[:4],
            v.long()[:4], v.long(), 64, 256),
    }
    with pytest.raises(ValueError):
        calls[name]()


# --- on the card: each CUDA kernel against its plain version ---------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_popcount_compare_kernel_matches_plain(cuda_device):
    from abismal_tpu_torch.kernels import popcount_compare as pc

    args = _k1_torch(*_k1_arrays(3, G=1 << 16, B=1024), device=cuda_device)
    n0 = pc.popcount_compare.launches
    got = pc.popcount_compare(*args)
    torch.cuda.synchronize()
    assert pc.popcount_compare.launches == n0 + 1
    assert torch.equal(got, pc.popcount_compare_plain(*args))


@pytest.mark.cuda
def test_banded_score_kernel_matches_plain(cuda_device):
    """K2 (banded_score_packed) on 1024 jobs of bands 1..61 over a genome
    with IUPAC codes."""
    from abismal_tpu_torch.kernels import banded_align as ba

    rng, genome = _genome(9, iupac=50)
    jobs = _random_jobs(rng, genome, 1000, bws=(1, 3, 5, 21, 41, 61))
    q, _, bw, qsz, pos, _ = _job_arrays(genome, jobs, 1024)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in _as_packed(genome, q, bw, qsz, pos)]
    got = ba.banded_score_packed(*t, LMAX)
    torch.cuda.synchronize()
    assert torch.equal(got, ba.banded_score_packed_plain(*t, LMAX))


@pytest.mark.cuda
def test_banded_score_kernel_pe_shape_matches_plain(cuda_device):
    """K2 at build_stage12pe's shape (J = 8 x 2048 units), with negative
    bands and fill rows."""
    from abismal_tpu_torch.kernels import banded_align as ba

    t = [torch.from_numpy(a).to(cuda_device)
         for a in _pe_score_arrays(12, 16384, packed=True)]
    got = ba.banded_score_packed(*t, LMAX)
    torch.cuda.synchronize()
    assert torch.equal(got, ba.banded_score_packed_plain(*t, LMAX))
    assert bool((got[t[4] < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow", "mid", "bw61", "negative-fill",
                                  "ragged", "byte-rows"])
def test_banded_score_kernel_cases(cuda_device, case):
    """K2 (banded_score_packed) where its lane groups change: the cases of
    _k2_case, 1024 jobs of each."""
    from abismal_tpu_torch.kernels import banded_align as ba

    arrs, lq = _k2_case(case, 1024)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    n0 = ba.banded_score_packed.launches
    got = ba.banded_score_packed(*t, lq)
    torch.cuda.synchronize()
    assert ba.banded_score_packed.launches == n0 + 1
    assert torch.equal(got, ba.banded_score_packed_plain(*t, lq))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shift0", "past-end", "nw2", "nw16",
                                  "ragged-genome", "nw-words-18",
                                  "nw-words-32"])
def test_popcount_compare_kernel_cases(cuda_device, case):
    """K1 at the edges of its loads: every position on a word (pos & 7 ==
    0), positions past the end of the genome, the shortest and the longest
    word counts, a genome that does not end on a quad of words, and read
    units that are not 16 words (18: no 128-bit rows; 32: two turns)."""
    from abismal_tpu_torch.kernels import popcount_compare as pc

    kw = dict(G=4099, B=64)
    if case == "ragged-genome":
        kw["n_gw"] = 4093
    if case.startswith("nw-words"):
        kw["nw_words"] = int(case.rsplit("-", 1)[1])
    genome32, pos, pk, b_of, nw_of = _k1_arrays(21, **kw)
    if case == "shift0":
        pos &= ~7
    elif case == "past-end":
        pos[:] = 8 * genome32.shape[0] - np.arange(pos.shape[0]) % 160
        pos[::3] += 4096
    elif case == "nw2":
        nw_of[:] = 2
    elif case == "nw16":
        nw_of[:] = 16
    args = _k1_torch(genome32, pos, pk, np.sort(b_of), nw_of,
                     device=cuda_device)
    got = pc.popcount_compare(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, pc.popcount_compare_plain(*args))


@pytest.mark.cuda
def test_banded_trace_kernel_matches_plain(cuda_device):
    from abismal_tpu_torch.kernels import banded_align as ba

    rng, genome = _genome(10, iupac=50)
    jobs = _random_jobs(rng, genome, 1000)
    q, win, bw, qsz, pos, do_tb = _job_arrays(genome, jobs, 1024)
    do_tb[::7] = False
    bw[~do_tb], qsz[~do_tb] = 1, 0
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (q, win, bw, qsz, pos.astype(np.int64), do_tb)]
    got = ba.banded_trace(*t)
    torch.cuda.synchronize()
    want = ba.banded_trace_plain(*t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k3_case(case):
    """(arrays, lmax, max_step) of one K3 case: q, win, bw, qsz, pos,
    do_tb."""
    from abismal_tpu_torch.kernels import banded_align as ba

    lmax = {"lmax64": 64, "lmax256": 256}.get(case, LMAX)
    rng, genome = _genome(31, iupac=50)
    J = 1003 if case == "ragged" else 256
    bws = {"bw1": (1,), "bw61": (61,), "narrow": (1, 3, 5, 9, 13, 21),
           "wide-among-narrow": (5, 21, 33, 9, 61, 21, 45, 3, 13)}.get(
               case, (5, 9, 15, 21, 31, 41, 61))
    jobs = _random_jobs(rng, genome, J - 16, bws=bws)
    if case in ("qsz49", "qsz-lmax", "lmax64", "lmax256"):
        n = {"qsz49": 49, "lmax64": 64}.get(case, lmax)
        jobs = []
        for i in range(J - 16):
            p = int(rng.integers(200, genome.shape[0] - 400))
            q = genome[p : p + n].copy()
            q[rng.integers(0, n, 3)] = 1 << rng.integers(0, 4, 3)
            if i % 3 == 0:  # a deletion
                q = np.concatenate([q[: n // 2], genome[p + n // 2 + 1 :
                                                        p + n + 1]])
            jobs.append((q, int(bws[i % len(bws)]), n, p))
    if case == "overflow":  # an indel every 6 bases: > TB_NOPS runs
        for i in range(0, 40, 3):
            p = int(rng.integers(200, genome.shape[0] - 400))
            ql, k = [], 0
            while len(ql) < 120:
                ql.extend(genome[p + k : p + k + 5])
                k += 5
                if len(ql) % 2:
                    ql.append(1 << int(rng.integers(0, 4)))
                else:
                    k += 1
            jobs[i] = (np.array(ql[:120], np.uint8), 61, 120, p)
    q, win, bw, qsz, pos, do_tb = _job_arrays(genome, jobs, J, lmax)
    if case == "untraced":
        do_tb[:] = False
        bw[:], qsz[:] = 1, 0
    elif case == "not-walked":  # bands stay: the tables run, no walk
        do_tb[::3] = False
    else:
        do_tb[5::7] = False
        bw[5::7], qsz[5::7] = 1, 0
    return ([q, win, bw, qsz, pos.astype(np.int64), do_tb], lmax,
            40 if case == "step-cap" else ba.walk_step_cap(lmax))


K3_CASES = ["untraced", "not-walked", "bw1", "bw61", "narrow",
            "wide-among-narrow", "qsz49", "qsz-lmax", "overflow", "step-cap",
            "ragged", "lmax64", "lmax256"]


@pytest.mark.parametrize("case", K3_CASES)
def test_banded_trace_plain_cases(case):
    """The K3 case list holds what it says, on the plain version (the CUDA
    kernel runs the same list under -m cuda): which lanes are traced,
    which overflow the op buffer or stop at the step cap, and that a lane
    that is not walked still reports its best cell."""
    from abismal_tpu_torch.kernels import banded_align as ba

    arrs, lmax, max_step = _k3_case(case)
    t = [torch.from_numpy(a)[:64] for a in arrs]
    ops, meta = ba._trace(*t, max_step)
    assert ops.shape == (64, ba.TB_NOPS) and meta.shape == (64, 4)
    assert t[0].shape[1] == lmax
    n_ops = meta[:, 0]
    walked = t[5] & (t[3] > 0)
    assert bool((n_ops[~walked] == -1).all())
    assert bool((ops[~walked] == 0).all())
    if case == "untraced":
        # no live cell: soft_bottom = qsz - 1 + QOFF, soft_top = -QOFF
        assert bool((meta[:, 1] == ba.QOFF - 1).all())
        assert bool((meta[:, 2] == -ba.QOFF).all())
    elif case == "overflow":
        assert int((n_ops[:40:3] == -1).sum()) > 5
    elif case == "step-cap":
        assert int((n_ops[walked] == -1).sum()) > 20
    elif case == "not-walked":
        # the best cell of a lane that is not walked: soft_bottom as if it
        # were, which only the tables give
        full = ba.banded_trace(*t[:5], torch.ones_like(t[5]))[1]
        assert torch.equal(meta[::3, 1], full[::3, 1])
        assert int((full[::3, 0] > 0).sum()) > 10
    else:
        assert int((n_ops[walked] > 0).sum()) > int(walked.sum()) * 3 // 4
        runs = (ops.long() >> 4).sum(dim=1)
        aligned = t[3] - meta[:, 1] - meta[:, 2]
        q_runs = torch.where((ops & 0xF) != 2, ops.long() >> 4, 0).sum(dim=1)
        ok = n_ops > 0
        # M and I runs cover the aligned part of the query
        assert torch.equal(q_runs[ok], aligned[ok].long())
        assert bool((runs[ok] >= q_runs[ok]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", K3_CASES)
def test_banded_trace_kernel_cases(cuda_device, case):
    """K3 where its layout changes: every lane untraced (the warp leaves
    before staging), lanes that run their tables but are not walked, bw 1
    and bw 61 alone, the narrow bands of -m 0.1 (one column pair a lane),
    bands of 33-61 among narrow ones in one warp (two pairs a lane), the
    shortest and the longest reads, more cigar runs than TB_NOPS, a walk
    cut at the step cap (inside a run of M arrows too), J not a multiple
    of the two jobs of a warp, and rows of 64 and 256 bases."""
    from abismal_tpu_torch.kernels import banded_align as ba

    arrs, _, max_step = _k3_case(case)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    n0 = ba.banded_trace.launches
    got = ba._trace(*t, max_step)
    torch.cuda.synchronize()
    assert ba.banded_trace.launches == n0 + 1
    want = ba._trace_plain(*t, max_step)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "narrow", "ragged", "lmax-odd"])
def test_banded_trace_packed_kernel_matches_plain(cuda_device, case):
    """banded_trace_packed against its plain version: IUPAC codes, windows
    before nibble 0, across the genome's last word and past its end,
    untraced lanes; R not a multiple of the jobs of a warp; an odd row
    length."""
    from abismal_tpu_torch.kernels import banded_align as ba

    R = 1001 if case == "ragged" else 512
    lmax = 125 if case == "lmax-odd" else LMAX
    arrs = _packed_arrays(33, R=R, n_gw=40000, bws=(
        (1, 3, 5, 9, 13, 21) if case == "narrow" else None))
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    n0 = ba.banded_trace_packed.launches
    got = ba.banded_trace_packed(*t, lmax)
    torch.cuda.synchronize()
    assert ba.banded_trace_packed.launches == n0 + 1
    want = ba.banded_trace_packed_plain(*t, lmax)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[1][:, 0] > 0).sum()) > R // 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "narrow", "ragged", "lmax-odd"])
def test_banded_score_packed_kernel_matches_plain(cuda_device, case):
    """banded_score_packed against its plain version: IUPAC codes, windows
    before nibble 0, across the genome's last word and past its end,
    negative bands, fill rows; J not a multiple of the jobs of a warp; an
    odd row length."""
    from abismal_tpu_torch.kernels import banded_align as ba

    J = 1001 if case == "ragged" else 2048
    lmax = 125 if case == "lmax-odd" else LMAX
    arrs = _packed_score_arrays(34, J, 40000, bws=(
        (1, 3, 5, 9, 13, 21) if case == "narrow" else None))
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    n0 = ba.banded_score_packed.launches
    got = ba.banded_score_packed(*t, lmax)
    torch.cuda.synchronize()
    assert ba.banded_score_packed.launches == n0 + 1
    want = ba.banded_score_packed_plain(*t, lmax)
    assert torch.equal(got, want) and int((want > 0).sum()) > J // 2


@pytest.fixture
def other_card():
    """The last card, when it is not cuda:0."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card(other_card):
    """K1, K2 and K3 (both of K3's entry points) on the last card while cuda:0 is
    current: each wrapper makes its tensors' device current around the
    launch, and each result equals its plain version."""
    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import popcount_compare as pc

    rng, genome = _genome(11, iupac=50)
    q, win, bw, qsz, pos, do_tb = _job_arrays(
        genome, _random_jobs(rng, genome, 500), 512)
    k1 = _k1_torch(*_k1_arrays(4, G=1 << 14, B=256), device=other_card)
    k3 = [torch.from_numpy(a).to(other_card)
          for a in (q, win, bw, qsz, pos.astype(np.int64), do_tb)]
    k3p = [torch.from_numpy(a).to(other_card)
           for a in _packed_arrays(12, R=256, n_gw=20000)]
    k2p = [torch.from_numpy(a).to(other_card)
           for a in _packed_score_arrays(13, 256, 20000)]
    with torch.cuda.device(0):
        got = (pc.popcount_compare(*k1), ba.banded_score_packed(*k2p, LMAX),
               *ba.banded_trace(*k3), *ba.banded_trace_packed(*k3p, LMAX))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other_card)
    want = (pc.popcount_compare_plain(*k1),
            ba.banded_score_packed_plain(*k2p, LMAX),
            *ba.banded_trace_plain(*k3),
            *ba.banded_trace_packed_plain(*k3p, LMAX))
    for g, w in zip(got, want):
        assert g.device == other_card and torch.equal(g, w)


# --- K4: the pooled seed extension -----------------------------------------

HERE = os.path.dirname(os.path.abspath(__file__))
# K4's cases: lanes of real units, the arguments the candidate core hands
# the wrapper (see ext_case)
EXT_CASES = ("trex1", "trex1-empty", "repeat-w2", "repeat-w4", "repeat-w8",
             "lmax256", "deep", "dl0", "nonmono", "full-pool")
# the argument list's places (ext_args): the lane flags and their prefix
# count, the pool, lmax, mc, ways, kary_iters, ext_w, the sort depth
EXT_ACT, EXT_CUM, EXT_POOL, EXT_LMAX, EXT_MC, EXT_WAYS, EXT_ITERS = range(
    10, 17)
EXT_NSORT = 18


def golden_reads(name, n):
    """The first n reads of tests/golden/<name>.gz."""
    with gzip.open(os.path.join(HERE, "golden", name + ".gz"), "rb") as f:
        return f.read().split(b"\n")[1::4][:n]


def genome_reads(fa, n, length, seed):
    """n exact substrings of length bases of the FASTA fa."""
    with open(fa, "rb") as f:
        seq = b"".join(ln.strip() for ln in f if not ln.startswith(b">"))
    starts = np.random.default_rng(seed).integers(0, len(seq) - length, n)
    return [seq[s : s + length].upper() for s in starts]


def ext_args(index, reads, lmax=LMAX, mc=None, ext_pool=512,
             device="cpu"):
    """The arguments the candidate core hands K4 (seed_extend) on the
    T-rich and A-rich units of reads, recorded from a run of _make_core
    (cut "extend") with the wrapper stood in for: a list of 12 tensors on
    device and the 7 ints."""
    from abismal_tpu_torch.map import pipeline as pl
    from abismal_tpu_torch.map.host_units import (
        get_conv_is_ga, prepare_units, strand_code,
    )
    from abismal_tpu_torch.map.seeds import prep_read

    units, is_ga = [], []
    for r in reads:
        for a_rich in (False, True):
            units.append(prep_read(r, a_rich))
            is_ga.append(get_conv_is_ga(strand_code("+", a_rich)))
    pnib, lens = prepare_units(units, lmax)
    dev = pl.DeviceIndex.from_index(index, device)
    core, _ = pl._make_core(lmax, mc or dev.max_candidates, dev.n_index2,
                            dev.n_index3, 64, ext_iters=dev.ext_iters,
                            ext_pool=ext_pool, cut="extend")
    seen, inner = [], pl.seed_extend

    def record(*args):
        seen.append(args)
        return inner(*args)

    pl.seed_extend = record
    try:
        core(*dev.tables(), *(torch.from_numpy(np.asarray(a)).to(device)
                              for a in (pnib, lens, np.array(is_ga),
                                        np.zeros((len(units), 1), np.int32))))
    finally:
        pl.seed_extend = inner
    (args,) = seen
    return list(args)


def repeat_genome(out_dir):
    """(index, reads, FASTA path) of the seed-extension check's repeat
    genome (abismal_tpu_torch/tools/debug_ext.py): buckets far above
    max_candidates, whose windows are full of equal LCPs."""
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.tools.debug_ext import ext_genome

    fa = os.path.join(str(out_dir), "ext_genome.fa")
    reads = ext_genome(fa)
    return create_index(fa), reads, fa


def live_lanes(args):
    """K4's pooled lanes on args: (cell id, three-letter, cell of its
    table), one entry a live slot, in slot order."""
    from abismal_tpu_torch.kernels.seed_extend import pool_lanes

    B, o_spec = args[6].shape
    n = B * o_spec
    lane_id = pool_lanes(args[EXT_ACT], args[EXT_CUM], args[EXT_POOL])
    lid = lane_id[lane_id < 2 * n].cpu()
    return lid, lid >= n, lid % n


def shuffle_buckets(args, seed):
    """args with the buckets of every live lane permuted in index_all, so
    that the genome's class strings along a bucket are not in order (as
    on an IUPAC genome, whose three-letter keys wrap mod 3^16)."""
    _, t3, rem = live_lanes(args)
    s2, e2, s3, e3, base3 = (args[i].cpu() for i in (6, 7, 8, 9, 5))
    o_spec = s2.shape[1]
    lo = torch.where(t3, s3.reshape(-1)[rem], s2.reshape(-1)[rem])
    hi = torch.where(t3, e3.reshape(-1)[rem], e2.reshape(-1)[rem])
    base = torch.where(t3, base3[rem // o_spec], 0)
    idx = args[1].cpu().numpy().copy()
    rng = np.random.default_rng(seed)
    for a, b in sorted(set(zip((base + lo).tolist(), (base + hi).tolist()))):
        idx[a:b] = idx[a:b][rng.permutation(b - a)]
    out = list(args)
    out[1] = torch.from_numpy(idx).to(args[1].device)
    return out


def nonmonotone_trips(args):
    """(lane, trip, bound) triples of the plain version's search on args
    whose bound was open and whose compares were not monotone along the
    probes (a false probe before a true one): the trips after which a
    bound is not one of the sub-intervals of the trip's probes."""
    from abismal_tpu_torch.kernels import seed_extend as se

    calls, inner = [], se.lex

    def rec(gcls, qcls, D, wj8):
        lcp, cmp = inner(gcls, qcls, D, wj8)
        calls.append(cmp.cpu())
        return lcp, cmp

    se.lex = rec
    try:
        se.seed_extend_plain(*args)
    finally:
        se.lex = inner
    ways, iters = args[EXT_WAYS], args[EXT_ITERS]
    B, o_spec = args[6].shape
    n = B * o_spec
    lane_id = se.pool_lanes(args[EXT_ACT], args[EXT_CUM], args[EXT_POOL])
    live = (lane_id < 2 * n).cpu()
    lid = lane_id.clamp(max=2 * n - 1).cpu()
    t3, rem = lid >= n, lid % n
    s2, e2, s3, e3 = (args[i].cpu().reshape(-1) for i in (6, 7, 8, 9))
    lo0 = torch.where(t3, s3[rem], s2[rem])
    hi0 = torch.where(t3, e3[rem], e2[rem])
    P, nprb = lane_id.shape[0], ways - 1
    kf = torch.arange(1, ways)[:, None]
    aL, bL, aU, bU = lo0, hi0, lo0, hi0
    found = 0
    for cmp in calls[:iters]:
        out = []
        for h, (a, b) in enumerate(((aL, bL), (aU, bU))):
            w = b - a
            p = (a[None] + kf * (w[None] // ways)
                 + (kf * (w[None] % ways)) // ways)
            c = cmp[h * nprb * P : (h + 1) * nprb * P].reshape(nprb, P)
            g = c < 0 if h == 0 else c <= 0
            # a false probe before a true one
            seen_false = torch.cummax((~g).int(), dim=0).values.bool()
            bad = (seen_false[:-1] & g[1:]).any(dim=0)
            found += int((bad & (a < b) & live).sum())
            op = (a < b)[None]
            out += [torch.where(op & g, p + 1, a[None]).max(dim=0).values,
                    torch.where(op & ~g, p, b[None]).min(dim=0).values]
        aL, bL, aU, bU = out
    return found


def ext_case(name, trex1, repeat, device="cpu", pool=512):
    """K4's arguments for case name: tRex1 lanes (64 golden reads,
    max_candidates 2) and a pool of mostly empty slots (max_candidates
    10: a few lanes); the repeat genome at ways 2, 4, 8 (with their trip
    counts); lmax 256 on 250-base substrings of tRex1, and the same with a
    sort depth of 150 so that lanes turn deep; units cut short so that
    lanes have depth Dl = 0; the repeat genome's lanes with their buckets
    shuffled and three trips of the search (nonmono); 512 slots, every one
    live, from 200 more reads of the repeat genome (full-pool)."""
    from abismal_tpu_torch.kernels.seed_extend import kary_iters_for
    from abismal_tpu_torch.map.host_units import ext_iters_for

    if name.startswith("repeat") or name == "nonmono":
        index, reads, _ = repeat
        args = ext_args(index, reads, ext_pool=pool, device=device)
        ways = 4 if name == "nonmono" else int(name[-1])
        args[EXT_WAYS:EXT_ITERS + 1] = [
            ways, kary_iters_for(ext_iters_for(index), ways)]
        if name == "nonmono":
            args = shuffle_buckets(args, 15)
            args[EXT_ITERS] = 3  # below convergence: two rounds, 2 + 1
        return args
    if name == "full-pool":
        index, reads, fa = repeat
        reads = reads + genome_reads(fa, 200, 100, 15)
        return ext_args(index, reads, ext_pool=512, device=device)
    if name in ("lmax256", "deep"):
        reads = genome_reads(os.path.join(HERE, "data", "tRex1.fa"), 32,
                             250, 5)
        args = ext_args(trex1, reads, lmax=256, mc=2, ext_pool=pool // 2,
                        device=device)
        if name == "deep":
            args[EXT_NSORT] = 150
        return args
    reads = golden_reads("small_1.fq", 64)
    args = ext_args(trex1, reads, mc=10 if name == "trex1-empty" else 2,
                    ext_pool=pool, device=device)
    if name == "dl0":
        lens = args[3].clone()
        lens[::5] = 10  # shorter than either key: Dl = 0
        args[3] = lens
    return args


def ext_case_covers(name, args, want):
    """What case name must exercise, read from its arguments and the plain
    version's outputs (the cells and ext_fb)."""
    from abismal_tpu_torch.constants import KEY_WEIGHT_THREE

    pool, lmax, mc = args[EXT_POOL], args[EXT_LMAX], args[EXT_MC]
    o_spec = args[6].shape[1]
    lid, t3, rem = live_lanes(args)
    cells = [w.cpu().reshape(-1) for w in want[:6]]
    l_out = torch.where(t3, cells[3][rem], cells[0][rem])
    lo_f = torch.where(t3, cells[4][rem], cells[1][rem])
    hi_f = torch.where(t3, cells[5][rem], cells[2][rem])
    ext_fb = want[6].cpu()
    lens = args[3].cpu()
    assert lid.shape[0] > 0
    if name == "trex1-empty":
        assert pool - lid.shape[0] > pool // 2
    if name.startswith("repeat"):  # ranges still above mc, and narrowed
        assert int(((hi_f - lo_f) > mc).sum()) > 0
        assert int((l_out > KEY_WEIGHT_THREE + 1).sum()) > 0
    if name == "deep":
        deep = lens[rem // o_spec] - rem % o_spec > args[EXT_NSORT]
        assert int(deep.sum()) > 0 and bool(ext_fb[rem[deep] // o_spec].all())
    if name == "dl0":
        assert int(((rem // o_spec) % 5 == 0).sum()) > 0
    if name == "lmax256":  # compares deeper than lmax 128's 14 words
        depth = lens[rem // o_spec] - rem % o_spec - 16
        assert lmax == 256 and int(depth.max()) > 8 * 14
    if name == "nonmono":  # trips that leave no sub-interval
        assert nonmonotone_trips(args) > 0
    if name == "full-pool":  # every slot live, and lanes past the pool
        total = int(args[EXT_CUM][-1])
        assert pool == 512 and lid.shape[0] == pool < total
        assert bool(ext_fb.any())


@pytest.fixture(scope="module")
def ext_genomes(tmp_path_factory):
    """(the tRex1 index, (repeat index, reads, FASTA)), built with the
    port."""
    from abismal_tpu_torch.index.build import create_index

    return (create_index(os.path.join(HERE, "data", "tRex1.fa")),
            repeat_genome(tmp_path_factory.mktemp("repeat")))


@pytest.mark.cuda
@pytest.mark.parametrize("case", EXT_CASES)
def test_seed_extend_kernel_matches_plain(cuda_device, ext_genomes, case):
    """K4 against its plain version on the card: every cell and ext_fb
    equal."""
    from abismal_tpu_torch.kernels import seed_extend as se

    args = ext_case(case, *ext_genomes, device=cuda_device)
    n0 = se.seed_extend.launches
    got = se.seed_extend(*args)
    torch.cuda.synchronize()
    assert se.seed_extend.launches == n0 + 1
    want = se.seed_extend_plain(*args)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    ext_case_covers(case, args, want)


# --- K5 (segment_rank) and K6 (candidate_list) ------------------------------

# K5's cases: spans laid out as the fused programs lay out reads (SE, with
# the exact-match mask) or units (PE, "pe"); see scan_case
SCAN_CASES = ("mixed", "empty-segments", "all-gated", "none-gated",
              "long-tail", "clamped", "long-segment", "long-segments", "pe")
# K6's cases: the cells of B units as the core makes them; see list_case
LIST_CASES = ("tail", "over-gflat", "cellcap", "big-units", "lmax256",
              "empty-units", "all-empty")
CELLCAP = 128


def scan_case(name, seed=0):
    """K5's arguments (gate, seg_start, seg_end, ex or None), numpy, as the
    fused programs make them: spans of random sizes, laid out by their
    prefix and clamped to n, and gates false from the last span's end on
    (the programs gate on valid = f < total).  "empty-segments" has runs
    of empty spans (reads that share a start; the first and the last
    ones empty), "long-tail" a pool mostly past its last span (several
    tail warps), "clamped" spans that reach past n (starts at n),
    "long-segment" one span of 2,500 entries, "long-segments" a dozen of
    up to 1,500 (spans across the kernel's regions of 1,024)."""
    rng = np.random.default_rng(seed + 10 * SCAN_CASES.index(name))
    n, n_seg, size = 4099, 97, 60
    if name == "long-tail":
        n, n_seg, size = 9001, 40, 30
    elif name == "clamped":
        n, n_seg = 3000, 120
    elif name == "long-segment":
        n_seg = 9
    elif name == "long-segments":
        n, n_seg, size = 12000, 12, 1500
    span = rng.integers(0, size, n_seg, endpoint=True)
    if name == "empty-segments":
        span[rng.random(n_seg) < 0.6] = 0
        span[:3] = span[-2:] = 0
    if name == "long-segment":
        span[4] = 2500
    start = np.cumsum(span) - span
    total = int(span.sum())
    if name == "clamped":
        assert total > n and int((start >= n).sum()) > 2
    elif name == "long-tail":
        assert n - total > 3 * 2048
    else:
        assert total < n
    live = np.arange(n) < min(total, n)
    p = {"all-gated": 1.0, "none-gated": 0.0}.get(name, 0.45)
    gate = live & (rng.random(n) < p)
    ex = None if name == "pe" else gate & (rng.random(n) < 0.3)
    return (gate, np.minimum(start, n), np.minimum(start + span, n), ex)


def list_case(name, seed=0):
    """K6's arguments (cnt_cells, lo_cells, unit_start, unit_total,
    index_all, o_spec, gflat), numpy and ints, as the core makes them at
    lmax 128 (n_cells 336) or 256 ("lmax256", 720): sparse cell counts up
    to CELLCAP, bucket offsets into a random index whose entries include
    values below a cell's seed offset (their positions wrap modulo 2^32).
    "tail" leaves most of the list past the last candidate (whose cell,
    the last overall, holds 3), "over-gflat" holds more candidates than
    the list (units past it, one straddling it), "cellcap" a unit at
    CELLCAP in 60 cells and two of 129 and 128 candidates (the kernel's
    unit warps write 128), "big-units" three units
    at CELLCAP in 40 cells with the list's end inside the third,
    "empty-units" half of the units (the last three among them) without
    candidates, "all-empty" none at all."""
    from abismal_tpu_torch.constants import KEY_WEIGHT
    from abismal_tpu_torch.map.host_units import o_spec_for

    rng = np.random.default_rng(100 + seed + 10 * LIST_CASES.index(name))
    lmax = 256 if name == "lmax256" else LMAX
    o_spec = o_spec_for(lmax)
    n_cells = 2 * (o_spec + lmax - KEY_WEIGHT + 1)
    B, cand, n_idx = 24, 48, 5000
    cnt = np.where(rng.random((B, n_cells)) < 0.04,
                   rng.integers(1, 6, (B, n_cells)), 0)
    if name in ("tail", "lmax256"):  # tails over two tail warps
        cand = 200
        cnt[-1, -1] = 3
    elif name == "over-gflat":
        cand = 8
    elif name == "cellcap":
        cnt[5, 10:70] = CELLCAP
        cnt[7], cnt[8] = 0, 0
        cnt[7, :43], cnt[8, 100:132] = 3, 4
        cand = 400
    elif name == "big-units":
        cnt[[3, 4, 10], 20:60] = CELLCAP
        unit_total = cnt.sum(axis=1)
        cand = int(np.cumsum(unit_total)[9] + 2500) // B
    elif name == "empty-units":
        cnt[rng.random(B) < 0.5] = 0
        cnt[-3:] = 0
    elif name == "all-empty":
        cnt[:] = 0
    idx = rng.integers(0, 1 << 32, n_idx, dtype=np.uint64).astype(np.int64)
    idx[::7] = rng.integers(0, 4, idx[::7].shape[0])
    lo = rng.integers(0, n_idx - CELLCAP, (B, n_cells))
    unit_total = cnt.sum(axis=1)
    unit_start = np.cumsum(unit_total) - unit_total
    gflat, total = B * cand, int(unit_total.sum())
    assert (total > gflat) == (name in ("over-gflat", "big-units"))
    return (cnt.astype(np.int64), lo.astype(np.int64), unit_start,
            unit_total, idx, o_spec, gflat)


def scan_torch(args, device="cpu"):
    """numpy arrays of a K5 or K6 case as tensors on device (ints and
    None as they are)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            if isinstance(a, np.ndarray) else a for a in args]


def program_scan_args(index, device="cpu"):
    """The arguments that the engine's programs hand K5 and K6 on their
    first chunk (128 units) of golden reads and pairs (small_1.fq,
    small_pe), recorded with the wrappers stood in for: {"se": (K5's,
    K6's), "pe": (K5's, K6's)}, tensors on device."""
    from abismal_tpu_torch.map import pipeline as pl
    from abismal_tpu_torch.tools import _workload as W

    eng = pl.TorchNativeEngine(index, unit_batch=128, n_threads=1,
                               device=device, graphs=False)
    names = ("segment_rank", "candidate_list")
    inner = {k: getattr(pl, k) for k in names}
    seen = {k: [] for k in names}

    def stand_in(name):
        def call(*args):
            seen[name].append(args)
            return inner[name](*args)
        return call

    out = {}
    try:
        for k in names:
            setattr(pl, k, stand_in(k))
        def reads(name, n):
            return W.load_reads(os.path.join(HERE, "golden", name + ".gz"), n)

        se = W.se_chunk(eng, reads("small_1.fq", 64))
        eng._stage12_prog(se.per, se.budget)(*eng.dev.tables(), *se.on(eng))
        out["se"] = (seen["segment_rank"][-1], seen["candidate_list"][-1])
        pe = W.pe_chunk(eng, reads("small_pe_1.fq", 32),
                        reads("small_pe_2.fq", 32))
        eng._stage12pe_prog(pe.per, pe.budget)(*eng.dev.tables(),
                                               *pe.on(eng))
        out["pe"] = (seen["segment_rank"][-1], seen["candidate_list"][-1])
    finally:
        for k in names:
            setattr(pl, k, inner[k])
        eng.close()
    assert all(len(v) == 2 for v in seen.values())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_segment_rank_kernel_matches_plain(cuda_device, case):
    """K5 against its plain version on the card: every rank and count
    equal, one launch."""
    from abismal_tpu_torch.kernels import segment_rank as sr

    args = scan_torch(scan_case(case), cuda_device)
    n0 = sr.segment_rank.launches
    got = sr.segment_rank(*args)
    torch.cuda.synchronize()
    assert sr.segment_rank.launches == n0 + 1
    want = sr.segment_rank_plain(*args)
    assert len(got) == len(want) == (2 if case == "pe" else 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LIST_CASES)
def test_candidate_list_kernel_matches_plain(cuda_device, case):
    """K6 against its plain version on the card: every entry of the list
    equal, the tail's too, one launch."""
    from abismal_tpu_torch.kernels import candidate_list as cl

    args = scan_torch(list_case(case), cuda_device)
    n0 = cl.candidate_list.launches
    got = cl.candidate_list(*args)
    torch.cuda.synchronize()
    assert cl.candidate_list.launches == n0 + 1
    want = cl.candidate_list_plain(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_scan_kernels_on_program_inputs(cuda_device):
    """K5 and K6 on the card on what the engine's SE and PE programs hand
    them (tRex1, golden reads and pairs): equal to their plain versions."""
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.kernels import candidate_list as cl
    from abismal_tpu_torch.kernels import segment_rank as sr

    index = create_index(os.path.join(HERE, "data", "tRex1.fa"))
    for kind, (a5, a6) in program_scan_args(index, cuda_device).items():
        for kernel, plain, args in ((sr.segment_rank, sr.segment_rank_plain,
                                     a5),
                                    (cl.candidate_list,
                                     cl.candidate_list_plain, a6)):
            for g, w in zip(kernel(*args), plain(*args)):
                assert g.dtype == w.dtype and torch.equal(g, w), kind


@pytest.mark.cuda
def test_scan_kernels_are_capturable(cuda_device):
    """K5 and K6 captured in one CUDA graph (each one launch on the
    capture stream, no host sync), replayed on new inputs copied into the
    captured ones: equal to their plain versions on those inputs, and each
    counter moved once, at the capture."""
    from abismal_tpu_torch.kernels import candidate_list as cl
    from abismal_tpu_torch.kernels import segment_rank as sr

    a5 = scan_torch(scan_case("mixed"), cuda_device)
    a6 = scan_torch(list_case("tail"), cuda_device)

    def run():
        return sr.segment_rank(*a5), cl.candidate_list(*a6)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    n5, n6 = sr.segment_rank.launches, cl.candidate_list.launches
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out5, out6 = run()
    assert (sr.segment_rank.launches, cl.candidate_list.launches) == (
        n5 + 1, n6 + 1)
    for dst, src in ((a5, scan_case("mixed", 1)), (a6, list_case("tail", 1))):
        for d, a in zip(dst, scan_torch(src, cuda_device)):
            if torch.is_tensor(d):
                d.copy_(a)
    g.replay()
    torch.cuda.synchronize()
    for got, want in ((out5, sr.segment_rank_plain(*a5)),
                      (out6, cl.candidate_list_plain(*a6))):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
