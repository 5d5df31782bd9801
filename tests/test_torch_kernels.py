"""The port's kernels (abismal_tpu_torch/kernels): each plain PyTorch
version against the JAX package's Pallas kernel (interpret mode) on the
same arrays, the fused traceback against the host aligner, and -- on a
machine with a card -- each CUDA kernel against its plain version.  All
comparisons are exact (integer arithmetic, tolerance 0)."""

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


def _pe_score_arrays(seed, J, iupac=60):
    """K2 inputs as build_stage12pe gives them: bands 1..61, negative
    bands (IUPAC diffs below zero, never remapped) and fill rows (bw = 1,
    qsz = 0) among the jobs, padding lanes at the end."""
    rng, genome = _genome(seed, iupac=iupac)
    jobs = _random_jobs(rng, genome, J - J // 16, bws=(1, 3, 5, 21, 41, 61))
    q, win, bw, qsz, _, _ = _job_arrays(genome, jobs, J)
    bw[3::7] = -(2 * rng.integers(0, 30, bw[3::7].shape[0]) + 1)
    bw[5::11], qsz[5::11] = 1, 0
    return q, win, bw[:, None], qsz[:, None]


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


@pytest.mark.parametrize("name", ["popcount_compare", "banded_score",
                                  "banded_trace", "banded_trace_packed"])
def test_wrapper_raises_off_cpu_and_cuda(name):
    """A wrapper given a tensor that is neither on the CPU nor on a card
    raises; it never falls back to the plain version."""
    from abismal_tpu_torch.kernels import banded_align, popcount_compare

    m = torch.zeros((128, LMAX), dtype=torch.uint8, device="meta")
    w = torch.zeros((128, LMAX + 60), dtype=torch.uint8, device="meta")
    v = torch.ones(128, dtype=torch.int32, device="meta")
    calls = {
        "popcount_compare": lambda: popcount_compare.popcount_compare(
            v, v.long(), torch.zeros((4, 16), dtype=torch.int32,
                                     device="meta"), v.long(), v),
        "banded_score": lambda: banded_align.banded_score(m, w, v, v),
        "banded_trace": lambda: banded_align.banded_trace(
            m, w, v, v, v.long(), v.bool()),
        "banded_trace_packed": lambda: banded_align.banded_trace_packed(
            v, m, v.long(), v.long(), v.long(), v.long(), v.bool(), LMAX),
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
    from abismal_tpu_torch.kernels import banded_align as ba

    rng, genome = _genome(9, iupac=50)
    jobs = _random_jobs(rng, genome, 1000, bws=(1, 3, 5, 21, 41, 61))
    arrs = _job_arrays(genome, jobs, 1024)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs[:4]]
    got = ba.banded_score(*t)
    torch.cuda.synchronize()
    assert torch.equal(got, ba.banded_score_plain(*t))


@pytest.mark.cuda
def test_banded_score_kernel_pe_shape_matches_plain(cuda_device):
    """K2 at build_stage12pe's shape (J = 8 x 2048 units), with negative
    bands and fill rows."""
    from abismal_tpu_torch.kernels import banded_align as ba

    t = [torch.from_numpy(a).to(cuda_device)
         for a in _pe_score_arrays(12, 16384)]
    got = ba.banded_score(*t)
    torch.cuda.synchronize()
    assert torch.equal(got, ba.banded_score_plain(*t))
    assert bool((got[t[2] < 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["narrow", "mid", "bw61", "negative-fill",
                                  "ragged", "byte-rows"])
def test_banded_score_kernel_cases(cuda_device, case):
    """K2 where its lane groups change: the narrow bands of -m 0.1 (8 lanes,
    2 or 3 columns each), bands of 25-32 (4 columns), bw = 61 alone (the
    whole warp), negative bands and fill rows, J not a multiple of the
    jobs per warp or block, and rows that are not whole words."""
    from abismal_tpu_torch.kernels import banded_align as ba

    rng, genome = _genome(14, iupac=50)
    bws = {"narrow": (1, 3, 5, 9, 13, 21), "mid": (17, 24, 25, 29, 32, 33),
           "bw61": (61,)}.get(case, (1, 3, 5, 21, 41, 61))
    if case == "negative-fill":
        arrs = _pe_score_arrays(13, 1024)
    else:
        J = 1003 if case == "ragged" else 1024
        jobs = _random_jobs(rng, genome, J - 24, bws=bws)
        q, win, bw, qsz, _, _ = _job_arrays(genome, jobs, J)
        arrs = (q, win, bw[:, None], qsz[:, None])
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    if case == "byte-rows":  # lq = 126, lw = 187: neither a multiple of 4
        t[0] = t[0][:, : LMAX - 2].contiguous()
        t[1] = t[1][:, : LMAX + 59].contiguous()
    n0 = ba.banded_score.launches
    got = ba.banded_score(*t)
    torch.cuda.synchronize()
    assert ba.banded_score.launches == n0 + 1
    assert torch.equal(got, ba.banded_score_plain(*t))


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


@pytest.fixture
def other_card():
    """The last card, when it is not cuda:0."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card(other_card):
    """K1, K2 and K3 (both entry points) on the last card while cuda:0 is
    current: each wrapper makes its tensors' device current around the
    launch, and each result equals its plain version."""
    from abismal_tpu_torch.kernels import banded_align as ba
    from abismal_tpu_torch.kernels import popcount_compare as pc

    rng, genome = _genome(11, iupac=50)
    q, win, bw, qsz, pos, do_tb = _job_arrays(
        genome, _random_jobs(rng, genome, 500), 512)
    k1 = _k1_torch(*_k1_arrays(4, G=1 << 14, B=256), device=other_card)
    k2 = [torch.from_numpy(a).to(other_card) for a in (q, win, bw[:, None],
                                                        qsz[:, None])]
    k3 = [torch.from_numpy(a).to(other_card)
          for a in (q, win, bw, qsz, pos.astype(np.int64), do_tb)]
    k3p = [torch.from_numpy(a).to(other_card)
           for a in _packed_arrays(12, R=256, n_gw=20000)]
    with torch.cuda.device(0):
        got = (pc.popcount_compare(*k1), ba.banded_score(*k2),
               *ba.banded_trace(*k3), *ba.banded_trace_packed(*k3p, LMAX))
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(other_card)
    want = (pc.popcount_compare_plain(*k1), ba.banded_score_plain(*k2),
            *ba.banded_trace_plain(*k3),
            *ba.banded_trace_packed_plain(*k3p, LMAX))
    for g, w in zip(got, want):
        assert g.device == other_card and torch.equal(g, w)
