"""The port's CUDA sources (abismal_tpu_torch/csrc/*.cu) run on the CPU: the
same files nvcc builds for the card are compiled with g++ against
tests/warp_emulation/cuda_runtime.h, which runs the lanes of a warp in
lockstep, and each kernel is held against its plain PyTorch version,
exactly.  This checks a kernel's indices and logic (and that its lanes
agree on every shuffle) where no card is; its speed, and what only nvcc
or the hardware refuses, show on the card alone (the -m cuda tests of
tests/test_torch_kernels.py, chip_smoke.py).  It is an aid, not a gate:
the rewrite knows one launch form and one dynamic shared array a source,
and the header a list of intrinsics; a source that uses anything else is
skipped here, with the reason, and is held to its plain version on the
card only."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    port_index, release_engines,
)
from tests.test_torch_kernels import (
    EXT_CASES, K3_CASES, LIST_CASES, LMAX, SCAN_CASES, _k1_arrays, _k2_case,
    _k3_case, _packed_arrays, _packed_score_arrays, ext_case,
    ext_case_covers, list_case, program_scan_args, repeat_genome, scan_case,
    scan_torch,
)

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH = re.compile(r"(\w+)<<<(.*?),\s*(.*?),.*?>>>\((.*?)\);", re.S)
SHARED = re.compile(r"extern __shared__ (\w+) (\w+)\[\];")
# what the rewrite leaves behind where it does not know a construct
UNKNOWN = re.compile(r"<<<|__shared__|__syncthreads|cooperative_groups")


def host_source(cuda_source: str) -> str:
    """The .cu text as C++ for the emulation header: launches become
    emu::launch calls, dynamic shared memory the emulation's buffer."""
    text = LAUNCH.sub(r"emu::launch(\2, \3, [&] { \1(\4); });", cuda_source)
    return SHARED.sub(
        r"\1* const \2 = reinterpret_cast<\1*>(emu::shared);", text)


def _code(text: str) -> str:
    """text without its comments."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Namespace of the C entry points of every csrc/*.cu, emulated."""
    from abismal_tpu_torch.kernels import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("emulated")
    lib = {}
    for stem, fns in _build.SIGNATURES.items():
        with open(_build.source_path(stem)) as f:
            text = host_source(f.read())
        left = UNKNOWN.search(_code(text))
        if left:
            pytest.skip(f"the emulation does not know how {stem}.cu uses "
                        f"{left.group()!r}: this source is checked on the "
                        "card only")
        cpp = out / f"{stem}.cpp"
        cpp.write_text(text)
        so = out / f"lib{stem}.so"
        res = subprocess.run(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
             "-I", os.path.join(HERE, "warp_emulation"), str(cpp), "-o",
             str(so)], capture_output=True, text=True)
        if res.returncode != 0:
            pytest.skip(f"{stem}.cu does not compile against the emulation "
                        "header (a construct it lacks?): "
                        + res.stderr.strip()[-400:])
        cdll = ctypes.CDLL(str(so))
        for name, argtypes in fns.items():
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            lib[name] = fn
    return lib


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def _trace(lib, q, win, bw, qsz, pos, do_tb, max_step):
    from abismal_tpu_torch.kernels import banded_align as ba

    J, lq = q.shape
    a = [_c(q, np.uint8), _c(win, np.uint8), _c(bw, np.int32),
         _c(qsz, np.int32), _c(pos, np.int64), _c(do_tb, np.uint8)]
    ops = np.full((J, ba.TB_NOPS), -7, np.int32)
    meta = np.full((J, 4), -7, np.int32)
    rc = lib["banded_trace_launch"](
        a[0].ctypes.data, lq, a[1].ctypes.data, a[1].shape[1],
        *(x.ctypes.data for x in a[2:]), ops.ctypes.data, meta.ctypes.data,
        J, max_step, None)
    assert rc == 0
    return ops, meta


@pytest.mark.parametrize("case", K3_CASES)
def test_emulated_banded_trace_cases(emulated, case):
    """K3's CUDA source on the K3 case list, 64 jobs of each."""
    from abismal_tpu_torch.kernels import banded_align as ba

    arrs, _, max_step = _k3_case(case)
    J = 63 if case == "ragged" else 64
    arrs = [a[:J] for a in arrs]
    ops, meta = _trace(emulated, *arrs, max_step)
    want = ba._trace_plain(*(torch.from_numpy(a) for a in arrs), max_step)
    np.testing.assert_array_equal(ops, want[0].numpy())
    np.testing.assert_array_equal(meta, want[1].numpy())


@pytest.mark.parametrize("lmax,R", [(LMAX, 70), (125, 33)])
def test_emulated_banded_trace_packed(emulated, lmax, R):
    """K3's packed entry point: IUPAC codes, windows before nibble 0 and
    past the genome's end, untraced lanes, an odd row length and an odd
    job count."""
    from abismal_tpu_torch.kernels import banded_align as ba

    arrs = _packed_arrays(41, R=R, n_gw=3000)
    genome32, pnib, wunit, wbw, wqsz, wpos, do_tb = arrs
    lq = min(lmax, 2 * pnib.shape[1])
    a = [_c(genome32, np.int32), _c(pnib, np.uint8), _c(wunit, np.int64),
         _c(wbw, np.int64), _c(wqsz, np.int64), _c(wpos, np.int64),
         _c(do_tb, np.uint8)]
    ops = np.full((R, ba.TB_NOPS), -7, np.int32)
    meta = np.full((R, 4), -7, np.int32)
    rc = emulated["banded_trace_packed_launch"](
        a[0].ctypes.data, a[0].shape[0], a[1].ctypes.data, a[1].shape[1],
        lq, *(x.ctypes.data for x in a[2:]), ops.ctypes.data,
        meta.ctypes.data, R, ba.walk_step_cap(lq), None)
    assert rc == 0
    want = ba.banded_trace_packed_plain(
        *(torch.from_numpy(x) for x in arrs), lmax)
    np.testing.assert_array_equal(ops, want[0].numpy())
    np.testing.assert_array_equal(meta, want[1].numpy())
    assert int((meta[:, 0] > 0).sum()) > R // 2


def _score_packed(lib, arrs, lmax):
    """K2 (banded_score_packed_launch) on the operands arrs, emulated;
    returns its scores and the plain version's."""
    from abismal_tpu_torch.kernels import banded_align as ba

    genome32, pnib, unit, pos, bw, qsz = arrs
    J = unit.shape[0]
    a = [_c(genome32, np.int32), _c(pnib, np.uint8)] + [
        _c(x, np.int64) for x in (unit, pos, bw, qsz)]
    out = np.full(J, -7, np.int32)
    rc = lib["banded_score_packed_launch"](
        a[0].ctypes.data, a[0].shape[0], a[1].ctypes.data, a[1].shape[1],
        min(lmax, 2 * pnib.shape[1]), *(x.ctypes.data for x in a[2:]),
        out.ctypes.data, J, None)
    assert rc == 0
    want = ba.banded_score_packed_plain(
        *(torch.from_numpy(x) for x in arrs), lmax)
    return out, want.numpy()


@pytest.mark.parametrize("case", ["mixed", "narrow", "negative-fill",
                                  "ragged", "byte-rows"])
def test_emulated_banded_score_cases(emulated, case):
    """K2's CUDA source where its lane groups change (the cases of
    test_banded_score_kernel_cases, 128 jobs of each)."""
    out, want = _score_packed(emulated, *_k2_case(case, 128))
    np.testing.assert_array_equal(out, want)
    assert int((out > 0).sum()) > out.shape[0] // 2


@pytest.mark.parametrize("lmax,J", [(LMAX, 70), (125, 33)])
def test_emulated_banded_score_packed(emulated, lmax, J):
    """K2's packed entry point: IUPAC codes, windows before nibble 0 and
    past the genome's end, negative bands, fill rows, an odd row length
    and a job count that is not a multiple of a warp's four."""
    out, want = _score_packed(emulated, _packed_score_arrays(42, J, 3000),
                              lmax)
    np.testing.assert_array_equal(out, want)
    assert int((out > 0).sum()) > J // 2


@pytest.mark.parametrize("kw", [
    dict(), dict(n_gw=4093), dict(nw_words=18), dict(nw_words=32),
], ids=["16-words", "ragged-genome", "18-words", "32-words"])
def test_emulated_popcount_compare(emulated, kw):
    """K1's CUDA source: positions on and off word bounds, past the end of
    the genome and wrapped modulo 2^32, read units of 16, 18 and 32 words,
    a genome that does not end on a quad of words."""
    from abismal_tpu_torch.kernels import popcount_compare as pc

    genome32, pos, pk, b_of, nw_of = _k1_arrays(21, G=1027, B=32, **kw)
    b_of = np.sort(b_of)
    pk_c = _c(pk, np.uint32)
    # 128-bit loads: the genome and the read rows start on 16 bytes
    assert genome32.ctypes.data % 16 == 0 and pk_c.ctypes.data % 16 == 0
    d = np.full(pos.shape[0], -7, np.int32)
    rc = emulated["popcount_compare_launch"](
        genome32.ctypes.data, genome32.shape[0], pos.ctypes.data,
        pk_c.ctypes.data, pk.shape[1], b_of.ctypes.data,
        _c(nw_of, np.int32).ctypes.data, d.ctypes.data, pos.shape[0], None)
    assert rc == 0
    want = pc.popcount_compare_plain(
        torch.from_numpy(genome32.view(np.int32)), torch.from_numpy(pos),
        torch.from_numpy(pk.view(np.int32)), torch.from_numpy(b_of),
        torch.from_numpy(nw_of))
    np.testing.assert_array_equal(d, want.numpy())


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    return repeat_genome(tmp_path_factory.mktemp("repeat"))


def _seed_extend(lib, args):
    """K4 (seed_extend_launch) on the arguments the core hands the
    wrapper, emulated: its cells (6, B, o_spec) int64 and ext_fb (B,)."""
    from abismal_tpu_torch.constants import KEY_WEIGHT, KEY_WEIGHT_THREE
    from abismal_tpu_torch.kernels.seed_extend import class_words

    (genome32, index_all, pnib, lens, is_ga, base3, s2, e2, s3, e3, flat_act,
     cum_act) = (np.ascontiguousarray(t.numpy()) for t in args[:12])
    pool, lmax, mc, ways, kary_iters, ext_w, n_sort = args[12:]
    B, o_spec = s2.shape
    cells = np.full((6, B, o_spec), -7, np.int64)
    ext_fb = np.full(B, 7, np.uint8)
    rc = lib["seed_extend_launch"](
        genome32.ctypes.data, genome32.shape[0], index_all.ctypes.data,
        index_all.shape[0], pnib.ctypes.data, pnib.shape[1],
        lens.ctypes.data, is_ga.view(np.uint8).ctypes.data,
        base3.ctypes.data, s2.ctypes.data, e2.ctypes.data, s3.ctypes.data,
        e3.ctypes.data, flat_act.view(np.uint8).ctypes.data,
        cum_act.ctypes.data, B, o_spec, pool, *class_words(lmax),
        KEY_WEIGHT, KEY_WEIGHT_THREE, mc, ways, kary_iters, ext_w, n_sort,
        cells.ctypes.data, ext_fb.ctypes.data, None)
    assert rc == 0
    assert set(np.unique(ext_fb)) <= {0, 1}
    return [*cells, ext_fb.view(bool)]


@pytest.mark.parametrize("case", EXT_CASES)
def test_emulated_seed_extend(emulated, port_index, repeat, case):
    """K4's CUDA source on pools of real lanes: tRex1 units, a pool of
    mostly empty slots, the repeat genome's oversized buckets (many trips,
    windows of equal LCPs) at ways 2, 4 and 8, lmax 256, deep lanes, lanes
    of depth 0, buckets that are not sorted in the compare (with the
    search cut short) and a pool of 512 live lanes; every cell and ext_fb
    equal the plain version's."""
    from abismal_tpu_torch.kernels.seed_extend import seed_extend_plain

    args = ext_case(case, port_index, repeat, pool=128)
    out = _seed_extend(emulated, args)
    want = seed_extend_plain(*args)
    _equal_plain(out, want)
    ext_case_covers(case, args, want)


def _numpy(args):
    """A K5 or K6 case's tensors as contiguous numpy arrays."""
    return [np.ascontiguousarray(a.numpy()) if torch.is_tensor(a) else a
            for a in args]


def _segment_rank(lib, gate, seg_start, seg_end, ex):
    """K5 (segment_rank_launch) on numpy operands, emulated: (rank,
    counts), and ex_counts with ex."""
    n, n_seg = gate.shape[0], seg_start.shape[0]
    g, s0, s1 = (_c(gate, np.uint8), _c(seg_start, np.int64),
                 _c(seg_end, np.int64))
    x = None if ex is None else _c(ex, np.uint8)
    outs = [np.full(n, -7, np.int64), np.full(n_seg, -7, np.int64)]
    if ex is not None:
        outs.append(np.full(n_seg, -7, np.int64))
    rc = lib["segment_rank_launch"](
        g.ctypes.data, None if x is None else x.ctypes.data, n,
        s0.ctypes.data, s1.ctypes.data, n_seg, outs[0].ctypes.data,
        outs[1].ctypes.data, None if x is None else outs[2].ctypes.data,
        None)
    assert rc == 0
    return outs


def _candidate_list(lib, cnt, lo, unit_start, unit_total, idx, o_spec,
                    gflat):
    """K6 (candidate_list_launch) on numpy operands, emulated: (b_of,
    cell_of, slot, valid, pos)."""
    B, n_cells = cnt.shape
    a = [_c(x, np.int64) for x in (cnt, lo, unit_start, unit_total, idx)]
    out = np.full((4, gflat), -7, np.int64)
    valid = np.full(gflat, 7, np.uint8)
    rc = lib["candidate_list_launch"](
        *(x.ctypes.data for x in a), idx.shape[0], B, n_cells, o_spec, gflat,
        out.ctypes.data, valid.ctypes.data, None)
    assert rc == 0
    assert set(np.unique(valid)) <= {0, 1}
    return out[0], out[1], out[2], valid.view(bool), out[3]


def _equal_plain(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("case", SCAN_CASES)
def test_emulated_segment_rank(emulated, case):
    """K5's CUDA source on its case list (empty segments, all and none
    gated, a tail over several tail warps, spans clamped at n, a span of
    2,500 entries, the PE form without a second mask): every rank and
    count equals the plain version's."""
    from abismal_tpu_torch.kernels.segment_rank import segment_rank_plain

    args = scan_case(case)
    _equal_plain(_segment_rank(emulated, *args),
                 segment_rank_plain(*scan_torch(args)))


@pytest.mark.parametrize("case", LIST_CASES)
def test_emulated_candidate_list(emulated, case):
    """K6's CUDA source on its case list (a tail over two tail warps,
    total > gflat with a unit across it, a unit at CELLCAP in 60 cells,
    lmax 256, empty units, no candidate at all): every entry of the list
    equals the plain version's."""
    from abismal_tpu_torch.kernels.candidate_list import (
        candidate_list_plain,
    )

    args = list_case(case)
    _equal_plain(_candidate_list(emulated, *args),
                 candidate_list_plain(*scan_torch(args)))


def test_emulated_scan_kernels_on_program_inputs(emulated, port_index):
    """K5 and K6's CUDA sources on what the engine's SE and PE programs
    hand them on a chunk of golden reads and pairs: equal to their plain
    versions."""
    from abismal_tpu_torch.kernels.candidate_list import (
        candidate_list_plain,
    )
    from abismal_tpu_torch.kernels.segment_rank import segment_rank_plain

    for kind, (a5, a6) in program_scan_args(port_index).items():
        args = list(a5) + [None] * (4 - len(a5))
        _equal_plain(_segment_rank(emulated, *_numpy(args)),
                     segment_rank_plain(*a5))
        _equal_plain(_candidate_list(emulated, *_numpy(a6)),
                     candidate_list_plain(*a6))
