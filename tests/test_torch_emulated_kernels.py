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

from tests.test_torch_kernels import (
    K3_CASES, LMAX, _genome, _job_arrays, _k1_arrays, _k3_case,
    _packed_arrays, _pe_score_arrays, _random_jobs,
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


@pytest.mark.parametrize("case", ["mixed", "narrow", "negative-fill",
                                  "ragged", "byte-rows"])
def test_emulated_banded_score_cases(emulated, case):
    """K2's CUDA source where its lane groups change (the cases of
    test_banded_score_kernel_cases, 128 jobs of each)."""
    from abismal_tpu_torch.kernels import banded_align as ba

    if case == "negative-fill":
        q, win, bw, qsz = _pe_score_arrays(13, 128)
    else:
        rng, genome = _genome(14, iupac=50)
        J = 123 if case == "ragged" else 128
        bws = (1, 3, 5, 9, 13, 21) if case == "narrow" else (
            1, 3, 5, 21, 24, 32, 33, 41, 61)
        q, win, bw, qsz, _, _ = _job_arrays(
            genome, _random_jobs(rng, genome, J - 8, bws=bws), J)
    if case == "byte-rows":  # lq = 126, lw = 187: neither a multiple of 4
        q, win = q[:, : LMAX - 2], win[:, : LMAX + 59]
    J = q.shape[0]
    a = [_c(q, np.uint8), _c(win, np.uint8), _c(bw.reshape(J), np.int32),
         _c(qsz.reshape(J), np.int32)]
    out = np.full(J, -7, np.int32)
    rc = emulated["banded_score_launch"](
        a[0].ctypes.data, a[0].shape[1], a[1].ctypes.data, a[1].shape[1],
        a[2].ctypes.data, a[3].ctypes.data, out.ctypes.data, J, None)
    assert rc == 0
    want = ba.banded_score_plain(*(torch.from_numpy(x) for x in (
        a[0], a[1], a[2][:, None], a[3][:, None])))
    np.testing.assert_array_equal(out, want.numpy()[:, 0])


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
