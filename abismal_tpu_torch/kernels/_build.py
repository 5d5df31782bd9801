"""Builds the port's hand-written CUDA kernels (csrc/*.cu) with nvcc, one
shared library with a plain C interface per source file, all compiled at
once, and loads them with ctypes.

A library lands in build/abismal_tpu_torch/ at the repository root, named
by a hash of its source and the flags, so a source edit rebuilds it and a
stale binary is never loaded.  Every C entry point launches on the stream
it is given and returns cudaGetLastError(); check() raises on a non-zero
code.  Nothing here runs at import time: the CPU tests import every
module of the port on machines without nvcc."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "abismal_tpu_torch")
# -Xptxas -v: registers, shared memory and spills of every kernel go to
# build_log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# source stem -> C entry points: name -> argtypes (all return int, the
# launch's error code)
SIGNATURES = {
    "popcount_compare": {
        # genome32, n_gw, pos, pk, nw_words, b_of, nw_of, d, G, stream
        "popcount_compare_launch": [_P, _L, _P, _P, _I, _P, _P, _P, _L, _P],
    },
    "banded_align": {
        # genome32, n_gw, pnib, W, lq, unit, pos, bw, qsz, out, J, stream
        "banded_score_packed_launch": [_P, _L, _P, _I, _I, _P, _P, _P, _P,
                                       _P, _I, _P],
        # q, lq, win, lw, bw, qsz, wpos, do_tb, ops, meta, J, max_step,
        # stream
        "banded_trace_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I,
                                _I, _P],
        # genome32, n_gw, pnib, W, lq, wunit, wbw, wqsz, wpos, do_tb, ops,
        # meta, J, max_step, stream
        "banded_trace_packed_launch": [_P, _L, _P, _I, _I, _P, _P, _P, _P,
                                       _P, _P, _P, _I, _I, _P],
    },
    "seed_extend": {
        # genome32, n_gw, index_all, n_idx, pnib, W, lens, is_ga, base3,
        # s2, e2, s3, e3, flat_act, cum_act, B, o_spec, P, dqmax, qw, kw2,
        # kw3, mc, ways, kary_iters, ext_w, n_sort, cells, ext_fb, stream
        "seed_extend_launch": [_P, _L, _P, _L, _P, _I, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "segment_rank": {
        # gate, ex (or NULL), n, seg_start, seg_end, n_seg, rank, counts,
        # ex_counts (or NULL), stream
        "segment_rank_launch": [_P, _P, _L, _P, _P, _I, _P, _P, _P, _P],
    },
    "candidate_list": {
        # cnt_cells, lo_cells, unit_start, unit_total, index_all, n_idx, B,
        # n_cells, o_spec, gflat, out, valid, stream
        "candidate_list_launch": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _L,
                                  _P, _P, _P],
    },
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc runs, None when loaded cached
build_log = ""  # what nvcc and ptxas printed, by source


def source_path(stem: str) -> str:
    return os.path.join(CSRC, stem + ".cu")


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(stem: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(source_path(stem), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def load():
    """Builds (on first use) and loads the kernel libraries; returns a
    namespace with every C entry point of SIGNATURES."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        paths = {stem: library_path(stem) for stem in SIGNATURES}
        jobs = []
        t0 = time.perf_counter()
        for stem, so in paths.items():
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.tmp{os.getpid()}"
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(stem)]
                jobs.append((stem, so, tmp, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        failed = []
        for stem, so, tmp, cmd, proc in jobs:
            text, _ = proc.communicate()
            build_log += f"--- {stem}\n{text}"
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{text}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
        if jobs:
            build_seconds = time.perf_counter() - t0
        lib = types.SimpleNamespace()
        for stem, fns in SIGNATURES.items():
            cdll = ctypes.CDLL(paths[stem])
            for name, argtypes in fns.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                setattr(lib, name, fn)
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(t) -> int:
    """The current CUDA stream of tensor t's device, as a pointer int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def aligned(t, nbytes: int):
    """t itself when its data starts on an nbytes boundary, else a copy (a
    fresh allocation does): the kernels read rows as 4- or 16-byte words."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def require_device(name: str, *tensors) -> None:
    """Kernels take CUDA tensors only, all on one device and contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
