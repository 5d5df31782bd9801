"""Builds the port's hand-written CUDA kernels (csrc/*.cu) with nvcc into
one shared library with a plain C interface, and loads it with ctypes.

The library lands in build/abismal_tpu_torch/ at the repository root,
named by a hash of the sources and flags, so a source edit rebuilds it and
a stale binary is never loaded.  Every C entry point launches on the
stream it is given and returns cudaGetLastError(); check() raises on a
non-zero code.  Nothing here runs at import time: the CPU tests import
every module of the port on machines without nvcc."""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "abismal_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points: name -> argtypes (all return int, the launch's error code)
SIGNATURES = {
    # genome32, n_gw, pos, pk, nw_words, b_of, nw_of, d, G, stream
    "popcount_compare_launch": [_P, _L, _P, _P, _I, _P, _P, _P, _L, _P],
    # q, lq, win, lw, bw, qsz, out, J, stream
    "banded_score_launch": [_P, _I, _P, _I, _P, _P, _P, _I, _P],
    # q, lq, win, lw, bw, qsz, wpos, do_tb, ops, meta, J, panel_rows,
    # max_step, warps_per_block, stream
    "banded_trace_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run, None when loaded cached


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libabismal_kernels-{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """Builds (on first use) and loads the kernel library."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *sources()]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}\n{res.stderr}")
            build_seconds = time.perf_counter() - t0
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_of(t) -> int:
    """The current CUDA stream of tensor t's device, as a pointer int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


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
