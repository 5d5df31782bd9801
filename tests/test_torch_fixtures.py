"""Shared fixtures of the port's tests (no tests of its own): the tRex1
index, built, written and read back with the port's own code, and the
decompressed golden inputs.  Every file lands in this checkout's cache
directory through a temporary file and os.replace under an exclusive
flock, so with several test workers one builds and the others wait, and
nobody reads a half-written file.

Test modules import what they use, release_engines among it wherever
engines are built:
    from tests.test_torch_fixtures import golden_file, port_index  # noqa
"""

import contextlib
import fcntl
import gc
import gzip
import hashlib
import os
import shutil
import tempfile

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
TREX1_FA = os.path.join(HERE, "data", "tRex1.fa")
# one cache per checkout, under the temporary directory of this run
# (TMPDIR): two checkouts tested on one machine share no file
CACHE = os.path.join(
    tempfile.gettempdir(), "abismal_tpu_torch_test_cache_"
    + hashlib.md5(HERE.encode()).hexdigest()[:12])
PORT_IDX = os.path.join(CACHE, "tRex1.idx")


def md5_file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@contextlib.contextmanager
def _locked(path: str):
    """Exclusive inter-process lock for the making of `path`."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def golden_file(name: str) -> str:
    """tests/golden/<name>.gz decompressed into the cache directory (its
    own file names, written atomically); returns the path."""
    out = os.path.join(CACHE, name)
    src = os.path.join(GOLDEN, name + ".gz")
    with _locked(out):
        if (not os.path.exists(out)
                or os.path.getmtime(out) < os.path.getmtime(src)):
            tmp = f"{out}.tmp{os.getpid()}"
            with gzip.open(src, "rb") as f, open(tmp, "wb") as g:
                shutil.copyfileobj(f, g)
            os.replace(tmp, out)
    return out


def port_index_file() -> str:
    """PORT_IDX, built on first use with the port's create_index and
    write_index and checked against the golden md5."""
    from abismal_tpu_torch.index.build import create_index
    from abismal_tpu_torch.index.serialize import write_index

    with open(os.path.join(GOLDEN, "tRex1.idx.md5")) as f:
        want_md5 = f.read().strip()
    with _locked(PORT_IDX):
        if not (os.path.exists(PORT_IDX) and md5_file(PORT_IDX) == want_md5):
            tmp = f"{PORT_IDX}.tmp{os.getpid()}"
            write_index(create_index(TREX1_FA), tmp)
            assert md5_file(tmp) == want_md5, "index not byte-identical"
            os.replace(tmp, PORT_IDX)
    return PORT_IDX


@pytest.fixture(scope="module")
def port_index():
    """The tRex1 AbismalIndex, read back from port_index_file() with the
    port's read_index; one object per test module."""
    from abismal_tpu_torch.index.serialize import read_index

    return read_index(port_index_file())


@pytest.fixture(scope="module")
def ref_index():
    """The same index file read with the JAX package's read_index: what
    the JAX package's native engine, the reference of the port's whole
    path, maps against."""
    from abismal_tpu.index.serialize import read_index

    return read_index(port_index_file())


def _drop_engines():
    import sys

    from abismal_tpu_torch.map import pipeline

    pipeline.release_engines()
    ref = sys.modules.get("abismal_tpu.map.pipeline")
    if ref is not None:
        for memo in (ref._engine_memo, ref._stage1_memo, ref._stage12_memo,
                     ref._stage12pe_memo):
            memo.clear()
    if "jax" in sys.modules:
        sys.modules["jax"].clear_caches()
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def release_engines():
    """Engines are memoized per index and hold over a GB of tables each,
    and compiled JAX programs hold more: a module drops both, its own when
    it is done and those a module run before it on this worker left (the
    JAX package's memoized engines and programs too), so that a test
    worker's memory does not grow with every file it runs."""
    _drop_engines()
    yield
    _drop_engines()
