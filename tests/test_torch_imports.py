"""The port stands apart from JAX: no module of abismal_tpu_torch (nor
chip_smoke.py) imports jax, importing every module of the port loads no
jax, chip_smoke.py imports only the port, a whole `map` run through the
port's CLI (also over a mesh and as a hybrid split) never loads jax, and
chip_smoke.py refuses to run without a card."""

import ast
import os
import subprocess
import sys

import pytest

from tests.conftest import golden_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "abismal_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    mods = list(_imported_modules(path))
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]


def test_port_modules_import_without_jax():
    """Every module of the port, the scale-out ones included, imports in a
    fresh interpreter without loading jax."""
    mods = []
    for path in _port_files():
        parts = os.path.relpath(path, ROOT)[:-3].split(os.sep)
        if parts[0] == "abismal_tpu_torch" and parts[-1] != "__main__":
            mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                                 else parts))
    assert "abismal_tpu_torch.parallel.multihost" in mods
    code = ("import importlib, sys\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    res = subprocess.run([sys.executable, "-c", code, *mods],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the host side through abismal_tpu_torch.host,
    never through the JAX package itself."""
    mods = list(_imported_modules(os.path.join(ROOT, "chip_smoke.py")))
    assert any(m.startswith("abismal_tpu_torch") for m in mods)
    assert not [m for m in mods
                if m == "abismal_tpu" or m.startswith("abismal_tpu.")]


@pytest.fixture(scope="module")
def index_copy(tmp_path_factory, trex1_index):
    """A private copy of the tRex1 index file (test workers share the
    cache), written once for the module."""
    from abismal_tpu.index.serialize import write_index

    idx = str(tmp_path_factory.mktemp("idx") / "tRex1.idx")
    write_index(trex1_index, idx)
    return idx


def _sam_body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


@pytest.mark.parametrize("paired,extra", [
    (False, []), (True, []),
    (False, ["--engine", "hybrid", "--device-share", "0.4"]),
    (True, ["--mesh", "2"]),
], ids=["se", "pe", "se-hybrid", "pe-mesh"])
def test_cli_map_never_loads_jax(tmp_path, trex1_index, index_copy, paired,
                                 extra):
    """`python -m abismal_tpu_torch map --device cpu`: jax is not in
    sys.modules at exit, and the SAM body is the golden's (small_1.fq) or,
    for pairs with -l 40 -L 500, the native engine's on the same
    concordance window (small_pe); so too with --engine hybrid (its host
    shard in a process of its own, as -i is given) and over a 2-slot CPU
    mesh."""
    import gzip

    sam = tmp_path / "o.sam"
    if paired:
        args = ["-l", "40", "-L", "500", golden_path("small_pe_1.fq"),
                golden_path("small_pe_2.fq")]
    else:
        args = [golden_path("small_1.fq")]
    args = extra + args
    code = (
        "import runpy, sys\n"
        "sys.argv = ['abismal_tpu_torch', 'map', '-o', sys.argv[1], '-i',"
        " sys.argv[2], '--device', 'cpu'] + sys.argv[3:]\n"
        "try:\n"
        "    runpy.run_module('abismal_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NO_JAX')\n")
    # one torch thread: test workers share the CPU
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", code, str(sam), index_copy, *args],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NO_JAX" in res.stdout
    if paired:
        from abismal_tpu.map.engine import run_map
        from abismal_tpu.map.pipeline import make_native_engine_factory

        nat = tmp_path / "native.sam"
        run_map(trex1_index, args[-2], args[-1], str(nat), None, "native",
                pe_min_dist=40, pe_max_dist=500,
                engine_factory=make_native_engine_factory(n_threads=2))
        want = _sam_body(nat.read_text())
    else:
        with gzip.open(os.path.join(ROOT, "tests", "golden", "small.sam.gz"),
                       "rt") as f:
            want = _sam_body(f.read())
    assert _sam_body(sam.read_text()) == want


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    """Without CUDA (and, alone, outside a checkout) chip_smoke.py exits
    non-zero and prints no result line."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
