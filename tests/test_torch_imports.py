"""The port stands apart from JAX: no module of abismal_tpu_torch (nor
chip_smoke.py) imports jax, chip_smoke.py imports only the port, a whole
`map` run through the port's CLI never loads jax, and chip_smoke.py
refuses to run without a card."""

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


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the host side through abismal_tpu_torch.host,
    never through the JAX package itself."""
    mods = list(_imported_modules(os.path.join(ROOT, "chip_smoke.py")))
    assert any(m.startswith("abismal_tpu_torch") for m in mods)
    assert not [m for m in mods
                if m == "abismal_tpu" or m.startswith("abismal_tpu.")]


def test_cli_map_never_loads_jax(tmp_path, trex1_index):
    """`python -m abismal_tpu_torch map --device cpu` on small_1.fq: jax is
    not in sys.modules at exit, and the SAM body is the golden's."""
    import gzip

    from abismal_tpu.index.serialize import write_index

    idx = str(tmp_path / "tRex1.idx")  # a private copy: workers share CACHE
    write_index(trex1_index, idx)
    sam = tmp_path / "o.sam"
    code = (
        "import runpy, sys\n"
        "sys.argv = ['abismal_tpu_torch', 'map', '-o', sys.argv[1], '-i',"
        " sys.argv[2], '--device', 'cpu', sys.argv[3]]\n"
        "try:\n"
        "    runpy.run_module('abismal_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NO_JAX')\n")
    # one torch thread: test workers share the CPU
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", code, str(sam), idx,
         golden_path("small_1.fq")], capture_output=True, text=True,
        env=env, cwd=str(tmp_path), timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NO_JAX" in res.stdout
    with gzip.open(os.path.join(ROOT, "tests", "golden", "small.sam.gz"),
                   "rt") as f:
        want = [ln for ln in f.read().splitlines() if not ln.startswith("@PG")]
    got = [ln for ln in sam.read_text().splitlines()
           if not ln.startswith("@PG")]
    assert got == want


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
