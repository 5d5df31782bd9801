"""The port stands alone: no module of abismal_tpu_torch (nor
chip_smoke.py, nor the three timing scripts beside it) imports jax or
anything of the JAX package abismal_tpu, importing every module of the port loads neither, chip_smoke.py imports
only the port, the tools (the bench and the scaling tool among them) run
without it, whole `map`, `idx` and `sim` runs through the port's CLI
(map also over a mesh, over index shards, as a hybrid split and with
every --engine) work while `import abismal_tpu` is made to fail, the
device entry points do not fall back to the CPU without a card, and
chip_smoke.py refuses to run without a card."""

import ast
import os
import subprocess
import sys

import pytest

from tests.test_torch_fixtures import (  # noqa: F401
    PORT_IDX, TREX1_FA, golden_file, md5_file, port_index, ref_index,
    release_engines,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "abismal_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, f) for f in (
        "chip_smoke.py", "kernel_times.py", "path_rates.py",
        "k4_phases.py")]
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
    """No import of jax, nor of abismal_tpu, at any depth of the file."""
    mods = list(_imported_modules(path))
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    assert not [m for m in mods
                if m == "abismal_tpu" or m.startswith("abismal_tpu.")]


def test_port_modules_import_without_jax():
    """Every module of the port, the scale-out ones included, imports in a
    fresh interpreter without loading jax."""
    mods = []
    for path in _port_files():
        parts = os.path.relpath(path, ROOT)[:-3].split(os.sep)
        if parts[0] == "abismal_tpu_torch" and parts[-1] != "__main__":
            mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                                 else parts))
    for m in ("parallel.multihost", "map.align", "map.candidates",
              "map.seeds", "map.engine", "map.runner"):
        assert "abismal_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            "sys.modules['abismal_tpu'] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    res = subprocess.run([sys.executable, "-c", code, *mods],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the host side through the port's own
    modules, never through the JAX package."""
    mods = list(_imported_modules(os.path.join(ROOT, "chip_smoke.py")))
    assert any(m.startswith("abismal_tpu_torch") for m in mods)
    assert not [m for m in mods
                if m == "abismal_tpu" or m.startswith("abismal_tpu.")]


TOOLS = sorted(f[:-3] for f in os.listdir(os.path.join(PORT, "tools"))
               if f.endswith(".py") and f != "__init__.py")
# names a tool may not import: on the card machine an installed package
# named `tests` shadows the repository's, and the JAX tools (tools/) and
# __graft_entry__ import the JAX package
NOT_FOR_TOOLS = ("jax", "abismal_tpu", "__graft_entry__", "tests", "tools")


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_only_the_port(name):
    """No import of jax, the JAX package, __graft_entry__, tests or the
    JAX tools' directory at any depth of a tool's file."""
    path = os.path.join(PORT, "tools", name + ".py")
    mods = list(_imported_modules(path))
    assert not [m for m in mods if m.split(".")[0] in NOT_FOR_TOOLS], mods


def test_tools_run_alone(tmp_path):
    """Every tool module imports, and debug_ext runs, in a fresh
    interpreter where the JAX package, __graft_entry__, tests and tools
    cannot be imported, and none of the forbidden names ends up in
    sys.modules."""
    code = ("import importlib, sys\n"
            "for m in ('abismal_tpu', '__graft_entry__', 'tests', 'tools'):\n"
            "    sys.modules[m] = None\n"
            "mods = [importlib.import_module('abismal_tpu_torch.tools.' + t)\n"
            "        for t in sys.argv[1:]]\n"
            "from abismal_tpu_torch.tools import _workload, debug_ext\n"
            f"_workload.CACHE = {str(tmp_path)!r}\n"
            "debug_ext.main(['--device', 'cpu', '--threads', '1'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            f"       {NOT_FOR_TOOLS!r} and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ALONE_OK')\n")
    res = subprocess.run([sys.executable, "-c", code, *TOOLS],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=ROOT,
                                  OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert "ALONE_OK" in res.stdout and "nbad: 0" in res.stdout


def test_bench_and_scaling_run_alone(tmp_path, port_index):
    """The bench's native mode and the weak-scaling tool's native shards
    (spawned processes) run in a fresh interpreter where the JAX package,
    __graft_entry__, tests and tools cannot be imported, and none of the
    forbidden names ends up in sys.modules."""
    cache = tmp_path / "cache"
    cache.mkdir()
    os.symlink(PORT_IDX, cache / "tRex1.idx")
    code = ("import sys\n"
            "for m in ('abismal_tpu', '__graft_entry__', 'tests', 'tools'):\n"
            "    sys.modules[m] = None\n"
            "from abismal_tpu_torch.tools import (\n"
            "    _workload, bench, multihost_scale)\n"
            f"_workload.CACHE = {str(cache)!r}\n"
            "r = bench.run_mode('native', 'cpu', 200, 1, 1)\n"
            "assert r['best'] > 0, r\n"
            "multihost_scale.main(['--per-host', '100', '--hosts', '2',\n"
            "                      '--reps', '1', '--threads', '1',\n"
            "                      '--engine', 'native'])\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            f"       {NOT_FOR_TOOLS!r} and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ALONE_OK')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=ROOT,
                                  OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    assert "ALONE_OK" in res.stdout
    assert "weak-scaling efficiency at 2 host(s)" in res.stdout


# runs `python -m abismal_tpu_torch <argv>` with `import abismal_tpu` made
# to fail (a None entry in sys.modules raises ImportError)
ALONE = (
    "import runpy, sys\n"
    "sys.modules['abismal_tpu'] = None\n"
    "sys.argv = ['abismal_tpu_torch'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('abismal_tpu_torch', run_name='__main__')\n"
    "except SystemExit as e:\n"
    "    assert not e.code, e.code\n"
    "assert 'jax' not in sys.modules, 'jax was imported'\n"
    "print('NO_JAX')\n")


def _run_alone(argv, cwd, **env_extra):
    # one torch thread: test workers share the CPU
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **env_extra)
    res = subprocess.run([sys.executable, "-c", ALONE, *argv],
                         capture_output=True, text=True, env=env,
                         cwd=str(cwd), timeout=600)
    assert res.returncode == 0, res.stderr
    assert "NO_JAX" in res.stdout


def _golden_text(name):
    import gzip

    with gzip.open(os.path.join(ROOT, "tests", "golden", name + ".gz"),
                   "rt") as f:
        return f.read()


def _sam_body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


@pytest.mark.parametrize("paired,extra", [
    (False, []), (True, []),
    (False, ["--engine", "hybrid", "--device-share", "0.4"]),
    (True, ["--mesh", "2"]),
    (False, ["--index-shards", "2"]),
    (False, ["--engine", "native", "-t", "2"]),
    (True, ["--engine", "exact"]),
    (False, ["--engine", "torch-replay"]),
    (False, ["--engine", "torch-replay", "-t", "3"]),
], ids=["se", "pe", "se-hybrid", "pe-mesh", "se-index-shards", "se-native",
        "pe-exact", "se-torch-replay", "se-torch-replay-t3"])
def test_cli_map_never_loads_jax(tmp_path, port_index, ref_index, paired,
                                 extra):
    """`python -m abismal_tpu_torch map --device cpu` with abismal_tpu
    unimportable: jax is not in sys.modules at exit, and the SAM body is
    the golden's (small_1.fq) or, for pairs with -l 40 -L 500, the JAX
    package's native engine's on the same concordance window (small_pe);
    so too with --engine hybrid (its host shard in a process of its own, as -i is
    given), over a 2-slot CPU mesh, with the index split over 2 CPU slots,
    and with the native, exact and torch-replay engines (the last also
    through its forked workers)."""
    sam = tmp_path / "o.sam"
    if paired:
        args = ["-l", "40", "-L", "500", golden_file("small_pe_1.fq"),
                golden_file("small_pe_2.fq")]
    else:
        args = [golden_file("small_1.fq")]
    _run_alone(["map", "-o", str(sam), "-i", PORT_IDX, "--device", "cpu",
                *extra, *args], tmp_path)
    if paired:
        from abismal_tpu.map.engine import run_map
        from abismal_tpu.map.pipeline import make_native_engine_factory

        nat = tmp_path / "native.sam"
        run_map(ref_index, args[-2], args[-1], str(nat), None, "native",
                pe_min_dist=40, pe_max_dist=500,
                engine_factory=make_native_engine_factory(n_threads=2))
        want = _sam_body(nat.read_text())
    else:
        want = _sam_body(_golden_text("small.sam"))
    assert _sam_body(sam.read_text()) == want


@pytest.mark.parametrize("prefix", ["small", "small_pe"])
def test_cli_map_alone_gives_the_golden(tmp_path, port_index, prefix):
    """The port's CLI alone, at the goldens' own options: the golden SAM
    (but for the @PG line, which records this run's argv) and mstats."""
    sam, mst = tmp_path / "o.sam", tmp_path / "o.mstats"
    fqs = [golden_file(f"{prefix}_1.fq")]
    if prefix.endswith("_pe"):
        fqs.append(golden_file(f"{prefix}_2.fq"))
    _run_alone(["map", "--device", "cpu", "-t", "2", "-s", str(mst), "-o",
                str(sam), "-i", PORT_IDX, *fqs], tmp_path)
    assert _sam_body(sam.read_text()) == _sam_body(
        _golden_text(prefix + ".sam"))
    assert mst.read_text() == _golden_text(prefix + ".mstats")


@pytest.mark.parametrize("prefix,extra", [
    ("small", ["--device-align"]), ("small_pe", []),
], ids=["se-device-align", "pe"])
def test_cli_map_event_route_alone(tmp_path, port_index, prefix, extra):
    """ABISMAL_TPU_STAGE2=0 takes the CLI onto the event-stream route,
    with --device-align too: the golden SAM (but for @PG) and mstats, and
    no jax."""
    sam, mst = tmp_path / "o.sam", tmp_path / "o.mstats"
    fqs = [golden_file(f"{prefix}_1.fq")]
    if prefix.endswith("_pe"):
        fqs.append(golden_file(f"{prefix}_2.fq"))
    _run_alone(["map", "--device", "cpu", "-t", "2", *extra, "-s", str(mst),
                "-o", str(sam), "-i", PORT_IDX, *fqs], tmp_path,
               ABISMAL_TPU_STAGE2="0")
    assert _sam_body(sam.read_text()) == _sam_body(
        _golden_text(prefix + ".sam"))
    assert mst.read_text() == _golden_text(prefix + ".mstats")


def test_cli_idx_alone_gives_the_golden_md5(tmp_path):
    """`python -m abismal_tpu_torch idx` alone writes the golden index."""
    out = tmp_path / "tRex1.idx"
    _run_alone(["idx", TREX1_FA, str(out)], tmp_path)
    with open(os.path.join(ROOT, "tests", "golden", "tRex1.idx.md5")) as f:
        assert md5_file(str(out)) == f.read().strip()


def test_cli_sim_alone_gives_the_golden(tmp_path):
    """`python -m abismal_tpu_torch sim` alone, at the options of the
    reads_pe golden (MANIFEST.md): the golden FASTQs."""
    _run_alone(["sim", "-seed", "1", "-n", "10000", "-m", "0.01", "-b",
                "0.98", "-o", str(tmp_path / "reads_pe"), TREX1_FA], tmp_path)
    for end in ("_1.fq", "_2.fq"):
        assert md5_file(str(tmp_path / ("reads_pe" + end))) == md5_file(
            golden_file("reads_pe" + end))


def test_no_cpu_fallback_without_card(tmp_path, port_index):
    """Without a card the device entry points raise instead of running on
    the CPU: TorchMappingEngine at its default device, the replay factory's
    engine, and `map --index-shards` without --device cpu."""
    import torch

    from abismal_tpu_torch.cli import main
    from abismal_tpu_torch.map.pipeline import (
        TorchMappingEngine, make_torch_engine_factory,
    )

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchMappingEngine(port_index)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_torch_engine_factory()(port_index, False, 0.1, 32, 3000)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["map", "--index-shards", "2", "-o", str(tmp_path / "o.sam"),
              "-i", PORT_IDX, golden_file("small_1.fq")])


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
