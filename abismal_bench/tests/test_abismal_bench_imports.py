"""Module names are compared whole, by the part before the first dot:
the port's name, abismal_tpu_torch, begins with the JAX package's."""

from __future__ import annotations

import subprocess
import sys

from abismal_bench.run import banned_modules
from abismal_bench.tests.conftest import ROOT

HARNESS = ["abismal_bench.run", "abismal_bench.control",
           "abismal_bench.harness.spec", "abismal_bench.harness.inputs",
           "abismal_bench.harness.system", "abismal_bench.harness.trace",
           "abismal_bench.roofline.kernels", "abismal_tpu_torch.map.pipeline",
           "abismal_tpu_torch.map.engine"]
REFERENCE = ["abismal_bench.reference.check",
             "abismal_bench.reference.control", "abismal_bench.gen.fasta",
             "abismal_bench.gen.reads", "abismal_bench.gen.genome"]


def _loaded_tops(mods):
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import os, glob\n"
            "from abismal_bench.harness import spec\n"
            "for p in glob.glob(os.path.join(spec.BENCH, 'metrics', "
            "'*.py')):\n"
            "    spec.reader(os.path.basename(p)[:-3])\n"
            "print(' '.join(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    return set(p.stdout.split())


def test_harness_loads_no_jax_and_not_the_jax_package():
    tops = _loaded_tops(HARNESS)
    assert "abismal_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "abismal_tpu"}


def test_reference_loads_nothing_of_the_program():
    code = ("import importlib, sys\n"
            f"for m in {REFERENCE!r}: importlib.import_module(m)\n"
            "print(' '.join(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    tops = set(p.stdout.split())
    assert not tops & {"abismal_tpu_torch", "abismal_tpu", "jax", "torch"}


def test_banned_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "abismal_tpu_torch_x", sys)
    assert "abismal_tpu" not in banned_modules()
    monkeypatch.setitem(sys.modules, "abismal_tpu.map", sys)
    assert "abismal_tpu" in banned_modules()
