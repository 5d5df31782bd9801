"""Static-analysis gate over the port's native C++ (↔
tests/test_static_analysis.py): abismal_tpu_torch/tools/static_analysis.sh
runs GCC's strictest relevant warning set, warnings as errors, over every
source of abismal_tpu_torch/native/ in both build profiles, and fails on
a finding."""

import os
import shutil
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = os.path.join(ROOT, "abismal_tpu_torch", "tools", "static_analysis.sh")


def test_port_native_static_analysis_clean():
    r = subprocess.run(["bash", GATE], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    checked = [ln for ln in r.stdout.splitlines()
               if ln.startswith("checking")]
    srcs = sorted(f for f in os.listdir(os.path.join(
        ROOT, "abismal_tpu_torch", "native")) if f.endswith(".cpp"))
    assert srcs == ["_engine.cpp", "_native.cpp"]
    assert checked == [f"checking {s} {p}" for p in ("(default)",
                                                     "-DABISMAL_SHORT")
                       for s in srcs]


def test_port_static_analysis_fails_on_a_finding(tmp_path):
    """The gate, copied beside a native source with a shadowed name (the
    layout it expects), exits non-zero."""
    tools = tmp_path / "abismal_tpu_torch" / "tools"
    native = tmp_path / "abismal_tpu_torch" / "native"
    tools.mkdir(parents=True)
    native.mkdir()
    shutil.copy(GATE, tools)
    (native / "bad.cpp").write_text(
        "int f(int x) {\n  int y = x;\n  { int y = 2; x += y; }\n"
        "  return x + y;\n}\n")
    r = subprocess.run(["bash", str(tools / "static_analysis.sh")],
                       capture_output=True, text=True)
    assert r.returncode != 0
    assert "-Werror=shadow" in r.stderr
