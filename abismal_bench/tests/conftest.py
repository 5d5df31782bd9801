"""Fixtures of the benchmark's CPU tests: the tiny benchmark (_tiny.py)
and its genome, made once a session."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root of the tiny benchmark, its build directory)."""
    from abismal_bench.tests import _tiny

    d = str(tmp_path_factory.mktemp("tiny"))
    return _tiny.make(d), os.path.join(d, "build")


@pytest.fixture
def run_tiny(tiny):
    """run(cell, seed, trace=False, hook=None): a run of a tiny cell on the
    CPU, past the harness's look for a card."""
    from abismal_bench import run as R

    root, build = tiny

    def go(cell, seed, trace=False, hook=None, seconds=0.5, min_maps=1):
        return R.run(cell, seed, seconds, trace, device="cpu",
                     require_card=False, hook=hook, root=root,
                     bench_dir=root, build=build, min_maps=min_maps)
    return go
