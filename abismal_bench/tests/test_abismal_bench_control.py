"""The check fails where it must: the control (the reference in the
mapper's place, matching plain DNA) on every tiny cell, and a run whose
timed path is broken underneath (a stale chunk's rows handed on again;
half of every batch left out; every record's position altered where the
engine writes it).  The cells run on one card, so no exchange between
cards can be left out."""

from __future__ import annotations

import pytest

from abismal_bench.control import control_readings


@pytest.mark.parametrize("cell", ["se_tiny.len100", "pe_tiny.len100",
                                  "pe_tiny.len150"])
def test_control_is_not_correct(tiny, cell):
    root, build = tiny
    for seed in (1, 2**31 + 3):
        res = control_readings(cell, seed, root=root, bench_dir=root,
                               build=build)
        assert not res["correct"]
        assert res["record_faults"] > 0 and res["missed_share"] > 0.5


def _stale(system):
    eng = system.engine
    first = {}
    for name in ("finish_se", "finish_pe"):
        inner = getattr(eng, name)

        def stale(handle, stats, out, inner=inner):
            first.setdefault("h", handle)
            return inner(first["h"], stats, out)
        setattr(eng, name, stale)


def _half(system):
    eng = system.engine
    se, pe = eng.dispatch_se, eng.dispatch_pe
    eng.dispatch_se = lambda reads, *a: se(reads[: len(reads) // 2], *a)
    eng.dispatch_pe = lambda r1, r2, *a: pe(r1[: len(r1) // 2],
                                            r2[: len(r2) // 2], *a)


class _Shifted:
    """A SAM sink that moves every record one base to the right."""

    def __init__(self, out):
        self.out = out

    def write(self, data):
        lines = []
        for line in data.split("\n"):
            f = line.split("\t")
            if len(f) > 3 and not line.startswith("@"):
                f[3] = str(int(f[3]) + 1)
            lines.append("\t".join(f))
        return self.out.write("\n".join(lines))


def _altered(system):
    eng = system.engine
    for name in ("finish_se", "finish_pe"):
        inner = getattr(eng, name)
        setattr(eng, name, lambda h, stats, out, inner=inner:
                inner(h, stats, _Shifted(out)))


@pytest.mark.parametrize("fault", [_stale, _half, _altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("cell", ["se_tiny.len100", "pe_tiny.len100"])
def test_broken_timed_path_is_not_correct(run_tiny, cell, fault):
    # a window long enough to map both pool files: a stale chunk of the
    # warm-up's file shows in the other's map
    out = run_tiny(cell, 31, hook=fault, min_maps=2)
    assert not out["correct"], out["stderr"]
