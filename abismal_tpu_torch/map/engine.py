"""The `map` command's loop (↔ run_map and _write_stats of
abismal_tpu/map/engine.py; reference abismal.cpp:2295-2504), for engines
built on the native C++ library: the pure-native engine and
TorchNativeEngine.  Both thread internally and implement the
dispatch/finish interface of run_map_pipelined.  The JAX package's
pure-Python reference engine (MappingEngine) is not carried over."""

from __future__ import annotations

from ..constants import (
    PE_MAX_DIST_DEFAULT, PE_MIN_DIST_DEFAULT, VALID_FRAC_DEFAULT,
)
from .native_engine import run_map_pipelined
from .stats import stats_to_json


def _write_stats(stats, stats_path, stats_json, paired, allow_ambig):
    if not stats_path:
        return
    with open(stats_path, "w") as f:
        if stats_json:
            f.write(stats_to_json(stats))
        elif paired:
            f.write(stats.tostring(allow_ambig))
        else:
            f.write(stats.tostring("read1"))


def run_map(index, reads_file1: str, reads_file2: str | None, out_path: str,
            stats_path: str | None, command_line: str, a_rich: bool = False,
            pbat: bool = False, random_pbat: bool = False,
            allow_ambig: bool = False, stats_json: bool = False,
            valid_frac: float = VALID_FRAC_DEFAULT,
            pe_min_dist: int = PE_MIN_DIST_DEFAULT,
            pe_max_dist: int = PE_MAX_DIST_DEFAULT,
            engine_factory=None, threads: int = 1,
            bam: bool = False, verbose: bool = False):
    """End-to-end `map` command.  engine_factory(index, allow_ambig,
    valid_frac, pe_min_dist, pe_max_dist) must build a native-library
    engine (factory.is_native): make_native_engine_factory or
    make_torch_native_engine_factory."""
    if not getattr(engine_factory, "is_native", False):
        raise ValueError("run_map needs a native engine factory "
                         "(make_native_engine_factory or "
                         "make_torch_native_engine_factory)")
    engine = engine_factory(index, allow_ambig, valid_frac, pe_min_dist,
                            pe_max_dist)
    engine.n_threads = max(1, threads)
    stats = run_map_pipelined(
        engine, index, reads_file1, reads_file2, out_path, command_line,
        a_rich=a_rich, pbat=pbat, random_pbat=random_pbat, bam=bam,
        verbose=verbose)
    _write_stats(stats, stats_path, stats_json, reads_file2 is not None,
                 allow_ambig)
    return stats
