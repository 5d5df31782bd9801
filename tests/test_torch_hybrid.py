"""The hybrid split with the port's engine (↔ tests/test_hybrid_split.py):
the native engine maps reads [0, k) on the host cores while
TorchNativeEngine on the CPU (plain kernel versions) maps [k, n), and
the gathered SAM and merged mstats equal the goldens byte for byte."""

import gzip
import os

import pytest
import torch

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, PORT_IDX, golden_file, port_index, release_engines,
)

# test workers share the CPU: one torch thread each, not one per core
torch.set_num_threads(1)

SE_CL = ("map -s tests/small.mstats -o tests/small.sam -i tests/tRex1.idx "
         "tests/small_1.fq")
PE_CL = ("map -s tests/small_pe.mstats -o tests/small_pe.sam "
         "-i tests/tRex1.idx tests/small_pe_1.fq tests/small_pe_2.fq")


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


def _engine(index):
    """The memoized port engine, always with two threads: the native
    engine's stats sum every worker it ever started."""
    from abismal_tpu_torch.map.pipeline import (
        make_torch_native_engine_factory,
    )

    return make_torch_native_engine_factory(
        "cpu", unit_batch=128, n_threads=2)(index, False, 0.1, 32, 3000)


def _split(tmp_path, index, share, paired=False, **kw):
    """(SAM text, mstats text, stats_out) of one hybrid run."""
    from abismal_tpu_torch.host import run_map_hybrid_split, write_stats

    prefix = "small_pe" if paired else "small"
    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    sam, mst = tmp_path / f"hs{share}.sam", tmp_path / f"hs{share}.mstats"
    eng = _engine(index)
    u0 = eng.n_units
    info = {}
    stats = run_map_hybrid_split(
        index, fq1, fq2, str(sam), PE_CL if paired else SE_CL,
        device_share=share, threads=2, lmax=128, tpu_engine=eng,
        stats_out=info, **kw)
    write_stats(stats, str(mst), False, paired, False)
    assert info["n_device"] > 0 and info["n_native"] > 0
    assert eng.n_units > u0  # the port engine mapped its share
    return sam.read_text(), mst.read_text()


@pytest.mark.parametrize("share", [0.37, 0.2])
def test_hybrid_split_se_parity(tmp_path, port_index, share):
    """SE: SAM and merged mstats equal the golden at two shares."""
    sam, mst = _split(tmp_path, port_index, share)
    assert sam == _golden("small.sam")
    assert mst == _golden("small.mstats")


def test_hybrid_split_server_parity(tmp_path, port_index):
    """The host shard in its own process (NativeShardServer, as the CLI
    runs it with -i): byte-identical across repeated requests."""
    from abismal_tpu_torch.host import NativeShardServer

    srv = NativeShardServer(PORT_IDX, threads=2)
    try:
        for share in (0.25, 0.5):
            sam, mst = _split(tmp_path, port_index, share,
                              native_server=srv)
            assert sam == _golden("small.sam")
            assert mst == _golden("small.mstats")
    finally:
        srv.close()


def test_hybrid_split_pe_parity(tmp_path, port_index):
    sam, mst = _split(tmp_path, port_index, 0.31, paired=True)
    assert sam == _golden("small_pe.sam")
    assert mst == _golden("small_pe.mstats")
