"""Multi-host sharding with the port's engine (↔ tests/test_multihost.py):
read-range shards mapped by TorchNativeEngine on the CPU (plain kernel
versions) in separate processes gather to the goldens byte for byte, and
the command line's scale-out options refuse what they cannot run."""

import gzip
import os
import subprocess
import sys

import pytest

from tests.test_torch_fixtures import (  # noqa: F401
    GOLDEN, PORT_IDX, golden_file, port_index, release_engines,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDX = PORT_IDX


def _golden(name):
    with gzip.open(os.path.join(GOLDEN, name + ".gz"), "rt") as f:
        return f.read()


@pytest.fixture
def one_thread(monkeypatch):
    """Spawned shard processes inherit the environment: one torch thread
    each, as test workers share the CPU."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("prefix,paired", [("small", False),
                                           ("small_pe", True)])
def test_multihost_port_engine_byte_identical(tmp_path, port_index,
                                              one_thread, prefix, paired):
    """Two shard processes, each loading the index and mapping its range
    with the port engine: the gathered SAM and the merged mstats equal
    the goldens."""
    from abismal_tpu_torch.host import write_stats
    from abismal_tpu_torch.parallel.multihost import run_map_multihost

    assert os.path.exists(IDX)  # written by the port_index fixture
    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    out, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    stats = run_map_multihost(IDX, fq1, fq2, str(out), cl, n_hosts=2,
                              threads_per_host=2, device="cpu")
    write_stats(stats, str(mst), False, paired, False)
    assert out.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")


def test_shard_cli_gather(tmp_path, port_index):
    """`python -m abismal_tpu_torch map --shard I:2` per host, the two
    shards concatenated in rank order: the golden, but for the @PG line,
    which records each shard's own argv."""
    fq1 = golden_file("small_1.fq")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    parts = [tmp_path / f"shard{i}.sam" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "abismal_tpu_torch", "map", "--shard",
         f"{i}:2", "--device", "cpu", "-t", "2", "-o", str(p), "-i", IDX,
         fq1], env=env, cwd=str(tmp_path), stderr=subprocess.PIPE)
        for i, p in enumerate(parts)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()
    gathered = b"".join(p.read_bytes() for p in parts).decode()

    def strip(s):
        return [ln for ln in s.splitlines() if not ln.startswith("@PG")]

    assert strip(gathered) == strip(_golden("small.sam"))
    pg = [ln for ln in gathered.splitlines() if ln.startswith("@PG")]
    assert len(pg) == 1 and "--shard 0:2" in pg[0]  # shard 0's header


@pytest.mark.parametrize("call", ["map_shard", "run_map_multihost"])
def test_shard_without_card_raises(tmp_path, call):
    """Shards on CUDA (the default device) without a card raise; they
    never map on the CPU instead."""
    import torch

    from abismal_tpu_torch.parallel import multihost

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fq1 = golden_file("small_1.fq")
    out = str(tmp_path / "o.sam")
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "map_shard":
            multihost.map_shard(IDX, fq1, None, out, 0, 2, "cl", 0, 250)
        else:
            multihost.run_map_multihost(IDX, fq1, None, out, "cl", 2)


@pytest.mark.parametrize("argv,code,msg", [
    (["--hosts", "2", "-g", "g.fa"], 0, "require a prebuilt index"),
    (["--shard", "0:2", "-g", "g.fa"], 0, "require a prebuilt index"),
    (["--hosts", "2", "--engine", "hybrid", "-i", "x.idx"], 1,
     "not with --engine hybrid or --mesh"),
    (["--shard", "0:2", "--mesh", "2", "-i", "x.idx"], 1,
     "not with --engine hybrid or --mesh"),
    (["--mesh", "2", "--engine", "hybrid", "-i", "x.idx"], 1,
     "--mesh cannot be combined with --engine hybrid"),
    (["--shard", "2:2", "-i", "x.idx"], 1, "--shard must be I:N"),
    (["--shard", "two", "-i", "x.idx"], 1, "--shard must be I:N"),
    (["--mesh", "all", "--device", "cpu", "-i", "x.idx"], 1,
     "--mesh all needs CUDA devices"),
    (["--mesh", "2", "--device-align", "-i", "x.idx"], 1,
     "--device-align cannot be combined with --mesh"),
    (["--index-shards", "2", "--mesh", "2", "-i", "x.idx"], 1,
     "--index-shards cannot be combined with --mesh"),
    (["--index-shards", "2", "--device-align", "-i", "x.idx"], 1,
     "--device-align cannot be combined with --index-shards"),
    (["--index-shards", "all", "--device", "cpu", "-i", "x.idx"], 1,
     "--index-shards all needs CUDA devices"),
    (["--index-shards", "2", "--engine", "exact", "-i", "x.idx"], 1,
     "--index-shards cannot be combined with --engine exact"),
    (["--shard", "0:2", "--index-shards", "2", "-i", "x.idx"], 1,
     "nor with another --engine or --index-shards"),
], ids=["hosts-no-index", "shard-no-index", "hosts-hybrid", "shard-mesh",
        "mesh-hybrid", "shard-range", "shard-format", "mesh-all-cpu",
        "mesh-device-align", "shards-mesh", "shards-device-align",
        "shards-all-cpu", "shards-exact", "shard-index-shards"])
def test_cli_scaleout_refusals(capsys, argv, code, msg):
    """The JAX CLI's checks on the scale-out options, made before any
    index is read."""
    from abismal_tpu_torch.cli import main

    assert main(["map", "-o", "o.sam", *argv, "r.fq"]) == code
    assert msg in capsys.readouterr().err
