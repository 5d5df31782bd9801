"""Multi-host sharding with the port's engines (↔ tests/test_multihost.py):
read-range shards mapped by TorchNativeEngine on the CPU (plain kernel
versions) or by the native engine in separate processes gather to the
goldens byte for byte, a native shard's raw counters equal the JAX
package's native shard's, and the command line's scale-out options
refuse what they cannot run."""

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


@pytest.mark.parametrize("prefix,paired,hosts", [("small", False, 3),
                                                 ("small_pe", True, 2)])
def test_multihost_native_byte_identical(tmp_path, port_index, prefix,
                                         paired, hosts):
    """engine="native" (JAX's default shard engine): each shard process
    maps its range with the native engine's streaming loop; the gathered
    SAM and the merged mstats equal the goldens."""
    from abismal_tpu_torch.host import write_stats
    from abismal_tpu_torch.parallel.multihost import run_map_multihost

    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    tail = (f"tests/{prefix}_1.fq tests/{prefix}_2.fq" if paired
            else f"tests/{prefix}_1.fq")
    cl = (f"map -s tests/{prefix}.mstats -o tests/{prefix}.sam "
          f"-i tests/tRex1.idx {tail}")
    out, mst = tmp_path / "out.sam", tmp_path / "out.mstats"
    stats = run_map_multihost(IDX, fq1, fq2, str(out), cl, n_hosts=hosts,
                              threads_per_host=2, engine="native")
    write_stats(stats, str(mst), False, paired, False)
    assert out.read_text() == _golden(prefix + ".sam")
    assert mst.read_text() == _golden(prefix + ".mstats")


def test_multihost_native_bam_payload(tmp_path, port_index):
    """Native -B shards, each a BGZF stream, concatenated: the same
    decompressed payload and records as a one-process native -B run."""
    from abismal_tpu_torch.host import make_native_engine_factory, run_map
    from abismal_tpu_torch.io.bam import read_bam_records
    from abismal_tpu_torch.parallel.multihost import run_map_multihost

    fq1 = golden_file("small_1.fq")
    cl = "map -B -o tests/small.bam -i tests/tRex1.idx tests/small_1.fq"
    one, multi = tmp_path / "one.bam", tmp_path / "multi.bam"
    run_map(port_index, fq1, None, str(one), None, cl,
            engine_factory=make_native_engine_factory(n_threads=2),
            threads=2, bam=True)
    run_map_multihost(IDX, fq1, None, str(multi), cl, n_hosts=3,
                      threads_per_host=2, bam=True, engine="native")
    assert (gzip.decompress(multi.read_bytes())
            == gzip.decompress(one.read_bytes()))
    assert (list(read_bam_records(str(multi)))
            == list(read_bam_records(str(one))))


@pytest.mark.parametrize("prefix,paired,bam", [("small", False, False),
                                               ("small_pe", True, False),
                                               ("small", False, True)])
def test_native_shard_counters_equal_jax(tmp_path, port_index, prefix,
                                         paired, bam):
    """Every shard of three: the port's map_shard(engine="native") writes
    the same bytes and returns the same raw counters as the JAX package's
    map_shard(engine="native") on the same index file (its native engine
    alone, no device program)."""
    from abismal_tpu.parallel import multihost as jax_mh
    from abismal_tpu_torch.parallel import multihost

    fq1 = golden_file(prefix + "_1.fq")
    fq2 = golden_file(prefix + "_2.fq") if paired else None
    cl = f"map -i tests/tRex1.idx tests/{prefix}_1.fq"
    for i, (skip, cnt) in enumerate(multihost.shard_bounds(
            multihost.count_reads(fq1), 3)):
        got, want = tmp_path / f"port{i}", tmp_path / f"jax{i}"
        raw = multihost.map_shard(IDX, fq1, fq2, str(got), i, 3, cl, skip,
                                  cnt, threads=2, bam=bam, engine="native")
        ref = jax_mh.map_shard(IDX, fq1, fq2, str(want), i, 3, cl, skip,
                               cnt, threads=2, bam=bam, engine="native")
        assert raw == ref and len(raw) == (18 if paired else 6)
        assert raw[0] == cnt  # total reads (pairs) of the shard
        assert got.read_bytes() == want.read_bytes()


def test_hosts_cli_native_gives_the_golden(tmp_path, port_index):
    """`map --hosts 3 --engine native -t 2`: the golden SAM but for the
    @PG line, which records this argv, and the golden mstats."""
    fq1 = golden_file("small_1.fq")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    subprocess.run(
        [sys.executable, "-m", "abismal_tpu_torch", "map", "--hosts", "3",
         "--engine", "native", "-t", "2", "-s", "out.mstats", "-o",
         "out.sam", "-i", IDX, fq1], env=env, cwd=str(tmp_path), check=True,
        capture_output=True, timeout=300)
    got = (tmp_path / "out.sam").read_text()

    def strip(s):
        return [ln for ln in s.splitlines() if not ln.startswith("@PG")]

    assert strip(got) == strip(_golden("small.sam"))
    pg = [ln for ln in got.splitlines() if ln.startswith("@PG")]
    assert len(pg) == 1 and "--hosts 3 --engine native" in pg[0]
    assert (tmp_path / "out.mstats").read_text() == _golden("small.mstats")


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


def test_shard_cli_native_gather(tmp_path, port_index):
    """`map --shard I:3 --engine native` in three processes, the shards
    concatenated in rank order: the golden but for the @PG line."""
    fq1 = golden_file("small_1.fq")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    parts = [tmp_path / f"shard{i}.sam" for i in range(3)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "abismal_tpu_torch", "map", "--shard",
         f"{i}:3", "--engine", "native", "-t", "2", "-o", str(p), "-i", IDX,
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
    assert len(pg) == 1 and "--shard 0:3 --engine native" in pg[0]


def test_native_shards_need_no_card(tmp_path, monkeypatch):
    """A native shard maps on the host cores: it neither asks for a card
    nor imports torch."""
    from abismal_tpu_torch import device
    from abismal_tpu_torch.parallel import multihost

    def no_card():
        raise AssertionError("a native shard asked for a card")

    monkeypatch.setattr(device, "require_cuda", no_card)
    fq1 = golden_file("small_1.fq")
    out = tmp_path / "o.sam"
    raw = multihost.map_shard(IDX, fq1, None, str(out), 1, 2, "cl", 250,
                              250, engine="native")
    assert raw[0] == 250 and not out.read_text().startswith("@")
    code = ("import sys\n"
            "from abismal_tpu_torch.parallel import multihost\n"
            f"multihost.map_shard({IDX!r}, {fq1!r}, None, "
            f"{str(tmp_path / 'p.sam')!r}, 0, 2, 'cl', 0, 250, "
            "engine='native')\n"
            "assert 'torch' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env=dict(os.environ, PYTHONPATH=ROOT))


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
    (["--hosts", "2", "--engine", "exact", "-i", "x.idx"], 1,
     "nor with another --engine or --index-shards"),
    (["--hosts", "2", "--engine", "native", "--mesh", "2", "-i", "x.idx"],
     1, "--mesh cannot be combined with --engine native"),
    (["--hosts", "2", "--engine", "native", "--index-shards", "2", "-i",
      "x.idx"], 1, "--index-shards cannot be combined with --engine native"),
    (["--shard", "0:2", "--engine", "native", "--device-align", "-i",
      "x.idx"], 1, "--device-align cannot be combined with --engine native"),
], ids=["hosts-no-index", "shard-no-index", "hosts-hybrid", "shard-mesh",
        "mesh-hybrid", "shard-range", "shard-format", "mesh-all-cpu",
        "mesh-device-align", "shards-mesh", "shards-device-align",
        "shards-all-cpu", "shards-exact", "shard-index-shards",
        "hosts-exact", "native-hosts-mesh", "native-hosts-index-shards",
        "native-shard-device-align"])
def test_cli_scaleout_refusals(capsys, argv, code, msg):
    """The JAX CLI's checks on the scale-out options, made before any
    index is read."""
    from abismal_tpu_torch.cli import main

    assert main(["map", "-o", "o.sam", *argv, "r.fq"]) == code
    assert msg in capsys.readouterr().err
