"""The host side the port runs on, reused unchanged from abismal_tpu: index
build and serialization, the read simulator, the mapping loop run_map,
the statistics writer, the native C++ engine, which is also the exact
host reference the port's SAM is held against, and the hybrid split,
which maps a read range on the host cores while the port's engine
(tpu_engine=) maps the rest.  None of it loads JAX.  The port's command
line and chip_smoke.py reach the host side through this module."""

from abismal_tpu.index.build import create_index
from abismal_tpu.index.serialize import read_index, write_index
from abismal_tpu.map.engine import _write_stats as write_stats
from abismal_tpu.map.engine import run_map
from abismal_tpu.map.hybrid_split import NativeShardServer
from abismal_tpu.map.hybrid_split import run_map_hybrid_split
from abismal_tpu.map.pipeline import make_native_engine_factory
from abismal_tpu.sim.simreads import SimConfig, simulate_reads

__all__ = [
    "NativeShardServer", "SimConfig", "create_index",
    "make_native_engine_factory", "read_index", "run_map",
    "run_map_hybrid_split", "simulate_reads", "write_index", "write_stats",
]
