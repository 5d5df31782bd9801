"""The host side of the port in one place: index build and
serialization, the read simulator, the mapping loop run_map, the
statistics writer, the native C++ engine factory (also the exact host
reference the port's SAM is held against) and the hybrid split.  A thin
re-export of the port's own modules."""

from .index.build import create_index
from .index.serialize import read_index, write_index
from .map.engine import _write_stats as write_stats
from .map.engine import run_map
from .map.host_units import make_native_engine_factory
from .map.hybrid_split import NativeShardServer, run_map_hybrid_split
from .sim.simreads import SimConfig, simulate_reads

__all__ = [
    "NativeShardServer", "SimConfig", "create_index",
    "make_native_engine_factory", "read_index", "run_map",
    "run_map_hybrid_split", "simulate_reads", "write_index", "write_stats",
]
