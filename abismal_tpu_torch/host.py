"""The host side the port runs on, reused unchanged from abismal_tpu: index
build and serialization, the read simulator, the mapping loop run_map and
the native C++ engine, which is also the exact host reference the port's
SAM is held against.  None of it loads JAX.  The port's command line and
chip_smoke.py reach the host side through this module."""

from abismal_tpu.index.build import create_index
from abismal_tpu.index.serialize import read_index, write_index
from abismal_tpu.map.engine import run_map
from abismal_tpu.map.pipeline import make_native_engine_factory
from abismal_tpu.sim.simreads import SimConfig, simulate_reads

__all__ = [
    "SimConfig", "create_index", "make_native_engine_factory", "read_index",
    "run_map", "simulate_reads", "write_index",
]
