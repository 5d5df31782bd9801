"""abismal-tpu-torch: the PyTorch + CUDA port of abismal_tpu's device
pipeline (single-end mapping on one NVIDIA H100).  The host side -- I/O,
the index, the native C++ engine, run_map -- is abismal_tpu's, reused by
import; this package replaces only the device programs and kernels."""
