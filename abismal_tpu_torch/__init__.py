"""abismal-tpu-torch: the PyTorch + CUDA port of abismal_tpu's device
pipeline (single-end and paired-end mapping on NVIDIA H100 cards, over a
mesh of devices, beside the host cores or in read-range shards).  The host
side -- I/O, the index, the native C++ engine, run_map, the hybrid split
-- is abismal_tpu's, reused by import; this package replaces only the
device programs and kernels."""
